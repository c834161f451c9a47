"""The public API's payload types (`api/types.py`), which the live-query
engine writes its events with, and the subscription SQL expansion
(`api/pubsub_http.py::expand_sql`). The HTTP servers and the client come
with a later slice of the port."""
