"""The public HTTP API (port's copy of `corrosion_tpu/api/`): the
aiohttp application and its routes (`http.py`), the dual-protocol front
that serves HTTP/2 natively and passes HTTP/1.1 through (`h2front.py`),
the subscription and updates stream handlers (`pubsub_http.py`) and the
payload types (`types.py`)."""

from corrosion_tpu_torch.api.http import ApiServer
