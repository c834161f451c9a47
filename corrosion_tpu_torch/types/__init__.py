"""Identity types, wire primitives and the CRDT change types of the
PyTorch port: actors and timestamps, SQLite values, the pk pack format,
range sets, changes and changesets, and the byte codecs."""
