"""Identity types and wire primitives of the PyTorch port (the SWIM wire's
actors, timestamps and byte reader/writer)."""
