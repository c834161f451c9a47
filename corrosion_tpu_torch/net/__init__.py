"""The SWIM wire and the in-memory network of the PyTorch port."""
