"""Device code of the PyTorch port: the dense SWIM tick and its kernels."""
