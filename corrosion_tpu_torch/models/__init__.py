"""Simulation drivers of the PyTorch port."""
