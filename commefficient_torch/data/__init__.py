"""Datasets, samplers and transforms of the PyTorch port (numpy)."""
