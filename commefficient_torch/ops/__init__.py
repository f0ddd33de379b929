"""Sketch, hashing and top-k ops of the PyTorch port."""
