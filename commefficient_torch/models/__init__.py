"""Models of the PyTorch port; parameters are views into one flat vector."""
