"""Federated runtime of the PyTorch port: state, client step, server update."""
