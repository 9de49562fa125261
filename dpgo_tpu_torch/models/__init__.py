"""Solvers of the PyTorch port."""
