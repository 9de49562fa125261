"""Drivers of the PyTorch port, run as ``python -m
dpgo_tpu_torch.examples.<name>``."""
