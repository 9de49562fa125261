"""Calibration scripts of the PyTorch port."""
