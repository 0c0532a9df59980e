"""ops/kernels of the PyTorch port."""
