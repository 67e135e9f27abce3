"""plumekit on PyTorch and CUDA."""
