"""Hand-written CUDA kernels of the model layer and their plain versions."""
