"""Hand-written CUDA kernels of the identify sweep and their plain
versions: K1/K4 (:mod:`.ccl_sweep`) and K3 (:mod:`.label_counts`)."""
