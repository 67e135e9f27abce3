"""Hand-written CUDA kernels of the detectors and their plain versions:
K1/K4 and K2 (:mod:`.ccl_sweep`) and K3 (:mod:`.label_counts`)."""
