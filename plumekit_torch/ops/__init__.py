"""Device ops of the identify sweep: morphology, connected components,
region statistics, geometry, transects (plain PyTorch), host-side fire
clustering, and the hand-written kernels under :mod:`.kernels`."""
