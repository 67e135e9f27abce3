"""Device ops of the detectors: morphology, connected components, region
statistics, geometry, transects, in-painting (plain PyTorch), fire
clustering, and the hand-written kernels under :mod:`.kernels`."""
