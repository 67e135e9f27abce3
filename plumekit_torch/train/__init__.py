"""Training (``plumekit/train``): data, device-resident data, augmentation,
optimizer state, the step, the loop and checkpoints."""
