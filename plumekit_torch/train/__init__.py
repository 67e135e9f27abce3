"""Model-input contract and checkpoints."""
