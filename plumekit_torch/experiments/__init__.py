"""Micro-probes of the card (``experiments/`` of the JAX package)."""
