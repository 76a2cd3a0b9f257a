"""Ranking metrics (NumPy copy of the JAX package's eval layer)."""
