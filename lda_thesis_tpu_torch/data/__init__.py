"""Host-side corpus encoding: NumPy copies of the JAX package's data layer."""
