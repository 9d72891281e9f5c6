"""Model and run configurations (copies of the JAX package's)."""
