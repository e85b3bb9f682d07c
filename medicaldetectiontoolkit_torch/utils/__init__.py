"""Host utilities of the port (param conversion from the JAX package)."""
