"""Weight loading from the JAX parameter tree."""
