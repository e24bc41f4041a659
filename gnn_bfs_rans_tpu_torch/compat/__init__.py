"""Weight carry from the JAX package (numpy in, torch out)."""
