"""Model definitions (NCDHW) and weight conversion from the JAX package."""
