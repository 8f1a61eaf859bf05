"""Weight interop with the JAX package."""
