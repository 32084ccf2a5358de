"""The validation runs of the JAX package, on the port."""
