"""Optimisers of the port (the JAX package's ``repro.optim``)."""
