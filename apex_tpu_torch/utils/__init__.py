"""Utilities (``jax_interop``: weights to and from the JAX package)."""
