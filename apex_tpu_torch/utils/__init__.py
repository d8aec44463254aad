"""Utilities: ``jax_interop`` (weights and LAMB state to and from the JAX
package) and ``ema`` (parameter averaging)."""
