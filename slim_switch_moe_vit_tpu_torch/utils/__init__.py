"""Utilities: weight transfer from the JAX package."""
from .checkpoint import flatten_tree, from_jax_params, load_npz_tree  # noqa: F401
