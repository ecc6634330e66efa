"""Utilities: weight transfer to and from the JAX package's tree, the
entry points' device, metric logging."""
from .checkpoint import (  # noqa: F401
    flatten_tree,
    from_jax_params,
    load_npz_tree,
    to_jax_tree,
)
from .device import resolve_device  # noqa: F401
