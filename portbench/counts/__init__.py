"""The work of the measured functions, counted from their shapes.

FLOPs are 2 per multiply-add throughout. Bytes count each input of a
function read once and each output written once, at its dtype. Routed
rows are the T*k (token, expert) pairs, not the padded layout's rows; a
backward counts the products its gradients need and no recompute.

``FUNCTIONS`` maps the name a metric file gives (``"count"``) to a
function of a ``shape`` dict (see :func:`shape`) returning ``(flops,
bytes)`` for one unit of the cell's traffic: one training step, or one
served batch.
"""
from __future__ import annotations

from .kernels import FUNCTIONS, shape  # noqa: F401
from .model import forward_flops_per_image  # noqa: F401
