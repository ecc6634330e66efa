"""The device an entry point runs on.

Every entry point of the package (export, server, train state) takes its
device explicitly and defaults to ``cuda``. There is no fallback: where CUDA
is unavailable and ``cpu`` was not asked for, it raises.
"""
from __future__ import annotations

import torch


def resolve_device(device: str = "cuda") -> str:
    """The platform name (``cuda`` or ``cpu``) of ``device``; raises when
    CUDA is asked for and unavailable."""
    platform = torch.device(device).type
    if platform not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU")
    return platform
