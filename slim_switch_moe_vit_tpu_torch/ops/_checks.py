"""Argument checks shared by the kernel wrappers.

A wrapper checks everything its kernel assumes before it passes a pointer:
device, dtype, shape, contiguity and alignment. What the kernel does not
take raises; nothing is converted or copied behind the caller's back.
"""
from __future__ import annotations

import typing as typ

import torch


def check_tensor(t: torch.Tensor, name: str,
                 dtypes: typ.Sequence[torch.dtype], *,
                 device: typ.Optional[torch.device] = None,
                 shape: typ.Optional[typ.Sequence[int]] = None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: on {t.device}, but the kernels launch on "
                         f"cuda:{torch.cuda.current_device()}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {list(dtypes)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")

