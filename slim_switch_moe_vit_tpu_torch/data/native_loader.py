"""ctypes binding of the native (C++) host crop pipeline.

Port of ``slim_switch_moe_vit_tpu/data/native_loader.py`` over the port's
own copy of the C++ source, ``csrc_host/dataloader.cc``. At first use the
source is compiled by the host C++ compiler (``$CXX``, else ``g++``) with
the JAX package's ``native/Makefile`` flags into
``_build/host-<hash>/libssmv_dataloader.so`` inside the package, keyed by a
hash of the source and the flags, and loaded with ``ctypes``.

Unlike the JAX binding, which falls back to PIL when its library is not
built, a failed build raises: the port's crops always take this path.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import typing as typ

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc_host", "dataloader.cc")
BUILD_ROOT = os.path.join(_PKG, "_build")
LIB_NAME = "libssmv_dataloader.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
             "-march=native")
VERSION = 1
# the loader's worker threads reach the first crop together: one builds
_BUILD_LOCK = threading.Lock()

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {  # name: (argtypes, restype)
    "ssmv_crop_resize_u8": ((_P, _I, _I, _I, _I, _I, _I, _P, _I), None),
    "ssmv_batch_crop_resize_u8": ((ctypes.POINTER(_P), _P, _P, _P, _I, _I,
                                   _I), None),
    "ssmv_pad_reflect_crop_u8": ((_P, _I, _I, _I, _I, _I, _P, _I), None),
    "ssmv_version": ((), _I),
}


def build(source: str = SOURCE, build_root: str = BUILD_ROOT) -> str:
    """Compile ``source`` into the hash-keyed library unless it exists;
    returns its path. Raises ``RuntimeError`` when no compiler is found or
    the compile fails. Safe to call from several threads and processes at
    once."""
    with _BUILD_LOCK:
        return _build(source, build_root)


def _build(source: str, build_root: str) -> str:
    with open(source, "rb") as f:
        key = hashlib.sha256(" ".join(CXX_FLAGS).encode() + f.read())
    out_dir = os.path.join(build_root, "host-" + key.hexdigest()[:16])
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib):
        return lib
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError(f"no C++ compiler ({os.environ.get('CXX', 'g++')})"
                           ": the native crop library cannot be built")
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the native crop library failed "
                           f"({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


@functools.cache
def load_native() -> ctypes.CDLL:
    """The loaded library, built first if needed (once per process)."""
    lib = ctypes.CDLL(build())
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    if lib.ssmv_version() != VERSION:
        raise RuntimeError(f"native crop library version "
                           f"{lib.ssmv_version()} != {VERSION}")
    return lib


def _image(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")
    return img


def _check_crop(shape, y0: int, x0: int, ch: int, cw: int) -> None:
    H, W = shape[:2]
    if not (0 <= y0 and 0 <= x0 and 0 < ch and 0 < cw and y0 + ch <= H
            and x0 + cw <= W):
        raise ValueError(f"crop ({y0}, {x0}, {ch}, {cw}) outside an image of "
                         f"{H}x{W}")


def crop_resize(img: np.ndarray, y0: int, x0: int, ch: int, cw: int,
                size: int) -> np.ndarray:
    """Crop (y0, x0, ch, cw) from an (H, W, 3) uint8 image and resize it
    bicubically to (size, size, 3)."""
    img = _image(img)
    _check_crop(img.shape, y0, x0, ch, cw)
    out = np.empty((size, size, 3), np.uint8)
    load_native().ssmv_crop_resize_u8(
        img.ctypes.data, img.shape[0], img.shape[1], int(y0), int(x0),
        int(ch), int(cw), out.ctypes.data, int(size))
    return out


def batch_crop_resize(imgs: typ.Sequence[np.ndarray], crops: np.ndarray,
                      size: int, num_threads: int = 0) -> np.ndarray:
    """The batch form on ``num_threads`` threads (0: the cores, at most 16).
    imgs: (H, W, 3) uint8 images; crops: (n, 4) [y0, x0, ch, cw]. Returns
    (n, size, size, 3) uint8."""
    imgs = [_image(im) for im in imgs]
    crops = np.ascontiguousarray(crops, dtype=np.int32).reshape(-1, 4)
    if len(crops) != len(imgs):
        raise ValueError(f"{len(imgs)} images, {len(crops)} crops")
    for im, c in zip(imgs, crops):
        _check_crop(im.shape, *c)
    n = len(imgs)
    if num_threads <= 0:
        num_threads = min(os.cpu_count() or 4, 16)
    dims = np.asarray([im.shape[:2] for im in imgs], np.int32).reshape(-1, 2)
    ptrs = (_P * n)(*[im.ctypes.data for im in imgs])
    out = np.empty((n, size, size, 3), np.uint8)
    load_native().ssmv_batch_crop_resize_u8(
        ptrs, dims.ctypes.data, crops.ctypes.data, out.ctypes.data, n,
        int(size), int(num_threads))
    return out


def pad_reflect_crop(img: np.ndarray, pad: int, y0: int, x0: int,
                     size: int) -> np.ndarray:
    """The (size, size) window at (y0, x0) of the image reflect-padded by
    ``pad`` on each side (``np.pad(..., mode="reflect")``), without
    building the padded image."""
    img = _image(img)
    H, W = img.shape[:2]
    if not (0 <= pad < min(H, W) and 0 <= y0 and 0 <= x0
            and y0 + size <= H + 2 * pad and x0 + size <= W + 2 * pad):
        raise ValueError(f"window ({y0}, {x0}, {size}) outside an image of "
                         f"{H}x{W} padded by {pad}")
    out = np.empty((size, size, 3), np.uint8)
    load_native().ssmv_pad_reflect_crop_u8(
        img.ctypes.data, H, W, int(pad), int(y0), int(x0), out.ctypes.data,
        int(size))
    return out
