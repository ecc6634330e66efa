"""Build and load the CUDA kernels of ``csrc/``.

At first use, every ``csrc/*.cu`` file is compiled by ``nvcc`` for
``sm_90a`` (one ``nvcc`` process per source, all started together) and the
objects are linked into one shared library with a plain C interface, which
is then loaded with ``ctypes``. The library lands in ``_build/<hash>/`` inside the
package, keyed by a hash of the sources and the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is. Nothing is fetched: the
build needs only this package's sources and the CUDA toolkit.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a nonzero code into an exception.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
LIB_NAME = "libssmv_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
PTXAS_LOG = "ptxas.log"  # per-kernel registers / shared memory / spills

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_L = ctypes.c_longlong
# C signatures of the entry points (argtypes, restype int = cudaError_t)
_SIGNATURES = {
    "ssmv_mha_fwd": (_P, _P, _I, _I, _I, _I, _F, _I, _P),
    "ssmv_expert_ffn_fwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _P),
    "ssmv_mha_bwd": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    "ssmv_expert_ffn_bwd": (_P,) * 15 + (_I,) * 7 + (_P,),
    "ssmv_expert_ffn_fwd_gather": (_P,) * 8 + (_I, _I, _I, _I, _I, _P),
    "ssmv_expert_ffn_bwd_gather": (_P,) * 16 + (_I,) * 7 + (_P,),
    "ssmv_expert_ffn_bwd_defer": (_P,) * 11 + (_I,) * 6 + (_P,),
    "ssmv_expert_ffn_fwd_perm": (_P,) * 8 + (_I, _I, _I, _I, _I, _P),
    "ssmv_expert_ffn_bwd_perm": (_P,) * 16 + (_I,) * 7 + (_P,),
    "ssmv_flash_fwd": (_P, _P, _I, _I, _I, _I, _F, _I, _P),
    "ssmv_fused_adamw": (_P, _I) + (_F,) * 9 + (_D, _D, _D, _P),
    "ssmv_mha_proj_groups": (_I, _I, _I, _I, _I),
    "ssmv_mha_proj_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    "ssmv_gather_rows": (_P, _P, _I, _P, _L, _I, _I, _P),
    "ssmv_scatter_add_rows": (_P, _P, _P, _P, _L, _I, _L, _I, _P),
    "ssmv_ln_bwd": (_P,) * 10 + (_L, _I, _I, _F) + (_I,) * 6 + (_P,),
}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): "
                           "the CUDA kernels cannot be built")
    return found


def build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile ``csrc/*.cu`` into the hash-keyed library unless it exists;
    returns its path. The compiler's report (``-Xptxas -v``) is kept beside
    it in ``ptxas.log``."""
    out_dir = os.path.join(BUILD_ROOT, build_key())
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    jobs = []
    for src in (p for p in _sources() if p.endswith(".cu")):
        obj = os.path.join(out_dir, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:  # wait for every compile, then report
        out = proc.communicate()[0]
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}"
                          f"\n{out}")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = f"{lib}.{tag}"
        cmd = [nvcc, "-shared", "-o", tmp, *[obj for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    finally:
        for _, obj, _ in jobs:
            if os.path.exists(obj):
                os.remove(obj)
    with open(os.path.join(out_dir, PTXAS_LOG), "w") as f:
        f.write("".join(log))
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


def bind(lib: ctypes.CDLL, names=tuple(_SIGNATURES)) -> ctypes.CDLL:
    """Set the C signatures of the entry points ``names`` of ``lib``."""
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = list(_SIGNATURES[name])
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once per process)."""
    return bind(ctypes.CDLL(build()))


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch "
                           "(see cudaError_t; 1 = invalid value)")
