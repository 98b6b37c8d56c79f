"""Build and load the port's hand-written CUDA kernels.

No JAX counterpart: Pallas kernels compile inside `jax.jit`. Here every
`csrc/*.cu` file is compiled by `nvcc` for Hopper (`sm_90a`) into one shared
library with a plain C interface, loaded with `ctypes`. Sources include no
PyTorch header, so the build takes seconds. It runs at first use and is
cached in `vis_zephyr_tpu_torch/build/` until a source is newer than the
library.

Every C entry point returns `cudaGetLastError()` right after its launch;
`check` turns a non-zero code into an exception, because a refused launch
never runs and a later synchronize does not report it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
LIB = os.path.join(BUILD, "libvzt_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every pointer and the stream as c_void_p (a Python int would
# otherwise pass as a 32-bit int and cut the pointer).
_SIGNATURES = {
    "vzt_flash_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      ctypes.c_float, _P],
    "vzt_dense_cache_append": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}

_lib = None
_lock = threading.Lock()


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def build(force: bool = False) -> str:
    """Compile `csrc/*.cu` into `build/libvzt_kernels.so` when it is missing
    or older than a source. Returns the library path."""
    srcs = _sources()
    if (not force and os.path.exists(LIB)
            and os.path.getmtime(LIB) >= max(os.path.getmtime(s) for s in srcs)):
        return LIB
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{LIB}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[s for s in srcs if s.endswith(".cu")]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIB)
    return LIB


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.vzt_error_string.argtypes = [ctypes.c_int]
            handle.vzt_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        msg = lib().vzt_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {code} ({msg})")


def stream_ptr(device) -> int:
    """PyTorch's current stream on `device`, as the C entry points take it."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
