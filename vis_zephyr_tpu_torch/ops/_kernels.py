"""Build and load the port's hand-written CUDA kernels.

No JAX counterpart: Pallas kernels compile inside `jax.jit`. Here every
`csrc/*.cu` file is compiled by `nvcc` for Hopper (`sm_90a`), one process per
source and all at once, and the objects are linked into one shared library
with a plain C interface, loaded with `ctypes`. Sources include no PyTorch
header, so the build takes seconds. It runs at first use and is cached in
`vis_zephyr_tpu_torch/build/` until a source is newer than the library.

Every C entry point returns `cudaGetLastError()` right after its launch, or
the code of whatever failed before it (a shared-memory grant, or a TMA
tensor map that `cuTensorMapEncodeTiled` refused, whose message
`vzt_error_string` spells out); `check` turns a non-zero code into an
exception, because a refused launch never runs and a later synchronize does
not report it.

A wrapper launches its kernel on a CUDA tensor and takes the plain PyTorch
version on a CPU tensor. `plain_versions()` is the one switch that asks for
the plain versions on the card too: a comparison run wraps the plain pass in
it. Nothing on a served path does.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import shutil
import subprocess
import sys
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
LIB = os.path.join(BUILD, "libvzt_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures: every pointer and the stream as c_void_p (a Python int would
# otherwise pass as a 32-bit int and cut the pointer).
_SIGNATURES = {
    "vzt_flash_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      ctypes.c_float, _P],
    "vzt_dense_cache_append": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "vzt_dense_cache_append_rope": [_P] * 7 + [_I] * 8 + [_P],
    "vzt_paged_attn_decode": [_P] * 14 + [_I] * 12 + [ctypes.c_float, _P],
    "vzt_paged_kv_rows": [_P] * 8 + [_I] * 6 + [_P],
    "vzt_paged_kv_update": [_P] * 8 + [_I] * 5 + [_L] * 3 + [_I, _P],
    "vzt_quant_matmul_int8": [_P] * 6 + [_I] * 6 + [_P],
    "vzt_quant_matmul_int4": [_P] * 6 + [_I] * 7 + [_P],
    "vzt_flash_bwd_dkv": [_P] * 10 + [_I] * 6 + [ctypes.c_float, _P],
    "vzt_flash_bwd_dq": [_P] * 9 + [_I] * 6 + [ctypes.c_float, _P],
    "vzt_fused_mlp_matvec": [_P] * 9 + [_I] * 4 + [_P],
    "vzt_paged_attn_batched": [_P] * 9 + [_I] * 8 + [ctypes.c_float, _P],
    "vzt_paged_attn_paired": [_P] * 12 + [_I] * 11 + [ctypes.c_float, _P],
    # K11's first design, timed beside K11 by the probes; no wrapper launches it.
    "vzt_paged_attn_paired_walk": [_P] * 9 + [_I] * 9 + [ctypes.c_float, _P],
}

_lib = None
_lock = threading.Lock()
_plain = False


@contextlib.contextmanager
def plain_versions():
    """Inside the block every wrapper takes its kernel's plain version, on
    CUDA tensors too. Process-wide, so not while another thread serves."""
    global _plain
    before, _plain = _plain, True
    try:
        yield
    finally:
        _plain = before


# The launch counters: module-level ints that a wrapper adds one to where it
# launches its kernel (or takes a counted route), as (module, name). Each
# module files its own here beside their definitions; `serve/graphs.py`
# carries the whole registry across CUDA-graph replays, which run no Python.
COUNTERS: list = []


def register_counters(module_name: str, *names: str) -> None:
    """File the launch counters `names` of module `module_name`."""
    module = sys.modules[module_name]
    for name in names:
        getattr(module, name)  # a misspelt name fails here, at import
        if (module, name) not in COUNTERS:
            COUNTERS.append((module, name))


def counter_values() -> list:
    """Every registered counter's value, in `COUNTERS` order."""
    return [getattr(module, name) for module, name in COUNTERS]


def use_kernel(t) -> bool:
    """Whether a wrapper given tensor `t` launches its kernel."""
    return t.device.type != "cpu" and not _plain


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
    nvcc = _nvcc()
    tag = os.getpid()
    jobs = []
    for src in srcs:
        if src.endswith(".cu"):
            obj = os.path.join(BUILD, f"{os.path.basename(src)}.{tag}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.PIPE, text=True)))
    failed = []
    for cmd, _, proc in jobs:  # wait for every compile, then report
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}{err}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = f"{LIB}.{tag}.tmp"
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, LIB)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return LIB


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is not None:  # every launch asks: no lock once it is loaded
        return _lib
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


@functools.lru_cache(maxsize=None)
def sm_count(index) -> int:
    """The SMs of card `index` (None: the current one), which the kernels'
    launch plans fill."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


_split_counts = {}


def split_counts(device, n: int):
    """The zeroed int32 counts on which a launch's splits meet (K3's per
    unit, K5's and K6's per column tile): one buffer per device, which the
    kernels leave zeroed, so launches that use it must be ordered on one
    stream, as the serving pump's are."""
    import torch

    buf = _split_counts.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(4096, n), dtype=torch.int32, device=device)
        _split_counts[device] = buf
    return buf


def stream_ptr(device) -> int:
    """PyTorch's current stream on `device`, as the C entry points take it
    (the raw handle, without building a `torch.cuda.Stream` per launch)."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
