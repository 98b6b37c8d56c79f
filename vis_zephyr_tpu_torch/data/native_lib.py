"""Build and load the host C++ libraries of `native/` for the port.

The sources stay where the JAX package keeps them (`native/vzt_image.cpp`,
`native/vzt_tokenizer.cpp`) and are read in place; the JAX wrappers write
their `.so` files into `native/`, so the port builds its own with `g++` into
the git-ignored `vis_zephyr_tpu_torch/build/` and never writes into
`native/`. A library is rebuilt when it is missing or older than its source,
at first use and once per process; the compile goes to a temporary name that
is renamed into place, so processes that build at once do not see each
other's half-written files. Where the compile fails (no `g++`, or no libjpeg
headers for the image library) or the library does not load, the loader
returns None and `build_error` keeps the compiler's or the loader's message.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.normpath(os.path.join(_PKG, "..", "native"))
BUILD = os.path.join(_PKG, "build")

_lock = threading.Lock()
_tried: Dict[str, bool] = {}
build_error: Dict[str, str] = {}


def library_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.so")


def _stale(src: str, lib: str) -> bool:
    if not os.path.exists(lib):
        return True
    return os.path.exists(src) and os.path.getmtime(src) > os.path.getmtime(lib)


def _compile(src: str, lib: str, flags: List[str], libs: List[str]) -> Optional[str]:
    """g++ `src` into `lib`; the compiler's message on failure, else None."""
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *flags, "-fPIC", "-shared", "-std=c++17", "-o", tmp, src, *libs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        return f"{' '.join(cmd)}: {e}"
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        return f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stdout}{proc.stderr}"
    os.replace(tmp, lib)
    return None


def load(name: str, source: str, flags: List[str], libs: List[str] = ()) -> Optional[ctypes.CDLL]:
    """The library `lib{name}.so` built from `native/{source}`, or None where
    it cannot be built (the reason in `build_error[name]`)."""
    src = os.path.join(NATIVE_DIR, source)
    lib = library_path(name)
    with _lock:
        if _stale(src, lib) and not _tried.get(name):
            _tried[name] = True
            if not os.path.exists(src):
                build_error[name] = f"{src} is missing"
            else:
                err = _compile(src, lib, list(flags), list(libs))
                if err is not None:
                    build_error[name] = err
        if not os.path.exists(lib):
            return None
        try:
            return ctypes.CDLL(lib)
        except OSError as e:  # built elsewhere, against a library this machine lacks
            build_error[name] = f"{lib}: {e}"
            return None
