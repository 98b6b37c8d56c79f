"""ctypes binding for the native C++ image pipeline (`native/vzt_image.cpp`).

The port's copy of `vis_zephyr_tpu/data/native.py` (`decode_jpeg`,
`resize_lanczos`, `anyres_preprocess_native`): JPEG decode, Lanczos resample
and anyres tile/normalize without the Python interpreter in the loop, usable
from the prefetch threads since every call releases the GIL inside ctypes.
The source is read in place and built with `-ljpeg` by `data/native_lib.py`
into `vis_zephyr_tpu_torch/build/` (never into `native/`), at first use.

`available()` gates use: where the library cannot be built (no libjpeg
headers, no `g++`) the dataset takes the PIL route,
`image_pipeline.anyres_preprocess_host`, which the two are parity-tested
against; `native_lib.build_error["vzt_image"]` holds the compiler's message.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from . import native_lib

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = native_lib.load("vzt_image", "vzt_image.cpp", ["-O3", "-march=native"], ["-ljpeg"])
    if lib is None:
        return None
    lib.vzt_decode_jpeg.restype = ctypes.c_int
    lib.vzt_decode_jpeg.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.vzt_resize_lanczos.restype = None
    lib.vzt_resize_lanczos.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.vzt_anyres.restype = ctypes.c_int
    lib.vzt_anyres.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes → RGB uint8 [H, W, 3]."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.vzt_decode_jpeg(data, len(data), None, 0,
                             ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"jpeg probe failed (rc={rc})")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.vzt_decode_jpeg(
        data, len(data), out.ctypes.data_as(ctypes.c_void_p), out.nbytes,
        ctypes.byref(w), ctypes.byref(h),
    )
    if rc != 0:
        raise ValueError(f"jpeg decode failed (rc={rc})")
    return out


def resize_lanczos(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """RGB uint8 [H, W, 3] → [h, w, 3] (size is (w, h), PIL convention)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    image = np.ascontiguousarray(image, np.uint8)
    dw, dh = size
    out = np.empty((dh, dw, 3), np.uint8)
    lib.vzt_resize_lanczos(
        image.ctypes.data_as(ctypes.c_void_p), image.shape[1], image.shape[0],
        out.ctypes.data_as(ctypes.c_void_p), dw, dh,
    )
    return out


def anyres_preprocess_native(
    image: np.ndarray,
    grid_pinpoints,
    target_size: int = 336,
    max_patches: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Native anyres pipeline; same contract as
    `image_pipeline.anyres_preprocess_host` (pixels [P, S, S, 3] f32
    normalized, valid [P] bool)."""
    from . import anyres

    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    pins = anyres.parse_grid_pinpoints(grid_pinpoints)
    if max_patches is None:
        max_patches = anyres.max_anyres_patches(pins, target_size)

    image = np.ascontiguousarray(image, np.uint8)
    pin_w = np.asarray([p[0] for p in pins], np.int32)
    pin_h = np.asarray([p[1] for p in pins], np.int32)
    out = np.empty((max_patches, target_size, target_size, 3), np.float32)
    valid = np.empty((max_patches,), np.int32)
    live = lib.vzt_anyres(
        image.ctypes.data_as(ctypes.c_void_p), image.shape[1], image.shape[0],
        pin_w.ctypes.data_as(ctypes.c_void_p), pin_h.ctypes.data_as(ctypes.c_void_p),
        len(pins), target_size, max_patches,
        out.ctypes.data_as(ctypes.c_void_p), valid.ctypes.data_as(ctypes.c_void_p),
    )
    if live < 0:
        raise ValueError("vzt_anyres failed (grid larger than max_patches?)")
    return out, valid.astype(bool)
