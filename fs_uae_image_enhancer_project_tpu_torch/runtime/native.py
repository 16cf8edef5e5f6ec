"""ctypes loader for the host C++ dithers (the repo's ``runtime/dither.cc``).

This is a host path and no device kernel: serpentine error diffusion is
serially dependent from pixel to pixel, and the checkerboard dither here is
the host route's. Bindings go through ctypes over a small extern-"C" surface.
The shared library is built on first use with g++ into
``build/torch_kernels/native/`` under the repo root (gitignored). When g++
fails, a warning is given and callers use the numpy versions.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import warnings
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_SRC_DIR = os.path.join(_REPO_ROOT, "runtime")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_kernels", "native")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    src = os.path.join(_SRC_DIR, "dither.cc")
    if not os.path.exists(src):
        return None
    os.makedirs(_BUILD_DIR, exist_ok=True)
    out = os.path.join(_BUILD_DIR, "libdither.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    # compile to a per-pid temp name, then rename: an in-place -o write that
    # gets killed mid-compile (or raced by a second process) leaves a
    # truncated .so with a FRESH mtime, which the short-circuit above would
    # then serve forever; rename is atomic on one filesystem
    tmp = os.path.join(_BUILD_DIR, f".libdither.{os.getpid()}.so")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
    except Exception as e:  # toolchain missing or compile error: fall back
        warnings.warn(f"native kernel build failed ({e}); using numpy fallback")
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            # e.g. a truncated .so from an older non-atomic build: rebuild
            # once from scratch, else fall back to numpy rather than raising
            warnings.warn(f"native kernel load failed ({e}); rebuilding")
            try:
                os.unlink(path)
            except OSError:
                return None
            path = _build()
            if path is None:
                return None
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                warnings.warn("native kernel unusable; using numpy fallback")
                return None
        lib.error_diffusion.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ]
        lib.error_diffusion.restype = None
        lib.checkerboard.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.checkerboard.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def error_diffusion(
    image_float: np.ndarray, diff_map, palette_f: np.ndarray
) -> np.ndarray:
    """Serpentine error diffusion via the native kernel. Returns float64."""
    lib = _load()
    assert lib is not None, "native kernels unavailable"
    pal = np.ascontiguousarray(palette_f, dtype=np.float64)
    if pal.shape[0] == 0:
        raise ValueError("error diffusion requires a non-empty palette")
    img = np.ascontiguousarray(image_float, dtype=np.float64).copy()
    dxs = np.array([d[0] for d in diff_map], dtype=np.int32)
    dys = np.array([d[1] for d in diff_map], dtype=np.int32)
    wgts = np.array([d[2] for d in diff_map], dtype=np.float64)
    h, w, _ = img.shape
    lib.error_diffusion(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), h, w,
        pal.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), pal.shape[0],
        dxs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        dys.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        wgts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(diff_map),
    )
    return img


def checkerboard(image_float: np.ndarray, palette_u8: np.ndarray) -> np.ndarray:
    """Native checkerboard dither. Returns uint8 (h, w, 3)."""
    lib = _load()
    assert lib is not None, "native kernels unavailable"
    img = np.ascontiguousarray(image_float, dtype=np.float64)
    pal_u8 = np.ascontiguousarray(palette_u8, dtype=np.uint8)
    pal_f = pal_u8.astype(np.float64)
    h, w, _ = img.shape
    out = np.empty((h, w, 3), np.uint8)
    lib.checkerboard(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), h, w,
        pal_f.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        pal_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), pal_u8.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out
