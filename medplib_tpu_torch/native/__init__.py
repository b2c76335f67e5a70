"""ctypes bindings of the native C++ preprocessing library
(medplib_tpu/native/__init__.py).

The source is the port's own copy, preprocess.cpp beside this file. It is
built with g++ at first use into build/medplib_tpu_torch/ at the root of
the checkout (gitignored), under a name that carries a hash of the source
and flags, so an edited source rebuilds; nothing is built beside the
source, and nothing at import. data/preprocess.py uses these wrappers for
uint8 RGB images when the library loads (USE_NATIVE), else its numpy
resampler, which computes the same float triangle filter.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "preprocess.cpp"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "medplib_tpu_torch"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + _SRC.read_bytes())
    return _BUILD / f"libmedplib_pp_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    _BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
        out = os.path.join(tmp, "lib.so")
        subprocess.run(["g++", *FLAGS, str(_SRC), "-o", out], check=True,
                       capture_output=True)
        os.replace(out, path)


def load_library() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load; None when no toolchain builds it."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        try:
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.CalledProcessError):
            return None
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = ctypes.POINTER(ctypes.c_int)
        lib.pp_resize_longest.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, i32p, i32p]
        lib.pp_sam_preprocess.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p, f32p, f32p,
            i32p, i32p]
        lib.pp_clip_preprocess.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p, f32p, f32p]
        lib.pp_encode_sparse_mask.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int]
        lib.pp_encode_sparse_mask.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def sam_preprocess(image_rgb: np.ndarray, size: int, mean: np.ndarray,
                   std: np.ndarray) -> Tuple[np.ndarray, Tuple[int, int]]:
    """uint8 [H, W, 3] -> ([size, size, 3] f32 normalized then zero-padded,
    resize_hw)."""
    lib = load_library()
    src = np.ascontiguousarray(image_rgb, np.uint8)
    h, w = src.shape[:2]
    out = np.empty((size, size, 3), np.float32)
    rh, rw = ctypes.c_int(), ctypes.c_int()
    lib.pp_sam_preprocess(src, h, w, size,
                          np.ascontiguousarray(mean, np.float32),
                          np.ascontiguousarray(std, np.float32), out,
                          ctypes.byref(rh), ctypes.byref(rw))
    return out, (rh.value, rw.value)


def clip_preprocess(image_rgb: np.ndarray, size: int, mean: np.ndarray,
                    std: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] -> [size, size, 3] f32, padded with the mean, then
    rescaled and normalized."""
    lib = load_library()
    src = np.ascontiguousarray(image_rgb, np.uint8)
    h, w = src.shape[:2]
    out = np.empty((size, size, 3), np.float32)
    lib.pp_clip_preprocess(src, h, w, size,
                           np.ascontiguousarray(mean, np.float32),
                           np.ascontiguousarray(std, np.float32), out)
    return out


def encode_sparse_mask(mask: np.ndarray) -> np.ndarray:
    """[H, W] -> the (y, x) coordinates of its nonzero pixels, int32."""
    lib = load_library()
    src = np.ascontiguousarray(mask > 0, np.uint8)
    h, w = src.shape
    coords = np.empty((h * w, 2), np.int32)
    n = lib.pp_encode_sparse_mask(src, h, w, coords, h * w)
    return coords[:n]
