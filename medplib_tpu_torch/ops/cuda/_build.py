"""Build and load the port's CUDA kernels (medplib_tpu_torch/csrc/*.cu).

The sources are compiled with nvcc into one shared library with a plain C
interface and loaded with ctypes, at first use: nothing is built or loaded
when a module is imported, and the CPU paths never call this. The library
lands in `build/medplib_tpu_torch/` at the root of the checkout, under a
name that carries a hash of the sources, so an edited source rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
_BUILD = Path(__file__).resolve().parents[3] / "build" / "medplib_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_log = ""   # nvcc's output of the build this process ran ("" if cached)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc")


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _BUILD / f"libmedplib_kernels_{h.hexdigest()[:16]}.so"


def _declare(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.gmm_int4h_launch.argtypes = [vp] * 6 + [i] * 6 + [vp]
    lib.gmm_int4h_launch.restype = i
    lib.moe_decode_int4h_launch.argtypes = [vp] * 14 + [i] * 6 + [vp]
    lib.moe_decode_int4h_launch.restype = i
    return lib


def load_library():
    """Compile (if the hashed library is missing) and load the kernels."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        cu, _ = _sources()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, cu)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed (rc={proc.returncode}):\n"
                               f"{build_log}")
        os.replace(tmp, path)
    _lib = _declare(ctypes.CDLL(str(path)))
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
