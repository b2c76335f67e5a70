"""Build and load the port's CUDA kernels (medplib_tpu_torch/csrc/*.cu).

Each source is compiled by its own nvcc process, all started together, and
the objects are linked into one shared library with a plain C interface,
loaded with ctypes, at first use: nothing is built or loaded when a module
is imported, and the CPU paths never call this. The library lands in
`build/medplib_tpu_torch/` at the root of the checkout, under a name that
carries a hash of the sources, so an edited source rebuilds.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    lib.gmm_launch.argtypes = [vp] * 6 + [i] * 9 + [vp]
    lib.gmm_launch.restype = i
    lib.moe_decode_int4h_launch.argtypes = [vp] * 16 + [i] * 9 + [vp]
    lib.moe_decode_int4h_launch.restype = i
    lib.moe_dispatch_quant_launch.argtypes = [vp] * 5 + [i] * 5 + [vp]
    lib.moe_dispatch_quant_launch.restype = i
    lib.moe_swiglu_quant_launch.argtypes = [vp] * 4 + [i] * 2 + [vp]
    lib.moe_swiglu_quant_launch.restype = i
    lib.moe_topk_combine_launch.argtypes = [vp] * 4 + [i] * 5 + [vp]
    lib.moe_topk_combine_launch.restype = i
    f = ctypes.c_float
    lib.flash_fwd_launch.argtypes = [vp] * 6 + [i] * 5 + [f, vp]
    lib.flash_fwd_launch.restype = i
    lib.flash_fwd_dims_launch.argtypes = [vp] * 6 + [i] * 6 + [f, vp]
    lib.flash_fwd_dims_launch.restype = i
    lib.flash_bwd_dq_launch.argtypes = [vp] * 8 + [i] * 5 + [f, vp]
    lib.flash_bwd_dq_launch.restype = i
    lib.flash_bwd_dkv_launch.argtypes = [vp] * 9 + [i] * 5 + [f, vp]
    lib.flash_bwd_dkv_launch.restype = i
    lib.int8_matmul_launch.argtypes = [vp] * 4 + [i] * 5 + [vp]
    lib.int8_matmul_launch.restype = i
    lib.w8a8_matmul_launch.argtypes = [vp] * 5 + [i] * 5 + [vp]
    lib.w8a8_matmul_launch.restype = i
    lib.int4h_matmul_launch.argtypes = [vp] * 4 + [i] * 9 + [vp]
    lib.int4h_matmul_launch.restype = i
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
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
            objs = [os.path.join(tmp, c.stem + ".o") for c in cu]
            cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(c)]
                    for c, o in zip(cu, objs)]
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for c in cmds]
            outs = [p.communicate()[0] for p in procs]
            lib = os.path.join(tmp, "lib.so")
            link = [nvcc, "-shared", "-o", lib, *objs]
            logs = [" ".join(c) + "\n" + o for c, o in zip(cmds, outs)]
            rcs = [p.returncode for p in procs]
            if not any(rcs):
                proc = subprocess.run(link, capture_output=True, text=True)
                logs.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
                rcs.append(proc.returncode)
            build_log = "\n".join(logs)
            if any(rcs):
                raise RuntimeError(f"nvcc failed (rcs={rcs}):\n{build_log}")
            os.replace(lib, path)
    _lib = _declare(ctypes.CDLL(str(path)))
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
