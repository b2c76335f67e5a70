"""Profiling and tracing helpers (medplib_tpu/utils/profiling.py) on
torch.profiler:

- `trace(logdir)`: a host + CUDA trace of the block (host only with
  device="cpu"), written as a Chrome trace (trace.json) under `logdir`;
- `annotate(name)`: a named range (record_function) in that trace;
- `device_sync(tree)`: waits for the card and fetches a checksum of the
  first tensor, so the wait cannot be skipped;
- `timed(fn)`: host-clock seconds per call, each call synchronized;
- `kernel_summary(prof)`: the device kernels' summed time and the ones
  that take the most of it;
- `llama_flops_per_token` / `mfu`: the analytic forward FLOPs per token
  and the model FLOPs utilization against a peak rate.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, List, Optional, Tuple

import torch

# NVIDIA H100 SXM, dense bf16 tensor-core peak without sparsity (NVIDIA's
# data sheet, at the 700 W power limit)
H100_BF16_PEAK = 989e12


@contextlib.contextmanager
def trace(logdir: Optional[str], device="cuda"):
    """Profile the block (host, and the card unless `device` is the CPU)
    and, unless `logdir` is None, write `logdir`/trace.json; yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


def _first_tensor(tree: Any):
    """The first tensor in the JAX package's leaf order (dict keys
    sorted)."""
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        for v in tree:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def device_sync(tree: Any) -> float:
    """Wait for the work that made `tree` and fetch the sum of its first
    tensor (0.0 without one)."""
    t = _first_tensor(tree)
    if t is None:
        return 0.0
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return float(t.detach().float().sum())


def timed(fn: Callable, *args, iters: int = 5, warmup: int = 1, **kwargs):
    """-> (seconds per call, last result), each call waited for."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
        device_sync(out)
    t0 = time.time()
    for _ in range(iters):
        out = fn(*args, **kwargs)
        device_sync(out)
    return (time.time() - t0) / iters, out


def kernel_summary(prof) -> Tuple[float, float, List[Tuple[float, int, str]]]:
    """-> (seconds of device kernels, seconds of 'Command Buffer Full'
    stalls, [(microseconds, calls, name)] of the kernels, longest
    first). `annotate` ranges also appear on the device's timeline,
    spanning the kernels they enclose; they are not counted."""
    from torch.autograd import DeviceType
    rows, stalls = [], 0.0
    for e in prof.key_averages():
        us = e.self_device_time_total
        if e.device_type != DeviceType.CUDA or us <= 0 \
                or e.is_user_annotation:
            continue
        if e.key == "Command Buffer Full":
            stalls += us / 1e6
        else:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    return sum(r[0] for r in rows) / 1e6, stalls, rows


def llama_flops_per_token(hidden: int, layers: int, intermediate: int,
                          vocab: int, seq: int) -> float:
    """Analytic forward FLOPs per token (2 x the matmul parameters plus
    attention's scores and values)."""
    attn = 4 * hidden * hidden + 2 * 2 * seq * hidden
    mlp = 3 * hidden * intermediate
    head = hidden * vocab
    return 2.0 * (layers * (attn + mlp) + head)


def mfu(tokens_per_sec: float, flops_per_token: float,
        peak_flops: float = H100_BF16_PEAK) -> float:
    """Model FLOPs utilization against `peak_flops`; the default is one
    NVIDIA H100 SXM's dense bf16 peak, 989 TFLOP/s."""
    return tokens_per_sec * flops_per_token / peak_flops
