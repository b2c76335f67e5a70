"""Spans and the device trace of a traced run (`--trace 1`).

Spans are recorded from the benchmark's own code around the program's
public functions (the wrapped attribute is restored afterwards): each
waits for the card before and after, so a span holds its own work only.
They live in memory. The device trace comes from torch.profiler (CUPTI)
over a few calls; `summarize` reduces it in memory to the device's busy
time, each kernel's time, and the longest idle gaps by what the host was
doing, and writes no trace file.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """name -> list of seconds."""

    def __init__(self, device):
        self.device = device
        self.times: Dict[str, List[float]] = defaultdict(list)

    def wrap(self, fn: Callable, name: str) -> Callable:
        def spanned(*a, **k):
            sync(self.device)
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"portbench.{name}"):
                out = fn(*a, **k)
            sync(self.device)
            self.times[name].append(time.perf_counter() - t0)
            return out
        return spanned

    @contextlib.contextmanager
    def around(self, module, names):
        """Span every module attribute in `names` while inside."""
        saved = {n: getattr(module, n) for n in names}
        try:
            for n, fn in saved.items():
                setattr(module, n, self.wrap(fn, n))
            yield self
        finally:
            for n, fn in saved.items():
                setattr(module, n, fn)


def profile(device):
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _merge(intervals: List[Tuple[float, float]]):
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(prof, top: int = 10) -> Dict:
    """-> {"busy_s": seconds with an operation on the device, "span_s":
    first device start to last device end, "ops": [(name, seconds)] of
    every device operation by name, longest first, "idle_gaps": [(host
    operation, seconds)] of the idle time between device operations,
    attributed to the innermost host operation running at each gap's
    middle, longest first}."""
    from torch.autograd import DeviceType
    dev_iv, by_name = [], defaultdict(float)
    host = []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or \
                    e.name.startswith("portbench."):
                continue
            dev_iv.append((tr.start, tr.end))
            by_name[e.name] += (tr.end - tr.start) / 1e6
        elif tr.end > tr.start:
            host.append((tr.start, tr.end, e.name))
    merged = _merge(dev_iv)
    busy = sum(b - a for a, b in merged) / 1e6
    span = (merged[-1][1] - merged[0][0]) / 1e6 if merged else 0.0
    gaps = defaultdict(float)
    host.sort()
    starts = [h[0] for h in host]
    for (a0, a1), (b0, _) in zip(merged, merged[1:]):
        mid = (a1 + b0) / 2
        j = bisect.bisect_right(starts, mid)
        best = None
        for k in range(j - 1, max(-1, j - 400), -1):
            s, e_, n = host[k]
            if e_ >= mid:
                best = n
                break
        gaps[best or "(no host operation)"] += (b0 - a1) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy, "span_s": span, "ops": ops, "idle_gaps": idle}
