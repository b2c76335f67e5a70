"""Profiling and tracing on torch.profiler (the JAX package's
utils/profiling.py, with the program's own spans):

- `span(name, **attrs)`: a named range of the program, as a context
  manager or a decorator. It records only inside `recording()`; there it
  opens `record_function("medplib." + name)`, so a profiler active at the
  same time holds the range on the clock of its device kernels, and keeps
  a `SpanRecord` in memory;
- `recording()`: the one switch that turns spans on, for its block;
- `trace(logdir)`: a host + CUDA trace of the block (host only with
  device="cpu"), spans on, written as a Chrome trace (trace.json) under
  `logdir`;
- `kernel_summary(prof)`: the device kernels' summed time and the ones
  that take the most of it;
- `span_summary(prof, rec)`: device time, launches and idle time of a
  profile put down to the program's spans.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import itertools
import os
import threading
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import torch

PREFIX = "medplib."


class SpanRecord:
    """One span instance: host start / end (time.perf_counter_ns), the
    enclosing record on its thread (None at a call's root), the call id
    it shares with its root, and host-known integer attributes."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "call", "attrs")

    def __init__(self, name, start_ns, parent, call, attrs):
        self.name, self.start_ns, self.end_ns = name, start_ns, None
        self.parent, self.call, self.attrs = parent, call, attrs


class Recording:
    """The spans recorded while `recording()` was open, in opening order."""

    def __init__(self):
        self.records: List[SpanRecord] = []


_recording: Optional[Recording] = None
_switch = threading.Lock()        # guards _recording
_calls = itertools.count(1)
_local = threading.local()        # .stack: the open records of a thread


def _stack() -> List[SpanRecord]:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _decorate(name: str, fn):
    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return spanned


class _Off:
    """A span while recording is off: enters and leaves doing nothing."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **attrs) -> None:
        pass

    def __call__(self, fn):
        return _decorate(self.name, fn)


_OFF: Dict[str, _Off] = {}


class _On(_Off):
    """A span inside `recording()`."""

    __slots__ = ("rec", "attrs", "record", "_range")

    def __init__(self, rec: Recording, name: str, attrs: Dict[str, int]):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        call = parent.call if parent is not None else next(_calls)
        self._range = torch.profiler.record_function(PREFIX + self.name)
        self._range.__enter__()
        self.record = SpanRecord(self.name, time.perf_counter_ns(), parent,
                                 call, self.attrs)
        self.rec.records.append(self.record)
        stack.append(self.record)
        return self

    def __exit__(self, *exc):
        self.record.end_ns = time.perf_counter_ns()
        _stack().pop()
        self._range.__exit__(*exc)
        return False

    def note(self, **attrs) -> None:
        """Attributes known only inside the span (e.g. an aligned row
        count)."""
        self.record.attrs.update(attrs)


def span(name: str, **attrs):
    """A named range of the program, `with span("prefill"):` or
    `@span("prefill")`; attrs are host-known integers (rows, batch), and a
    decorated function's span carries none. Off (outside `recording()`)
    it returns the name's one shared no-op object (made at the name's
    first use): no clock, no record_function, no allocation, and never a
    wait for the card. On, its host times are the time the host takes to
    enqueue the work; the device's time comes from a profile
    (`span_summary`)."""
    rec = _recording
    if rec is None:
        off = _OFF.get(name)
        if off is None:
            off = _OFF.setdefault(name, _Off(name))
        return off
    return _On(rec, name, attrs)


@contextlib.contextmanager
def recording():
    """Spans on for the block (every thread); yields the `Recording`. A
    recording opened inside another yields the outer one."""
    global _recording
    with _switch:
        outer, rec = _recording, _recording or Recording()
        _recording = rec
    if outer is not None:
        yield outer
        return
    try:
        yield rec
    finally:
        with _switch:
            _recording = None


@contextlib.contextmanager
def trace(logdir: Optional[str], device="cuda"):
    """Profile the block (host, and the card unless `device` is the CPU)
    with spans on and, unless `logdir` is None, write `logdir`/trace.json;
    yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof, recording():
        yield prof
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# ---------------------------------------------------------------------------
# reading a profile
# ---------------------------------------------------------------------------

def _device_ops(events) -> List[Any]:
    """The device's operations (kernels, memcpy, memset) of a profile's
    events. The ranges of record_function mirrored onto the device's
    timeline span the kernels they enclose and are not counted."""
    from torch.autograd import DeviceType
    return [e for e in events
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def kernel_summary(prof) -> Tuple[float, float, List[Tuple[float, int, str]]]:
    """-> (seconds of device kernels, seconds of 'Command Buffer Full'
    stalls, [(microseconds, calls, name)] of the kernels, longest
    first)."""
    us, n, stalls = defaultdict(float), defaultdict(int), 0.0
    for e in _device_ops(prof.events()):
        d = e.time_range.end - e.time_range.start
        if d <= 0:
            continue
        if e.name == "Command Buffer Full":
            stalls += d / 1e6
        else:
            us[e.name] += d
            n[e.name] += 1
    rows = sorted(((t, n[k], k) for k, t in us.items()), reverse=True)
    return sum(r[0] for r in rows) / 1e6, stalls, rows


def _merge(iv: List[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _busy_within(merged, ends, a: float, b: float) -> float:
    """Microseconds of the merged intervals inside [a, b]."""
    busy = 0.0
    for i in range(bisect.bisect_right(ends, a), len(merged)):
        lo, hi = merged[i]
        if lo >= b:
            break
        busy += min(hi, b) - max(lo, a)
    return busy


def _owners(host, launches) -> Tuple[Dict[int, Any], Dict[int, Any]]:
    """-> (correlation id of a launch in `launches` -> the innermost program
    span (a `medplib.` range) that holds the launch on its thread, id() of
    a span -> the span that holds it, or None). A launch is a CUDA API call
    (`cudaLaunchKernel`, `cuLaunchKernel`, `cudaMemcpyAsync`, ...), which
    carries the correlation id of the device operation it started; host
    operations' own ids count from elsewhere."""
    owner: Dict[int, Any] = {}
    parent: Dict[int, Any] = {}
    by_thread = defaultdict(list)
    for e in host:
        by_thread[e.thread].append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e.time_range.start, -e.time_range.end))
        open_spans: List[Any] = []
        for e in evs:
            while open_spans and \
                    open_spans[-1].time_range.end <= e.time_range.start:
                open_spans.pop()
            if e.name.startswith(PREFIX):
                parent[id(e)] = open_spans[-1] if open_spans else None
                open_spans.append(e)
            elif open_spans and e.name.startswith("cu") \
                    and e.id in launches:
                owner[e.id] = open_spans[-1]
    return owner, parent


def span_summary(prof, rec: Recording) -> Dict[str, Any]:
    """A profile taken under `recording()` put down to the program's
    spans (all times in seconds).

    Each device operation belongs to the innermost span that encloses the
    host call that launched it: torch.profiler's CUPTI correlation id,
    which the launch and the operation share, and not the device's
    timestamps, since the host runs ahead of the card. Per span name:
    `instances` and `host_s` (from `rec`); `device_s` and `launches` of
    the operations launched under its instances, children included;
    `self_device_s`, `self_launches` and `self_kernels` (by kernel name)
    of those whose innermost span it is; `window_s`, each instance's first
    device start to last device end, summed, and `idle_s`, the time inside
    those windows with no device operation running; `gap_s`: each idle gap
    between the merged device intervals is put down to the span that
    launched the operation ending it, since the card waited for that
    launch. Operations under no span count under `None`."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    ops = sorted(_device_ops(events), key=lambda e: e.time_range.start)
    host = [e for e in events if e.device_type == DeviceType.CPU]
    owner, parent = _owners(host, {e.id for e in ops})
    merged = _merge([(e.time_range.start, e.time_range.end) for e in ops])
    ends = [b for _, b in merged]

    spans: Dict[Optional[str], Dict[str, Any]] = defaultdict(lambda: {
        "instances": 0, "host_s": 0.0, "device_s": 0.0, "launches": 0,
        "self_device_s": 0.0, "self_launches": 0,
        "self_kernels": defaultdict(float), "window_s": 0.0, "idle_s": 0.0,
        "gap_s": 0.0})
    windows: Dict[int, List[Any]] = {}     # id(span) -> [start, end, name]
    first_of: Dict[float, Optional[str]] = {}
    for e in ops:
        a, b = e.time_range.start, e.time_range.end
        d = (b - a) / 1e6
        own = owner.get(e.id)
        r = spans[own.name[len(PREFIX):] if own is not None else None]
        first_of.setdefault(a, own.name[len(PREFIX):] if own else None)
        r["self_device_s"] += d
        r["self_launches"] += 1
        r["self_kernels"][e.name] += d
        if own is None:
            r["device_s"] += d
            r["launches"] += 1
        while own is not None:
            w = windows.setdefault(id(own), [a, b, own.name[len(PREFIX):]])
            w[0], w[1] = min(w[0], a), max(w[1], b)
            spans[w[2]]["device_s"] += d
            spans[w[2]]["launches"] += 1
            own = parent[id(own)]
    for a, b, name in windows.values():
        r = spans[name]
        r["window_s"] += (b - a) / 1e6
        r["idle_s"] += ((b - a) - _busy_within(merged, ends, a, b)) / 1e6
    idle = 0.0
    for (_, a1), (b0, _) in zip(merged, merged[1:]):
        spans[first_of[b0]]["gap_s"] += (b0 - a1) / 1e6
        idle += (b0 - a1) / 1e6
    for s in rec.records:
        r = spans[s.name]
        r["instances"] += 1
        if s.end_ns is not None:
            r["host_s"] += (s.end_ns - s.start_ns) / 1e9
    for r in spans.values():
        r["self_kernels"] = dict(r["self_kernels"])
    return {"device_s": sum(r["self_device_s"] for r in spans.values()),
            "busy_s": sum(b - a for a, b in merged) / 1e6, "idle_s": idle,
            "launches": len(ops), "spans": dict(spans)}
