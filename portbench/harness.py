"""One run of one cell: find its files by name, set up, measure, compare.

BENCHMARK.json names the cell's configuration and traffic; the cell's own
file (`workloads/<cell>.json`) names its driver (`drivers/<driver>.py`),
the limits of its comparison and how many calls it profiles and compares.
Each per-layer metric is `metrics/<metric>.py`, whose `read(ctx)` returns a
number or None (nothing to read: the metric is left out of the line).
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from portbench import traffic

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "medplib_tpu")


class NoCard(RuntimeError):
    pass


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


_MODULES: Dict[Path, object] = {}


def _module(path: Path):
    """A driver or metric file, loaded once per process."""
    if path in _MODULES:
        return _MODULES[path]
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _MODULES[path] = mod
    return mod


def cell_spec(workload: str, bench_path: Path = BENCH,
              root: Path = HERE) -> Tuple[dict, dict, dict, dict]:
    """-> (the BENCHMARK.json entry, the cell file, the configuration,
    the traffic mix) of `workload`."""
    bench = load_json(bench_path)
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in {bench_path}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    model = load_json(bench_path.parent / conf["file"])
    cell = load_json(root / "workloads" / f"{workload}.json")
    mix = traffic.load_mix(entry["traffic"], root)
    return entry, cell, model, mix


def metrics_of(workload: str, kind: str, bench_path: Path = BENCH) -> List:
    bench = load_json(bench_path)
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def require_card(chips: int) -> str:
    if not torch.cuda.is_available():
        raise NoCard("no CUDA card: this benchmark measures the card only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, "
                     f"{torch.cuda.device_count()} found")
    return "cuda:0"


def jax_loaded() -> List[str]:
    """Top-level module names of jax, jaxlib, flax or the JAX package in
    sys.modules (compared whole: the port's name starts with the JAX
    package's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, bench_path: Path = BENCH,
             root: Path = HERE) -> Dict:
    """-> the result line's object (metrics by the cell's names)."""
    entry, cell, model, mix = cell_spec(workload, bench_path, root)
    driver = _module(HERE / "drivers" / f"{cell['driver']}.py")
    on_card = torch.device(device).type == "cuda"
    drv = driver.Driver(model, mix, cell, seed, device)
    drv.setup()
    setup_s = time.time() - t_start
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ctx = drv.window(seconds, trace)
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    ctx["window_peak_bytes"] = window_peak
    found = jax_loaded()
    if found:
        raise RuntimeError(f"the run loaded {found}")
    drv.release()
    try:
        readings = drv.check()
    except ValueError as err:      # an output the reference cannot read
        print(f"comparison failed: {err}", file=sys.stderr)
        readings = {k: float("inf") for k in cell["limits"]}
    checks = {k: {"value": readings[k], "limit": lim}
              for k, lim in cell["limits"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    values: Dict[str, Optional[float]] = {}
    kind = "per_layer" if trace else "end_to_end"
    for m in metrics_of(workload, kind, bench_path):
        if m["name"] == "setup_s":
            values["setup_s"] = setup_s
        elif kind == "end_to_end":
            values[m["name"]] = ctx[m["name"]]
        else:
            values[m["name"]] = _module(
                HERE / "metrics" / f"{m['name']}.py").read(ctx)
    units = {m["name"]: m["unit"] for m in metrics_of(workload, kind,
                                                       bench_path)}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": entry["chips"] if on_card else 0,
           "memory_peak_bytes": max(setup_peak, window_peak)}
    out = {"correct": correct, "attempted": ctx["answers"],
           "failed": 0 if correct else ctx["answers"],
           "metrics": {k: {"value": v, "unit": units[k]}
                       for k, v in values.items() if v is not None},
           "device": dev}
    if trace:
        prof = ctx["profile"]
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = ctx["profile_wall_s"]
        out["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in prof["ops"][:10]],
            "idle_gaps": [[n[:160], s] for n, s in prof["idle_gaps"][:10]]}
        out["launches"] = ctx["launches"]
    out["informative"] = {k: v for k, v in readings.items()
                          if k not in checks}
    out["checks"] = checks
    return out
