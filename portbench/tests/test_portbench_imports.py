"""The import guard: the harness, every driver, every metric and the
reference load neither jax nor the JAX package, and the reference loads
nothing of the port. Top-level module names are compared whole (the
port's name starts with the JAX package's)."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"

_PROBE = """
import importlib.util, json, sys
sys.path.insert(0, {root!r})
for path in {files!r}:
    name = "probe_" + str(abs(hash(path)))
    spec = importlib.util.spec_from_file_location(name, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
for name in {modules!r}:
    __import__(name)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _tops(files=(), modules=()):
    code = _PROBE.format(root=str(ROOT), files=[str(f) for f in files],
                         modules=list(modules))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_drivers_metrics_load_no_jax():
    files = (list((PB / "drivers").glob("*.py"))
             + list((PB / "metrics").glob("*.py")))
    tops = _tops(files, ["portbench.harness", "portbench.counts",
                         "portbench.tracing", "portbench.traffic",
                         "portbench.calibrate", "portbench.run"])
    assert not tops & {"jax", "jaxlib", "flax", "medplib_tpu"}


def test_reference_loads_nothing_of_the_program():
    mods = ["portbench.reference." + p.stem
            for p in (PB / "reference").glob("*.py")]
    tops = _tops((), mods)
    assert not tops & {"jax", "jaxlib", "flax", "medplib_tpu",
                       "medplib_tpu_torch"}


def test_a_tiny_run_loads_no_jax(tmp_path):
    """The harness and the port as a run drives them (tiny cell, CPU)."""
    from portbench.tests import tiny
    bench = tiny.write(tmp_path)
    code = f"""
import json, sys, time
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from portbench import harness
out = harness.run_cell({tiny.CELL!r}, 5, 0.2, False, "cpu", time.time(),
                       bench_path=Path({str(bench)!r}),
                       root=Path({str(tmp_path)!r}))
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "medplib_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "medplib_tpu"}
