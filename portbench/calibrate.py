"""Readings that the limits of a cell's comparison are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 11 12 ...

For each seed, in one process: the cell's set-up and the load that a run
compares (the serving cell: `check_calls` calls of its own batch; the
training cell: its first `check_steps` steps, which set-up drives), the
plain reference over them, and the control: the reference with the
configuration's int8 linears stored in int4, put in the program's place.
Prints one JSON line per seed with the program's readings and the
control's, and the seconds the two comparisons took. The benchmark's own
runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings_of(workload: str, seed: int, device: str,
                bench_path=None, root=None) -> dict:
    import torch
    from portbench import harness
    kw = {}
    if bench_path is not None:
        kw = {"bench_path": Path(bench_path), "root": Path(root)}
    _, cell, model, mix = harness.cell_spec(workload, **kw)
    driver = harness._module(harness.HERE / "drivers" /
                             f"{cell['driver']}.py")
    drv = driver.Driver(model, mix, cell, seed, device)
    drv.setup()
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    prog, ctrl = drv.readings_with_control()
    return {"seed": seed, "program": prog, "control": ctrl,
            "compare_s": time.time() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        r = readings_of(args.workload, seed, "cuda:0")
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
