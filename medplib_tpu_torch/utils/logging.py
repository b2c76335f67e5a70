"""Metrics and logging (medplib_tpu/utils/logging.py): AverageMeter,
ProgressMeter and a JSONL scalar writer."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class AverageMeter:
    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def __str__(self):
        return ("{name} {val" + self.fmt + "} ({avg" + self.fmt + "})").format(
            name=self.name, val=self.val, avg=self.avg)


class ProgressMeter:
    def __init__(self, num_batches: int, meters, prefix: str = ""):
        self.fmtstr = "{:" + str(len(str(num_batches))) + "d}/" + str(
            num_batches)
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        entries = [self.prefix + self.fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        print("  ".join(entries), flush=True)


class ScalarWriter:
    """Appends {"tag", "value", "step", "ts"} lines to
    <log_dir>/scalars.jsonl."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int):
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": step,
             "ts": time.time()}) + "\n")
        self._jsonl.flush()

    def add_scalars(self, scalars: Dict[str, float], step: int,
                    prefix: str = ""):
        for k, v in scalars.items():
            self.add_scalar(prefix + k, v, step)

    def close(self):
        self._jsonl.close()
