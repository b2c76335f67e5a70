"""The port's profiling helpers (medplib_tpu_torch/utils/profiling.py)
against the JAX package's (medplib_tpu/utils/profiling.py), on the CPU:
the analytic FLOP formula (equal), mfu's default peak (one H100's dense
bf16 rate, not the TPU's), `timed`, `device_sync`, and a host trace with
`annotate` ranges written as a Chrome trace."""

import json
import os

import numpy as np
import pytest
import torch

from medplib_tpu.utils import profiling as jprof
from medplib_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)


@pytest.mark.parametrize("dims", [(4096, 32, 11008, 32000, 1087),
                                  (64, 2, 128, 512, 16),
                                  (4096, 32, 16384, 50432, 80)])
def test_llama_flops_per_token_equals_jax(dims):
    assert tprof.llama_flops_per_token(*dims) == \
        jprof.llama_flops_per_token(*dims)


def test_mfu_default_peak_is_the_h100_bf16_rate():
    assert tprof.H100_BF16_PEAK == 989e12
    f = tprof.llama_flops_per_token(4096, 32, 11008, 32000, 512)
    assert tprof.mfu(1000.0, f) == 1000.0 * f / 989e12
    # with the peak given, the same number as the JAX function's
    assert tprof.mfu(1000.0, f, 197e12) == jprof.mfu(1000.0, f, 197e12)


def test_timed_and_device_sync_on_the_cpu():
    calls = []

    def fn(a, scale=1.0):
        calls.append(1)
        return {"b": a * scale, "a": a.sum()}

    x = torch.arange(6.0)
    dt, out = tprof.timed(fn, x, iters=3, warmup=2, scale=2.0)
    assert len(calls) == 5 and dt >= 0.0
    assert torch.equal(out["b"], x * 2)
    # the checksum is of the first leaf in sorted-key order, as in JAX
    assert tprof.device_sync(out) == float(x.sum())
    assert tprof.device_sync({"n": None}) == 0.0
    assert tprof.device_sync(([], (torch.ones(3),))) == 3.0


def test_trace_writes_annotated_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with tprof.trace(logdir, device="cpu") as prof:
        with tprof.annotate("medplib.step"):
            y = torch.randn(64, 64) @ torch.randn(64, 64)
        with tprof.annotate("medplib.decode"):
            y = y.relu().sum()
    with open(os.path.join(logdir, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"medplib.step", "medplib.decode"} <= names
    assert any(e.key == "medplib.step" for e in prof.key_averages())
    busy, stalls, rows = tprof.kernel_summary(prof)
    assert busy == 0.0 and stalls == 0.0 and rows == []   # no device here
    assert np.isfinite(float(y))


def test_trace_without_logdir_writes_nothing(tmp_path):
    with tprof.trace(None, device="cpu"):
        torch.ones(3).sum()
    assert os.listdir(tmp_path) == []
