"""Whole runs of the tiny cells on the CPU (the look for a card skipped):
the result lines, the traced metrics, and `correct` coming out false for
each cell's control and for each fault the cell can have."""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import serve
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]


def _run(tmp_path, trace=False, seed=17, seconds=0.3, cell=tiny.CELL):
    write = tiny.write if cell == tiny.CELL else tiny.write_train
    bench = write(tmp_path)
    return harness.run_cell(cell, seed, seconds, trace, "cpu", time.time(),
                            bench_path=bench, root=tmp_path)


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", tiny.CELL,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_result_line(tmp_path):
    out = _run(tmp_path)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"masks_per_s", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    json.dumps(out)


def test_traced_line(tmp_path):
    out = _run(tmp_path, trace=True)
    assert out["correct"] is True
    names = set(out["metrics"])
    assert {"prefill_ms.serve", "decode_ms_per_step.serve",
            "ground_ms.serve", "mfu.serve", "idle_share.serve"} <= names
    # the CPU runs no kernel of the port: their rooflines stay silent
    assert "k1_roofline.serve" not in names
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "busy_s" in out["device"] and "window_s" in out["device"]


def _faulty(monkeypatch, tmp_path, patch, cell=tiny.CELL):
    from medplib_tpu_torch.models import medplib
    patch(monkeypatch, medplib)
    return _run(tmp_path, cell=cell)


def _altered_token(monkeypatch, medplib):
    real = medplib.sampling.select_token

    def select(logits, *a, **k):
        tok = real(logits, *a, **k)
        return torch.where(torch.arange(tok.shape[0]) == 0,
                           (tok + 1) % logits.shape[-1], tok)
    monkeypatch.setattr(medplib.sampling, "select_token", select)


def _half_batch(monkeypatch, medplib):
    real = medplib.generate

    def generate(params, cfg, batch, **k):
        half = batch.input_ids.shape[0] // 2
        r = real(params, cfg, type(batch)(*[
            x[:half] if torch.is_tensor(x) else x for x in batch]), **k)
        return type(r)(*[torch.cat([x, x]) for x in r])
    monkeypatch.setattr(medplib, "generate", generate)


def _state_unchanged(monkeypatch, medplib):
    real = medplib._make_decode_step

    def make(*a, **k):
        step = real(*a, **k)

        def frozen(carry):
            _, out = step(carry)
            return carry, out
        return frozen
    monkeypatch.setattr(medplib, "_make_decode_step", make)


def _altered_mask(monkeypatch, medplib):
    real = medplib.ground_seg_slots

    def ground(*a, **k):
        masks, valid = real(*a, **k)
        return -masks, valid
    monkeypatch.setattr(medplib, "ground_seg_slots", ground)


@pytest.mark.parametrize("fault", [_altered_token, _half_batch,
                                   _state_unchanged, _altered_mask],
                         ids=["token_altered", "half_batch",
                              "state_unchanged", "mask_altered"])
def test_fault_fails(monkeypatch, tmp_path, fault):
    out = _faulty(monkeypatch, tmp_path, fault)
    assert out["correct"] is False


def _train_state_unchanged(monkeypatch, medplib):
    from medplib_tpu_torch.train import trainer
    real = trainer.make_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def frozen(state, batches):
            _, metrics = step(state, batches)
            return state, metrics
        return frozen
    monkeypatch.setattr(trainer, "make_train_step", make)


def _train_half_batch(monkeypatch, medplib):
    real = medplib.model_forward

    def forward(params, cfg, batch, **k):
        half = batch.input_ids.shape[0] // 2
        return real(params, cfg, type(batch)(*[
            x[:half] if torch.is_tensor(x) else x for x in batch]), **k)
    monkeypatch.setattr(medplib, "model_forward", forward)


def test_train_result_line(tmp_path):
    out = _run(tmp_path, cell=tiny.TRAIN_CELL)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}


def test_train_traced_line(tmp_path):
    out = _run(tmp_path, trace=True, cell=tiny.TRAIN_CELL)
    assert out["correct"] is True
    assert {"mfu.train", "idle_share.train"} <= set(out["metrics"])
    assert "flash_roofline.train" not in out["metrics"]


@pytest.mark.parametrize("fault", [_train_state_unchanged,
                                   _train_half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_train_fault_fails(monkeypatch, tmp_path, fault):
    out = _faulty(monkeypatch, tmp_path, fault, cell=tiny.TRAIN_CELL)
    assert out["correct"] is False


def test_control_fails(tmp_path):
    """The reference with the int8 linears in int4, put in the program's
    place, fails the cell's limits (readings as calibrate.py takes them)."""
    from portbench import calibrate
    bench = tiny.write(tmp_path)
    _, cell, _, _ = harness.cell_spec(tiny.CELL, bench, tmp_path)
    for seed in (3, 4, 5):
        r = calibrate.readings_of(tiny.CELL, seed, "cpu", bench, tmp_path)
        assert r["program"]["logit_gap_max"] == 0.0
        assert any(r["control"][k] > lim for k, lim in cell["limits"].items())


def test_gaps_read_the_served_token():
    ref = torch.tensor([[0.0, 2.0, 1.0], [3.0, 0.5, 0.0]])
    g = serve.gaps(ref, torch.tensor([1, 1]))
    assert np.allclose(g.numpy(), [0.0, 2.5])
