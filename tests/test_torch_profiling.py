"""The port's profiling module (medplib_tpu_torch/utils/profiling.py) on
the CPU: spans off (one shared object, no clock, no range, no allocation)
and on (records, parents, call ids), `recording()` as the one switch,
`span_summary` on a hand-built event list with exact answers, a host
trace written as a Chrome trace, and a small MoE `generate` under
torch.profiler: no program range with recording off, the span tree of
the serving path with it on, and the same tokens and masks either way.

The small model has the flagship's structure (LLaMA H=512, 2 layers x 2
int4h experts, int8 elsewhere): B=16 x T_in=64 spliced to 1264 tokens
takes the grouped prefill (K1's plain version) under W8A8, and decode the
fused kernel (K2's plain version) on weight-only int8 projections."""

import itertools
import json
import os
import threading
import time
import tracemalloc
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from medplib_tpu_torch import config as C
from medplib_tpu_torch.config import IMAGE_TOKEN_INDEX
from medplib_tpu_torch.models import medplib
from medplib_tpu_torch.utils import profiling as prof_mod
from medplib_tpu_torch.utils.quantize import (dynamic_act_quant,
                                              quantize_flagship_moe)

torch.set_num_threads(1)
MAX_NEW = 3


# -- spans ------------------------------------------------------------------

def test_span_off_is_one_shared_object_that_touches_nothing(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("an off span touched the clock, a range or "
                             "the card")

    first = prof_mod.span("off.probe", rows=3)
    monkeypatch.setattr(time, "perf_counter_ns", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    assert prof_mod.span("off.probe") is first
    def traced(n):
        """-> (bytes held after n off spans, peak above the start)."""
        it = itertools.repeat(None, n)
        tracemalloc.start()
        try:
            before, _ = tracemalloc.get_traced_memory()
            tracemalloc.reset_peak()
            for _ in it:
                with prof_mod.span("off.probe", rows=16) as sp:
                    sp.note(Sp=1024)
            now, peak = tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()
        return now - before, peak - before

    traced(1)
    held, peak = traced(5000)
    assert held == 0 and traced(5)[1] == peak, (held, peak)


def test_span_records_nesting_call_ids_and_attrs():
    with prof_mod.recording() as rec:
        with prof_mod.span("outer", batch=4):
            with prof_mod.span("inner", layer=1) as sp:
                sp.note(Sp=1536)
            with prof_mod.span("inner", layer=2):
                pass
        with prof_mod.span("outer"):
            pass
    names = [r.name for r in rec.records]
    assert names == ["outer", "inner", "inner", "outer"]
    o1, i1, i2, o2 = rec.records
    assert o1.parent is None and o2.parent is None
    assert i1.parent is o1 and i2.parent is o1
    assert o1.call == i1.call == i2.call != o2.call
    assert o1.attrs == {"batch": 4} and i1.attrs == {"layer": 1, "Sp": 1536}
    for r in rec.records:
        assert r.end_ns >= r.start_ns
    assert o1.start_ns <= i1.start_ns <= i1.end_ns <= i2.start_ns \
        <= i2.end_ns <= o1.end_ns <= o2.start_ns


@prof_mod.span("deco.outer")
def _decorated(x):
    """Doubles x."""
    with prof_mod.span("deco.inner"):
        return _decorated_leaf(x) * 2


@prof_mod.span("deco.leaf")
def _decorated_leaf(x):
    return x + 1


def test_span_as_a_decorator_made_while_off():
    assert _decorated.__name__ == "_decorated"
    assert _decorated.__doc__ == "Doubles x."
    assert _decorated(1) == 4                      # off: plain call
    with prof_mod.recording() as rec:
        assert _decorated(2) == 6
    got = [(r.name, r.parent.name if r.parent else None)
           for r in rec.records]
    assert got == [("deco.outer", None), ("deco.inner", "deco.outer"),
                   ("deco.leaf", "deco.inner")]
    assert len({r.call for r in rec.records}) == 1


def test_recording_closed_by_an_exception_leaves_spans_off():
    with pytest.raises(RuntimeError):
        with prof_mod.recording():
            with prof_mod.span("doomed"):
                raise RuntimeError("stop")
    assert isinstance(prof_mod.span("doomed"), prof_mod._Off)
    with prof_mod.recording() as rec:      # and a new recording is clean
        with prof_mod.span("fresh"):
            pass
    assert [r.name for r in rec.records] == ["fresh"]
    assert rec.records[0].parent is None


def test_recording_covers_every_thread_with_its_own_roots():
    def work():
        with prof_mod.span("worker"):
            with prof_mod.span("worker.step"):
                pass

    with prof_mod.recording() as rec:
        with prof_mod.recording() as inner:     # nested: the outer one
            assert inner is rec
        with prof_mod.span("main"):
            t = threading.Thread(target=work)
            t.start()
            t.join()
    by = {r.name: r for r in rec.records}
    assert by["worker"].parent is None           # not under "main"
    assert by["worker.step"].parent is by["worker"]
    assert by["worker"].call != by["main"].call
    assert by["worker.step"].call == by["worker"].call


# -- reading a profile -------------------------------------------------------

def _host(eid, name, a, b, thread=1):
    return SimpleNamespace(id=eid, name=name, device_type=DeviceType.CPU,
                           time_range=SimpleNamespace(start=a, end=b),
                           thread=thread, is_user_annotation=False)


def _dev(name, a, b, corr, user=False):
    return SimpleNamespace(id=corr, name=name, device_type=DeviceType.CUDA,
                           time_range=SimpleNamespace(start=a, end=b),
                           thread=7, is_user_annotation=user)


def _profile():
    """Host (microseconds): generate [0, 100] holds decode_step [10, 40]
    (aten::mm 12-14, linear.dequant [20, 30] with aten::mul 22-24) and
    ground [50, 60], where a library launches two kernels through
    `cuLaunchKernel` with no aten op around them; aten::add at 70 under
    generate alone; aten::copy_ at 120 under no span. Each launch call
    carries its device operation's correlation id (101-106); aten::mm's
    own id collides with one of them and must not count as a launch. The
    card runs behind: mm 30-40, mul 45-55 (after linear.dequant's host
    end), a range mirrored onto the device 30-90 (not work), the
    library's 60-62 and 62-70, add 80-85, the copy 130-131."""
    host = [_host(1, "medplib.generate", 0, 100),
            _host(2, "medplib.decode_step", 10, 40),
            _host(103, "aten::mm", 12, 14),
            _host(101, "cudaLaunchKernel", 12.5, 13),
            _host(4, "medplib.linear.dequant", 20, 30),
            _host(5, "aten::mul", 22, 24),
            _host(102, "cudaLaunchKernel", 22.5, 23),
            _host(6, "medplib.ground", 50, 60),
            _host(103, "cuLaunchKernel", 52, 52.5),
            _host(104, "cuLaunchKernel", 52.6, 53),
            _host(8, "aten::add", 70, 71),
            _host(105, "cudaLaunchKernel", 70.2, 70.5),
            _host(9, "aten::copy_", 120, 121),
            _host(106, "cudaMemcpyAsync", 120.2, 120.6)]
    dev = [_dev("gemm", 30, 40, 101),
           _dev("medplib.decode_step", 30, 90, 2, user=True),
           _dev("mul_kernel", 45, 55, 102),
           _dev("conv_a", 60, 62, 103),
           _dev("conv_b", 62, 70, 104),
           _dev("add_kernel", 80, 85, 105),
           _dev("Memcpy DtoD", 130, 131, 106)]
    rec = prof_mod.Recording()
    for name in ("generate", "decode_step", "linear.dequant", "ground"):
        r = prof_mod.SpanRecord(name, 0, None, 1, {})
        r.end_ns = 2_000
        rec.records.append(r)
    return SimpleNamespace(events=lambda: host + dev), rec


def test_span_summary_device_time_and_launches_by_span():
    p, rec = _profile()
    out = prof_mod.span_summary(p, rec)
    s = out["spans"]
    assert out["launches"] == 6
    assert out["device_s"] == pytest.approx(36e-6)
    assert out["busy_s"] == pytest.approx(36e-6)      # no overlap
    dq = s["linear.dequant"]
    assert (dq["device_s"], dq["launches"]) == (pytest.approx(10e-6), 1)
    assert dq["self_kernels"] == {"mul_kernel": pytest.approx(10e-6)}
    ds = s["decode_step"]
    assert (ds["device_s"], ds["launches"]) == (pytest.approx(20e-6), 2)
    assert (ds["self_device_s"], ds["self_launches"]) == \
        (pytest.approx(10e-6), 1)
    gr = s["ground"]
    assert (gr["device_s"], gr["launches"]) == (pytest.approx(10e-6), 2)
    gen = s["generate"]
    assert (gen["device_s"], gen["launches"]) == (pytest.approx(35e-6), 5)
    assert (gen["self_device_s"], gen["self_launches"]) == \
        (pytest.approx(5e-6), 1)
    assert (s[None]["device_s"], s[None]["launches"]) == \
        (pytest.approx(1e-6), 1)
    assert {k: v["instances"] for k, v in s.items()} == \
        {"generate": 1, "decode_step": 1, "linear.dequant": 1, "ground": 1,
         None: 0}
    assert gen["host_s"] == pytest.approx(2e-6)


def test_span_summary_windows_and_idle_gaps():
    p, rec = _profile()
    s = prof_mod.span_summary(p, rec)["spans"]
    # decode_step's kernels run 30-40 and 45-55: a 25 us window, 5 idle
    assert s["decode_step"]["window_s"] == pytest.approx(25e-6)
    assert s["decode_step"]["idle_s"] == pytest.approx(5e-6)
    assert s["ground"]["window_s"] == pytest.approx(10e-6)
    assert s["ground"]["idle_s"] == 0.0
    # generate: 30-85, of which 36 - 1 (the copy) busy
    assert s["generate"]["window_s"] == pytest.approx(55e-6)
    assert s["generate"]["idle_s"] == pytest.approx(20e-6)
    # gaps go to the span that launched the operation ending them
    assert s["linear.dequant"]["gap_s"] == pytest.approx(5e-6)   # 40-45
    assert s["ground"]["gap_s"] == pytest.approx(5e-6)           # 55-60
    assert s["generate"]["gap_s"] == pytest.approx(10e-6)        # 70-80
    assert s[None]["gap_s"] == pytest.approx(45e-6)              # 85-130
    out = prof_mod.span_summary(p, rec)
    assert out["idle_s"] == pytest.approx(65e-6)
    assert sum(v["gap_s"] for v in s.values()) == pytest.approx(65e-6)


def test_kernel_summary_counts_kernels_not_mirrored_ranges():
    p, _ = _profile()
    busy, stalls, rows = prof_mod.kernel_summary(p)
    assert busy == pytest.approx(36e-6) and stalls == 0.0
    assert rows[:3] == [(10, 1, "mul_kernel"), (10, 1, "gemm"),
                        (8, 1, "conv_b")]
    assert {r[2] for r in rows} == {"gemm", "mul_kernel", "conv_a",
                                    "conv_b", "add_kernel", "Memcpy DtoD"}


def test_trace_writes_annotated_chrome_trace(tmp_path):
    """trace() turns spans on for its block; their ranges reach the Chrome
    trace and the profiler."""
    logdir = str(tmp_path / "trace")
    with prof_mod.trace(logdir, device="cpu") as prof:
        with prof_mod.span("step"):
            y = torch.randn(64, 64) @ torch.randn(64, 64)
        with prof_mod.span("decode"):
            y = y.relu().sum()
    assert isinstance(prof_mod.span("step"), prof_mod._Off)
    with open(os.path.join(logdir, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"medplib.step", "medplib.decode"} <= names
    assert any(e.key == "medplib.step" for e in prof.key_averages())
    busy, stalls, rows = prof_mod.kernel_summary(prof)
    assert busy == 0.0 and stalls == 0.0 and rows == []   # no device here
    assert np.isfinite(float(y))


def test_trace_without_logdir_writes_nothing(tmp_path):
    with prof_mod.trace(None, device="cpu"):
        torch.ones(3).sum()
    assert os.listdir(tmp_path) == []


# -- the serving path --------------------------------------------------------

def _cfg():
    llm = C.LlamaConfig(vocab_size=512, hidden_size=512,
                        intermediate_size=1024, num_layers=2, num_heads=8,
                        num_kv_heads=8, head_dim=64,
                        max_position_embeddings=512)
    return C.MedplibConfig.tiny(
        llm=llm, projector=C.ProjectorConfig(mm_hidden_size=64,
                                             hidden_size=512),
        moe=C.MoeConfig(enable=True, num_experts=2, top_k=1,
                        capacity_factor=1.5, eval_capacity_factor=2.0))


def _batch(cfg, b, t, rng):
    ids = rng.integers(3, cfg.seg_token_idx, size=(b, t))
    ids[:, 0], ids[:, 2], ids[:, t - 3] = 1, IMAGE_TOKEN_INDEX, \
        cfg.seg_token_idx
    vs, ss = cfg.vision.image_size, cfg.sam.image_size
    return medplib.Batch.make(
        input_ids=torch.from_numpy(ids),
        input_mask=torch.ones((b, t), dtype=torch.int32),
        labels=torch.from_numpy(ids),
        images_clip=torch.from_numpy(
            rng.normal(size=(b, 1, vs, vs, 3)).astype(np.float32)),
        images_sam=torch.from_numpy(
            rng.uniform(0, 255, size=(b, ss, ss, 3)).astype(np.float32)),
        image_token_lengths=torch.full((b, 1), cfg.vision.num_patches,
                                       dtype=torch.int32),
        sam_frame=ss)


@pytest.fixture(scope="module")
def served():
    """Each way of running one call: plain, profiled with recording off,
    profiled with recording on (-> outputs, the event names, the
    recording)."""
    cfg = _cfg()
    p = medplib.init_medplib(torch.Generator().manual_seed(0), cfg,
                             torch.float32, "cpu")
    p["llm"]["embed_tokens"]["embedding"] *= 50.0
    p = quantize_flagship_moe(p, 4, 8)
    batch = _batch(cfg, 16, 64, np.random.default_rng(0))

    def call():
        with dynamic_act_quant(True):
            return medplib.generate(p, cfg, batch, max_new_tokens=MAX_NEW)

    from torch.profiler import ProfilerActivity, profile
    out = {"plain": call()}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out["off"] = call()
    out["off_names"] = {e.name for e in prof.events()}
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            prof_mod.recording() as rec:
        out["on"] = call()
    out["on_names"] = {e.name for e in prof.events()}
    out["rec"] = rec
    return out


def test_generate_with_recording_off_leaves_no_program_range(served):
    assert not [n for n in served["off_names"] if n.startswith("medplib.")]
    assert "aten::mm" in served["off_names"]


def test_generate_span_tree_is_the_serving_path(served):
    rec = served["rec"]
    parents = {(r.name, r.parent.name if r.parent else None)
               for r in rec.records}
    assert parents == {
        ("generate", None), ("prefill", "generate"),
        ("encode_images", "prefill"), ("linear.dequant", "encode_images"),
        ("splice", "prefill"),
        ("llm.layer", "prefill"), ("llm.layer", "decode_step"),
        ("attn", "llm.layer"), ("linear.w8a8", "attn"),
        ("linear.dequant", "attn"), ("moe.route", "llm.layer"),
        ("moe.experts", "llm.layer"), ("lm_head", "prefill"),
        ("lm_head", "decode_step"), ("linear.dequant", "lm_head"),
        ("sample", "prefill"), ("sample", "decode_step"),
        ("decode_step", "generate"), ("ground", "generate"),
        ("sam.encode", "ground"), ("sam.decode", "ground")}
    assert len({r.call for r in rec.records}) == 1
    count = lambda n: sum(r.name == n for r in rec.records)  # noqa: E731
    assert count("decode_step") == MAX_NEW
    assert count("llm.layer") == 2 * (1 + MAX_NEW)
    assert [r.attrs["layer"] for r in rec.records
            if r.name == "llm.layer"] == [0, 1] * (1 + MAX_NEW)
    exp = [r.attrs for r in rec.records if r.name == "moe.experts"]
    assert exp[0] == {"S": 16 * 79, "Sp": (16 * 79 // 512 + 2) * 512}
    assert exp[-1] == {"S": 16}                     # decode: the fused call
    # every program range reached the profiler
    assert {"medplib." + r.name for r in rec.records} <= served["on_names"]


def test_generate_outputs_equal_with_recording_on_and_off(served):
    for way in ("off", "on"):
        got, want = served[way], served["plain"]
        assert torch.equal(got.output_ids, want.output_ids), way
        assert torch.equal(got.pred_masks, want.pred_masks), way
        assert torch.equal(got.seg_valid, want.seg_valid), way
