"""Checks that need the card (marked `gpu`; they skip elsewhere, deciding
inside the fixture): the tiny serving cell traced through the port's
kernels, so the kernel-name map reads the profiler's names, and the
traffic drawn on the card the same twice."""

import json
import time

import pytest
import torch

from portbench import harness, traffic
from portbench.tests import tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from medplib_tpu_torch.ops.cuda import _build
    _build.load_library()
    return "cuda:0"


@pytest.mark.gpu
def test_traced_tiny_cell_on_the_card(card, tmp_path):
    """A small cell wide enough for the fused decode kernel (the
    whole-stack dispatch takes int4h experts whose hidden size is a
    multiple of 512)."""
    bench = tiny.write(tmp_path, dtype="bfloat16")
    m = json.loads((tmp_path / "tiny.json").read_text())
    m.update(hidden_size=512, intermediate_size=512, num_attention_heads=8,
             num_key_value_heads=8, head_dim=64)
    (tmp_path / "tiny.json").write_text(json.dumps(m))
    out = harness.run_cell(tiny.CELL, 2 ** 31 + 3, 1.0, True, card,
                           time.time(), bench_path=bench, root=tmp_path)
    assert out["device"]["platform"] == "gpu"
    assert out["launches"]["K2"] > 0
    k2 = out["metrics"]["k2_roofline.serve"]["value"]
    assert 0.0 < k2 <= 105.0
    assert out["device"]["busy_s"] > 0.0


@pytest.mark.gpu
def test_traffic_on_the_card_is_deterministic(card):
    m = tiny.tiny_model()
    mix = {"kind": "grounded_vqa", "batch": 4, "images_per_row": 1,
           "text_len_min": 12, "text_len_max": 20, "lengths": "spread",
           "image_at": 2, "seg_from_end": 3, "new_tokens": 3}
    a = traffic.make(mix, m, 99, 1, card)
    b = traffic.make(mix, m, 99, 1, card)
    assert torch.equal(a["clip"], b["clip"]) and torch.equal(a["ids"],
                                                              b["ids"])
