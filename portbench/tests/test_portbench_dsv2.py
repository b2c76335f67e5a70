"""The DeepSeek-V2-Lite cell's pieces on the CPU: its configuration
against the published config.json keys, the counts at the cell's shape,
the three new metric readers, and the driver failing at once on a port
without MLA."""

import json
from pathlib import Path

import pytest

from portbench import counts_dsv2, harness
from portbench.tests import tiny_dsv2 as tiny

PB = Path(__file__).resolve().parents[1]
CELL = "dsv2lite-ground-b64"

# config.json of deepseek-ai/DeepSeek-V2-Lite (the keys that fix shapes)
PUBLISHED = {
    "attention_bias": False, "first_k_dense_replace": 1,
    "hidden_act": "silu", "hidden_size": 2048, "intermediate_size": 10944,
    "kv_lora_rank": 512, "max_position_embeddings": 163840,
    "model_type": "deepseek_v2", "moe_intermediate_size": 1408,
    "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64,
    "n_shared_experts": 2, "norm_topk_prob": False,
    "num_attention_heads": 16, "num_experts_per_tok": 6,
    "num_hidden_layers": 27, "num_key_value_heads": 16, "q_lora_rank": None,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 1,
    "scoring_func": "softmax", "seq_aux": True, "tie_word_embeddings": False,
    "topk_group": 1, "topk_method": "greedy", "v_head_dim": 128,
    "vocab_size": 102400}


@pytest.fixture(scope="module")
def model():
    return harness.cell_spec(CELL)[2]


def test_configuration_keeps_the_published_keys(model):
    for k, v in PUBLISHED.items():
        assert model[k] == v, k
    assert "head_dim" not in model and model["reduced"] == []
    assert model["medplib"]["vocab_size_padded"] == 102720
    assert model["medplib"]["seg_token_idx"] == 102400
    assert model["serving"]["expert_pad_align"] == 256
    assert model["assumed"]


def test_counts_at_the_cell_shape(model):
    """K4 <192, 128> at B = 64 rows of 623-687 in 687 positions is bound
    by its bytes at ~0.27 ms a layer; K1 counts six routed rows a
    token."""
    lens = [round(623 + 64 * r / 63) for r in range(64)]
    s, which = counts_dsv2.k4_bound_s(model, lens, 687)
    assert which == "bytes"
    assert s / 27 == pytest.approx(0.27e-3, rel=0.02)
    one = dict(model, num_experts_per_tok=1)
    assert counts_dsv2.k1_bound_s(model, 44_000) > \
        5 * counts_dsv2.k1_bound_s(one, 44_000)
    # decode: the 64 experts' int4 bytes a layer a step, ~0.083 ms
    assert counts_dsv2.k2_bound_s(model, 64, 1) / 26 == pytest.approx(
        8.3e-5, rel=0.02)
    # a row: ~2.2 B active parameters over 687 tokens, CLIP and SAM
    per_row = counts_dsv2.serve_call_flops(model, [687], 10)
    assert 3e12 < per_row < 4.5e12
    assert counts_dsv2.launches_per_call(model, 64, 10) == {
        "K1": 78, "K2": 260, "K4_qk192": 27, "plain_attention": 0}


def test_metric_readers():
    def read(name, ctx):
        return harness._module(PB / "metrics" / f"{name}.py").read(ctx)
    for name in ("k4_roofline.serve", "attn_ms.serve", "moe_ms.serve"):
        assert read(name, {}) is None
    ctx = {"k4_192_s": 0.02, "k4_192_bound_s": 0.01, "profile_calls": 2,
           "program": {"spans": {
               "attn": {"device_s": 0.5}, "moe.route": {"device_s": 0.1},
               "moe.experts": {"device_s": 0.3},
               "moe.shared": {"device_s": 0.2}}}}
    assert read("k4_roofline.serve", ctx) == pytest.approx(50.0)
    assert read("attn_ms.serve", ctx) == pytest.approx(250.0)
    assert read("moe_ms.serve", ctx) == pytest.approx(300.0)


def test_kernel_name_of_the_qk192_instantiation():
    ops = [("void (anonymous namespace)::flash_fwd_mma_kernel<192, 128>"
            "(__nv_bfloat16 const*)", 0.25),
           ("void (anonymous namespace)::flash_fwd_mma_kernel<128, 128>"
            "(__nv_bfloat16 const*)", 1.0)]
    assert counts_dsv2.k4_192_s(ops) == 0.25


def test_driver_needs_the_ports_mla(tmp_path, monkeypatch):
    """On a port whose config module has no MlaConfig, set-up fails at
    once with an ImportError, before anything is built or run."""
    import medplib_tpu_torch.config as C
    from portbench.drivers import dsv2_generate
    bench = tiny.write(tmp_path)
    _, cell, model, mix = harness.cell_spec(tiny.CELL, bench, tmp_path)
    monkeypatch.delattr(C, "MlaConfig")
    drv = dsv2_generate.Driver(model, mix, cell, 1, "cpu")
    with pytest.raises(ImportError):
        drv.setup()
    assert not hasattr(drv, "params")


def test_mix_file(tmp_path):
    mix = json.loads((PB / "mixes" / "ground-b64.json").read_text())
    assert mix["batch"] == 64 and mix["new_tokens"] == 10
    assert (mix["text_len_min"], mix["text_len_max"]) == (48, 112)
