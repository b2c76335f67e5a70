"""The opt-in modules of the port against the JAX package: the
whole-stack W8A8 linears (ops/stacked.py, K3's plain version on the CPU
against the Pallas gmm in interpret mode) and their MEDPLIB_STACK_ATTN /
MEDPLIB_STACK_MLP hooks in llama.forward, the ragged MoE dispatch, the
device preprocess and the native preprocessing library (the serving
worker with device_preprocess=True: tests/test_torch_serve.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medplib_tpu.config as jc
from medplib_tpu.data import preprocess as jpp
from medplib_tpu.models import llama as jllama
from medplib_tpu.ops import device_preprocess as jdev
from medplib_tpu.ops import moe as jmoe
from medplib_tpu.ops import stacked as jst
from medplib_tpu.utils import quantize as jq
from medplib_tpu_torch import native
from medplib_tpu_torch.data import preprocess as tpp
from medplib_tpu_torch.models import llama as tllama
from medplib_tpu_torch.ops import device_preprocess as tdev
from medplib_tpu_torch.ops import moe as tmoe
from medplib_tpu_torch.ops import stacked as tst
from medplib_tpu_torch.utils import convert
from medplib_tpu_torch.utils.quantize import dynamic_act_quant
from test_torch_slice import port_cfg

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _llama(layers=2, h=1024, m=1024):
    cfg = jc.LlamaConfig(vocab_size=256, hidden_size=h, intermediate_size=m,
                         num_layers=layers, num_heads=8, num_kv_heads=8,
                         head_dim=h // 8, max_position_embeddings=1200)
    p = jllama.init_llama(jax.random.PRNGKey(0), cfg)
    p["embed_tokens"]["embedding"] = p["embed_tokens"]["embedding"] * 50.0
    p = jq.quantize_tree(p, bits=8)
    return cfg, p, jax.tree_util.tree_map(np.asarray, p)


def test_stacked_linears_match_jax():
    """stacked_w8a8_linear (q_proj transposed, o_proj normal) and
    stacked_dense_mlp at 1040 rows (padded to 1536) bit-equal to JAX's on
    the same stacks and rows."""
    _, _, host = _llama()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1040, 1024)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    jat = jst.stack_attn_for_w8a8(jax.tree_util.tree_map(
        jnp.asarray, host["layers"]), 1040)
    tat = tst.stack_attn_for_w8a8(convert.tree_from_numpy(
        host["layers"], "cpu"), 1040)
    assert jat is not None and tat is not None
    jxq, jxs, rows = jax.jit(jst.quantize_rows_padded)(xb)
    txq, txs, rows_t = tst.quantize_rows_padded(
        torch.from_numpy(x).to(torch.bfloat16))
    assert rows == rows_t == 1040
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    for name in ("q_proj", "o_proj"):
        want = jax.jit(lambda a, s, n=name: jst.stacked_w8a8_linear(
            jat[n], a, s, 1, 1040))(jxq, jxs)
        got = tst.stacked_w8a8_linear(tat[name], txq, txs, 1, 1040)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    jm = jst.stack_mlp_for_w8a8(jax.tree_util.tree_map(jnp.asarray,
                                                       host["layers"]), 1040)
    tmm = tst.stack_mlp_for_w8a8(convert.tree_from_numpy(host["layers"],
                                                         "cpu"), 1040)
    xs = xb.reshape(2, 520, 1024)
    want = jax.jit(lambda v: jst.stacked_dense_mlp(jm, v, 0))(xs)
    got = tst.stacked_dense_mlp(tmm, torch.from_numpy(x).to(
        torch.bfloat16).reshape(2, 520, 1024), 0)
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    # a last-bit difference in silu(g) * u can move one act-quant step
    assert np.linalg.norm(g - w) / np.linalg.norm(w) < 1e-2
    assert np.mean(g == w) > 0.9
    # eligibility: under 1024 rows, or with LoRA, the default path runs
    assert tst.stack_attn_for_w8a8(convert.tree_from_numpy(
        host["layers"], "cpu"), 1000) is None


@pytest.mark.parametrize("knob", ["MEDPLIB_STACK_ATTN", "MEDPLIB_STACK_MLP"])
def test_stack_knobs_in_forward(knob, monkeypatch):
    """llama.forward under dynamic_act_quant with the knob set: each layer
    runs K3 (plain here) with its layer id, and the hidden state follows
    JAX's forward with the same knob (norm-relative 2e-2: W8A8 act-quant
    flips); with the knob unset the default W8A8 path runs (no K3)."""
    from medplib_tpu_torch.ops.cuda import gmm as G
    cfg, jp, host = _llama()
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(2, 520, 1024)).astype(np.float32)
    calls = []
    real = G.gmm_plain

    def counting(*a, **k):
        calls.append(int(a[2][0]))
        return real(*a, **k)

    monkeypatch.setattr(G, "gmm_plain", counting)
    tp = convert.tree_from_numpy(host, "cpu")
    with dynamic_act_quant(True):
        base, _, _ = tllama.forward(tp, port_cfg(cfg), torch.from_numpy(emb))
    assert calls == []
    monkeypatch.setenv(knob, "1")
    with dynamic_act_quant(True):
        got, _, _ = tllama.forward(tp, port_cfg(cfg), torch.from_numpy(emb))
    per = 4 if knob == "MEDPLIB_STACK_ATTN" else 3
    assert calls == [i for i in range(2) for _ in range(per)]
    with jq.dynamic_act_quant(True):
        want, _, _ = jax.jit(lambda p, e: jllama.forward(p, cfg, e))(
            jp, jnp.asarray(emb))
    w = np.asarray(want, np.float32)
    for out in (got, base):
        g = out.float().numpy()
        assert np.linalg.norm(g - w) / np.linalg.norm(w) < 2e-2


@pytest.mark.parametrize("bits", [None, 4])
def test_ragged_dispatch_matches_jax(bits):
    """moe_mlp(dispatch_mode="ragged") against JAX's (float experts 1e-5;
    int4h experts, dequantized per layer: 1e-4), and equal to the capacity
    dispatch when capacity >= S."""
    rng = np.random.default_rng(2)
    e, h, m = 4, 128, 256
    p = {"router": {"kernel": rng.normal(size=(h, e)).astype(np.float32)},
         "experts": {
             "gate_proj": {"kernel": rng.normal(
                 size=(e, h, m)).astype(np.float32) * h ** -0.5},
             "up_proj": {"kernel": rng.normal(
                 size=(e, h, m)).astype(np.float32) * h ** -0.5},
             "down_proj": {"kernel": rng.normal(
                 size=(e, m, h)).astype(np.float32) * m ** -0.5}}}
    if bits:
        p["experts"] = jax.tree_util.tree_map(np.asarray, jq.quantize_tree(
            jax.tree_util.tree_map(jnp.asarray, p["experts"]), skip=(),
            bits=4, int4_groups=2))
    x = rng.normal(size=(2, 37, h)).astype(np.float32)
    mcfg = jc.MoeConfig(enable=True, num_experts=e, top_k=1,
                        eval_capacity_factor=float(e))
    jpar = jax.tree_util.tree_map(jnp.asarray, p)
    want, aux_j = jax.jit(lambda q, v: jmoe.moe_mlp(
        q, v, mcfg, train=False, dispatch_mode="ragged"))(jpar, jnp.asarray(x))
    tpar = convert.tree_from_numpy(p, "cpu")
    got, aux_t = tmoe.moe_mlp(tpar, torch.from_numpy(x), port_cfg(mcfg),
                              train=False, dispatch_mode="ragged")
    tol = 1e-5 if bits is None else 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    srt, _ = tmoe.moe_mlp(tpar, torch.from_numpy(x), port_cfg(mcfg),
                          train=False, dispatch_mode="sort")
    np.testing.assert_allclose(got.numpy(), srt.numpy(), rtol=tol, atol=tol)


SIZES = [(300, 500), (640, 480), (256, 256), (123, 77), (40, 513)]


@pytest.mark.parametrize("hw", SIZES)
def test_device_preprocess_matches_jax_and_host(hw):
    rng = np.random.default_rng(hw[0])
    img = rng.integers(0, 256, size=hw + (3,), dtype=np.uint8)
    sam_t, clip_t, rhw = tdev.dual_preprocess(img, device="cpu")
    sam_j, clip_j, rhw_j = jdev.dual_preprocess(img)
    assert rhw == tuple(rhw_j)
    np.testing.assert_allclose(sam_t.numpy(), np.asarray(sam_j), atol=2e-4)
    np.testing.assert_allclose(clip_t.numpy(), np.asarray(clip_j), atol=2e-4)
    sam_h, rhw_h = tpp.preprocess_sam(img)
    clip_h = tpp.preprocess_clip(img)
    assert rhw == tuple(rhw_h)
    d_sam = np.abs(sam_t.numpy() - sam_h) * tpp.SAM_PIXEL_STD
    d_clip = np.abs(clip_t.numpy() - clip_h) * tpp.CLIP_STD * 255.0
    assert d_sam.max() <= 2.0 and d_clip.max() <= 2.0
    assert tdev.pick_bucket(*hw) == jdev.pick_bucket(*hw)


@pytest.mark.parametrize("hw", SIZES)
def test_native_matches_jax_and_numpy(hw, monkeypatch):
    """The port's build of its copy of preprocess.cpp against the JAX
    package's library (equal) and the port's numpy resampler (1/255)."""
    assert native.available()
    assert native.library_path().parent.name == "medplib_tpu_torch"
    rng = np.random.default_rng(hw[1])
    img = rng.integers(0, 256, size=hw + (3,), dtype=np.uint8)
    sam_n, rhw_n = tpp.preprocess_sam(img)
    clip_n = tpp.preprocess_clip(img)
    assert tpp._native() is native
    sam_j, rhw_j = jpp.preprocess_sam(img)
    np.testing.assert_allclose(sam_n, sam_j, atol=1e-5)
    np.testing.assert_allclose(clip_n, jpp.preprocess_clip(img), atol=1e-5)
    assert tuple(rhw_n) == tuple(rhw_j)
    monkeypatch.setattr(tpp, "USE_NATIVE", False)
    sam_p, rhw_p = tpp.preprocess_sam(img)
    clip_p = tpp.preprocess_clip(img)
    assert tuple(rhw_p) == tuple(rhw_n)
    assert (np.abs(sam_p - sam_n) * tpp.SAM_PIXEL_STD).max() <= 1.0
    assert (np.abs(clip_p - clip_n) * tpp.CLIP_STD * 255).max() <= 1.0
    m = (rng.uniform(size=hw) > 0.7).astype(np.uint8)
    np.testing.assert_array_equal(native.encode_sparse_mask(m),
                                  np.argwhere(m > 0).astype(np.int32))
