"""Packed dense serving in medplib_tpu_torch against the JAX package on the
CPU: `llama.pack_inference` (fused `qkv_proj` / `gateup_proj` kernels),
`lora.merge` (the route from a LoRA checkpoint to a packed tree), and
`generate` over a packed dense tree in bf16, in int8 under W8A8 prefill
(the packed kernels on K7, `o_proj` / `down_proj` on W8A8) and in int4h
(the packed kernels on K9, the other linears on the grouped int4h
products).

The tiny model is a dense LLaMA at H = 256 (2 layers, 4 heads of 64,
M = 512) with tiny CLIP and SAM; its embedding table is scaled to unit
size so that last-bit float differences cannot swing a greedy token. JAX
params are made in float32, packed and quantized by the JAX package and
bridged leaf for leaf; the JAX generate runs under jax.jit (the port
follows the compiled numerics), with the Pallas kernels in interpret mode.

Tolerances: greedy tokens, has_seg and seg_valid equal. Masks: int4h
within rel 1e-3 (f32 sums in another order); int8 under W8A8 within rel
2e-2 (W8A8 turns last-bit float differences into occasional one-step
act-quant flips, as in tests/test_torch_int8_serving.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import medplib_tpu.config as jc
from medplib_tpu.models import llama as jll
from medplib_tpu.models import medplib as jm
from medplib_tpu.train import lora as jl
from medplib_tpu.utils import quantize as jq
import medplib_tpu_torch.config as tc
from medplib_tpu_torch.models import llama as tll
from medplib_tpu_torch.models import medplib as tm
from medplib_tpu_torch.ops.cuda import int4_matmul as t4
from medplib_tpu_torch.ops.cuda import int8_matmul as t8
from medplib_tpu_torch.train import lora as tl
from medplib_tpu_torch.utils import convert
from medplib_tpu_torch.utils import quantize as tq
from medplib_tpu_torch.utils import tree as tree_util

torch.set_num_threads(1)
MAX_NEW = 4


def port_cfg(c):
    """A medplib_tpu config -> the port's class of the same name."""
    if dataclasses.is_dataclass(c):
        return getattr(tc, type(c).__name__)(
            **{f.name: port_cfg(getattr(c, f.name))
               for f in dataclasses.fields(c)})
    return c


def _host(tree):
    """A copy of a JAX tree on the host (the JAX packer and quantizers
    donate their inputs)."""
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _torch_batch(batch):
    return tm.Batch(**{
        k: torch.from_numpy(np.array(getattr(batch, k)))
        for k in ("input_ids", "input_mask", "labels", "images_clip",
                  "images_sam", "image_token_lengths")})


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _assert_same_leaves(got, want):
    """Torch tree vs numpy tree: the same key paths, dtypes, values."""
    gl = tree_util.leaves_with_paths(got)
    wl = tree_util.leaves_with_paths(convert.tree_from_numpy(want, "cpu"))
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(g, w), path


def tiny_cfg():
    llm = jc.LlamaConfig(vocab_size=512, hidden_size=256,
                         intermediate_size=512, num_layers=2, num_heads=4,
                         num_kv_heads=4, head_dim=64,
                         max_position_embeddings=512)
    return jc.MedplibConfig.tiny(
        llm=llm, projector=jc.ProjectorConfig(mm_hidden_size=64,
                                              hidden_size=256))


def init_jax(cfg, dtype=jnp.float32):
    p = jm.init_medplib(jax.random.PRNGKey(0), cfg, dtype)
    emb = p["llm"]["embed_tokens"]["embedding"]
    p["llm"]["embed_tokens"]["embedding"] = emb * 50.0
    return p


# ---------------------------------------------------------------------------
# pack_inference and merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [None, 8, 4])
def test_pack_inference_leaf_for_leaf(bits):
    """The port's pack_inference (then quantize_tree) on the bridged float
    tree gives the JAX package's packed (quantized) tree leaf for leaf:
    qkv_proj [L, 3H, H] (transposed: int8 scale [L, 3H, 1], int4h
    [L, G, 3H, 1]), gateup_proj [L, H, 2M], the sources gone."""
    cfg = tiny_cfg()
    host = _host(init_jax(cfg)["llm"])
    want = jll.pack_inference(jax.tree_util.tree_map(jnp.asarray, host))
    got = tll.pack_inference(convert.tree_from_numpy(host, "cpu"))
    if bits:
        want = jq.quantize_tree(want, bits=bits)
        got = tq.quantize_tree(got, bits=bits)
    attn, mlp = got["layers"]["attn"], got["layers"]["mlp"]
    assert set(attn) == {"qkv_proj", "o_proj"}
    assert set(mlp) == {"gateup_proj", "down_proj"}
    h, m, L = 256, 512, 2
    packed_k = {None: 1, 8: 1, 4: 2}[bits]
    assert tuple(attn["qkv_proj"]["kernel"].shape) == (L, 3 * h,
                                                       h // packed_k)
    assert tuple(mlp["gateup_proj"]["kernel"].shape) == (L, h // packed_k,
                                                         2 * m)
    if bits == 8:
        assert tuple(attn["qkv_proj"]["scale"].shape) == (L, 3 * h, 1)
    if bits == 4:
        assert tuple(attn["qkv_proj"]["scale4h"].shape) == (L, 8, 3 * h, 1)
    _assert_same_leaves(got, _host(want))


def test_pack_inference_raises_like_the_reference():
    cfg = tiny_cfg()
    host = _host(init_jax(cfg)["llm"])
    lora_tree = tl.inject(torch.Generator().manual_seed(0),
                          convert.tree_from_numpy(host, "cpu"),
                          ("q_proj", "up_proj"), r=2)
    with pytest.raises(ValueError, match="merge LoRA"):
        tll.pack_inference(lora_tree)
    quant = tq.quantize_tree(convert.tree_from_numpy(host, "cpu"))
    with pytest.raises(ValueError, match="BEFORE"):
        tll.pack_inference(quant)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_lora_merge_matches_reference(dtype):
    """LoRA on q/v (transposed kernels) and gate/up with random lora_b:
    the port's merge equals the JAX merge leaf for leaf, and the merged
    tree packs. Merging into a quantized node raises."""
    cfg = tiny_cfg()
    llm = jll.init_llama(jax.random.PRNGKey(1), cfg.llm, dtype)
    llm = jl.inject(jax.random.PRNGKey(2), llm,
                    ("q_proj", "v_proj", "gate_proj", "up_proj"), r=4)
    rng = np.random.default_rng(3)
    for _, node in jl._iter_linear_paths(llm):
        if "lora_b" in node:
            node["lora_b"] = jnp.asarray(rng.normal(
                size=node["lora_b"].shape).astype(np.float32) * 0.1
            ).astype(node["lora_b"].dtype)
    host = _host(llm)
    want = _host(jl.merge(jax.tree_util.tree_map(jnp.asarray, host)))
    got = tl.merge(convert.tree_from_numpy(host, "cpu"))
    _assert_same_leaves(got, want)
    tll.pack_inference(got)
    quant = tq.quantize_tree(convert.tree_from_numpy(host, "cpu"))
    with pytest.raises(ValueError, match="QUANTIZED"):
        tl.merge(quant)


# ---------------------------------------------------------------------------
# generate over packed dense trees
# ---------------------------------------------------------------------------

def test_bf16_packed_generate_equals_unpacked():
    """The port's counterpart of tests/test_regressions.py's packing test,
    in bf16: a packed tree gives the unpacked tree's tokens, masks within
    atol 2e-3."""
    cfg = port_cfg(tiny_cfg())
    params = tm.init_medplib(torch.Generator().manual_seed(0), cfg,
                             torch.bfloat16, "cpu")
    params["llm"]["embed_tokens"]["embedding"] *= 50.0
    batch = _torch_batch(ge._make_batch(tiny_cfg(), B=2, T=12,
                                        rng=np.random.default_rng(0)))
    base = tm.generate(params, cfg, batch, max_new_tokens=MAX_NEW)
    packed = dict(params, llm=tll.pack_inference(params["llm"]))
    assert "qkv_proj" in packed["llm"]["layers"]["attn"]
    got = tm.generate(packed, cfg, batch, max_new_tokens=MAX_NEW)
    assert torch.equal(got.output_ids, base.output_ids)
    assert float((got.pred_masks.float() - base.pred_masks.float()).abs()
                 .max()) <= 2e-3


def _count(monkeypatch, mod, name):
    calls = [0]
    plain = getattr(mod, name)

    def counted(*a, **k):
        calls[0] += 1
        return plain(*a, **k)

    monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("bits", [8, 4])
def test_packed_quantized_generate_matches_reference(bits, monkeypatch):
    """B=8, T_in=64 (8 x 79 = 632 spliced tokens). int8: under W8A8, the
    packed qkv / gate-up kernels on K7 (weight-only, as in JAX) and
    o_proj / down_proj on W8A8; int4h: qkv / gate-up on K9, the other
    linears on the grouped int4h products. K7 / K9 run twice per layer
    per LLM pass (prefill + MAX_NEW decode steps)."""
    cfg = tiny_cfg()
    p = init_jax(cfg)
    p["llm"] = jll.pack_inference(p["llm"])
    p = jq.quantize_tree(p, bits=bits)
    tp = convert.tree_from_numpy(_host(p), "cpu")
    batch = ge._make_batch(cfg, 8, 64, np.random.default_rng(0))
    actq = bits == 8
    with jq.dynamic_act_quant(actq):
        want = jax.jit(lambda pp, bb: jm.generate(
            pp, cfg, bb, max_new_tokens=MAX_NEW))(p, batch)
    mod, name = (t8, "int8_matmul_plain") if bits == 8 else \
        (t4, "int4h_matmul_plain")
    calls = _count(monkeypatch, mod, name)
    with tq.dynamic_act_quant(actq):
        got = tm.generate(tp, port_cfg(cfg), _torch_batch(batch),
                          max_new_tokens=MAX_NEW)
    assert calls[0] == 2 * cfg.llm.num_layers * (1 + MAX_NEW)
    for f in ("output_ids", "num_generated", "has_seg", "seg_valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    pm, wm = got.pred_masks.numpy(), np.asarray(want.pred_masks)
    assert pm.shape == wm.shape == (8, 1, 64, 64)
    assert _rel(pm, wm) < (2e-2 if actq else 1e-3)
