"""The ported slice end to end: medplib_tpu_torch.models.medplib.generate
against medplib_tpu.models.medplib.generate on the same params and batch.

A small MoE model with the flagship's structure: LLaMA H=512, M=1024
(already a multiple of 1024, so the expert pad is a no-op), 2 layers x 2
experts, head_dim 64; tiny CLIP and SAM. JAX params are made in float32,
quantized with quantize_flagship_moe(expert_bits=4, attn_bits=8) and
bridged leaf for leaf. Under dynamic_act_quant both sides run W8A8 / W4A8
prefill.

- B=16, T_in=64: 16 x 79 = 1264 spliced tokens >= 1024, so prefill takes
  the whole-stack grouped matmul (K1) and decode the fused kernel (K2).
- B=2: prefill takes the capacity-sort path; decode still takes K2.

Tolerances: greedy tokens, has_seg and seg_valid equal; masks within rel
2e-2. At B=16 the W8A8 / W4A8 prefill turns last-bit float differences
(e.g. in a norm's sum) into occasional one-step act-quant rounding flips,
which move the SEG hidden state and so the mask logits by about a percent
(B=2 stays below 512 rows, so its linears are weight-only and agree to
1e-6). A flip can also tip a near-tied router choice at one token; the
seeded batch here has no such tie at a SEG position (other seeds can, and
then that one row's mask differs by tens of percent). The embedding table
is scaled to unit size so that the residual stream is well conditioned and
flips cannot swing a greedy choice between near-tied random logits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import medplib_tpu.config as jc
import medplib_tpu_torch.config as tc
from medplib_tpu.models import medplib as jm
from medplib_tpu.utils import quantize as jq
from medplib_tpu_torch.models import medplib as tm
from medplib_tpu_torch.ops.cuda.gmm import gmm_int4h
from medplib_tpu_torch.ops.cuda.moe_decode import moe_ffn_decode_int4h
from medplib_tpu_torch.utils import convert
from medplib_tpu_torch.utils.quantize import dynamic_act_quant

torch.set_num_threads(1)
MAX_NEW = 4


def port_cfg(c):
    if dataclasses.is_dataclass(c):
        return getattr(tc, type(c).__name__)(
            **{f.name: port_cfg(getattr(c, f.name))
               for f in dataclasses.fields(c)})
    return c


def build_model():
    llm = jc.LlamaConfig(vocab_size=512, hidden_size=512,
                         intermediate_size=1024, num_layers=2, num_heads=8,
                         num_kv_heads=8, head_dim=64,
                         max_position_embeddings=512)
    cfg = jc.MedplibConfig.tiny(
        llm=llm,
        projector=jc.ProjectorConfig(mm_hidden_size=64, hidden_size=512),
        moe=jc.MoeConfig(enable=True, num_experts=2, top_k=1,
                         capacity_factor=1.5, eval_capacity_factor=2.0))
    p = jm.init_medplib(jax.random.PRNGKey(0), cfg)
    emb = p["llm"]["embed_tokens"]["embedding"]
    p["llm"]["embed_tokens"]["embedding"] = emb * 50.0
    p = jq.quantize_flagship_moe(p, expert_bits=4, attn_bits=8)
    host = jax.tree_util.tree_map(np.asarray, p)
    return cfg, p, convert.tree_from_numpy(host, device="cpu")


@pytest.fixture(scope="module")
def model():
    return build_model()


def _torch_batch(batch):
    return tm.Batch(**{
        k: torch.from_numpy(np.array(getattr(batch, k)))
        for k in ("input_ids", "input_mask", "labels", "images_clip",
                  "images_sam", "image_token_lengths")})


@pytest.mark.parametrize("b", [16, 2])
def test_generate_matches_reference(model, b):
    cfg, jp, tp = model
    batch = ge._make_batch(cfg, b, 64, np.random.default_rng(0))
    with jq.dynamic_act_quant(True):
        want = jax.jit(lambda p, bb: jm.generate(
            p, cfg, bb, max_new_tokens=MAX_NEW))(jp, batch)
    k1, k2 = gmm_int4h.launches, moe_ffn_decode_int4h.launches
    with dynamic_act_quant(True):
        got = tm.generate(tp, port_cfg(cfg), _torch_batch(batch),
                          max_new_tokens=MAX_NEW)
    # on the CPU the wrappers run their plain versions: no launches
    assert (gmm_int4h.launches, moe_ffn_decode_int4h.launches) == (k1, k2)
    np.testing.assert_array_equal(got.output_ids.numpy(),
                                  np.asarray(want.output_ids))
    np.testing.assert_array_equal(got.num_generated.numpy(),
                                  np.asarray(want.num_generated))
    np.testing.assert_array_equal(got.has_seg.numpy(),
                                  np.asarray(want.has_seg))
    np.testing.assert_array_equal(got.seg_valid.numpy(),
                                  np.asarray(want.seg_valid))
    pm, wm = got.pred_masks.numpy(), np.asarray(want.pred_masks)
    assert pm.shape == wm.shape == (b, 1, 64, 64)
    assert np.linalg.norm(pm - wm) / np.linalg.norm(wm) < 2e-2


def test_generate_takes_the_kernel_paths(model, monkeypatch):
    """Which dispatch each phase takes, counted through the kernel
    modules' entry points (the plain versions run on the CPU)."""
    from medplib_tpu_torch.ops.cuda import gmm as G
    from medplib_tpu_torch.ops.cuda import moe_decode as D
    cfg, _, tp = model
    calls = {"k1": 0, "k2": 0}
    k1_plain, k2_plain = G.gmm_int4h_plain, D.moe_ffn_decode_int4h_plain

    def count_k1(*a, **k):
        calls["k1"] += 1
        return k1_plain(*a, **k)

    def count_k2(*a, **k):
        calls["k2"] += 1
        return k2_plain(*a, **k)

    monkeypatch.setattr(G, "gmm_int4h_plain", count_k1)
    monkeypatch.setattr(D, "moe_ffn_decode_int4h_plain", count_k2)
    pc = port_cfg(cfg)
    for b, want in ((16, (3 * 2, 2 * MAX_NEW)), (2, (0, 2 * MAX_NEW))):
        calls.update(k1=0, k2=0)
        batch = ge._make_batch(cfg, b, 64, np.random.default_rng(0))
        with dynamic_act_quant(True):
            tm.generate(tp, pc, _torch_batch(batch), max_new_tokens=MAX_NEW)
        assert (calls["k1"], calls["k2"]) == want, (b, calls)
