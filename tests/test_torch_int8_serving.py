"""The int8-expert serving slice of medplib_tpu_torch against the JAX
package on the CPU: the int8 KV cache (quantize_kv, decode_attention_quant)
and `generate` over int8 experts, with the int8 cache under W8A8 prefill,
and over the in-context (ICL) input of three images per row.

The tiny model has the flagship's structure at H = M = 1024 (2 layers x 2
int8 experts, head_dim 64; tiny CLIP and SAM): multiples of 1024, so the
JAX gates stream the int8 stacks through the whole-stack grouped matmul
with no padding copy, and the port takes the matching gmm dispatch (its
K3 wrapper runs the plain version on the CPU). JAX params are made in
float32, quantized with quantize_flagship_moe(expert_bits=8, attn_bits=8)
and bridged leaf for leaf; the JAX generate runs under jax.jit (the port
follows the compiled numerics).

Tolerances as tests/test_torch_slice.py: greedy tokens, has_seg and
seg_valid equal, masks within rel 2e-2 (W8A8 turns last-bit float
differences into occasional one-step act-quant flips; the embedding table
is scaled to unit size so they cannot swing a greedy choice).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import medplib_tpu.config as jc
from medplib_tpu.models import medplib as jm
from medplib_tpu.ops import attention as jatt
from medplib_tpu.utils import quantize as jq
import medplib_tpu_torch.config as tc
from medplib_tpu_torch.models import medplib as tm
from medplib_tpu_torch.ops import attention as tatt
from medplib_tpu_torch.ops.cuda import gmm as tg
from medplib_tpu_torch.utils import convert
from medplib_tpu_torch.utils.quantize import dynamic_act_quant

torch.set_num_threads(1)
MAX_NEW = 4


def _t(a):
    return torch.from_numpy(np.array(a))


def port_cfg(c):
    """A medplib_tpu config -> the port's class of the same name."""
    if dataclasses.is_dataclass(c):
        return getattr(tc, type(c).__name__)(
            **{f.name: port_cfg(getattr(c, f.name))
               for f in dataclasses.fields(c)})
    return c


def _torch_batch(batch):
    return tm.Batch(**{
        k: torch.from_numpy(np.array(getattr(batch, k)))
        for k in ("input_ids", "input_mask", "labels", "images_clip",
                  "images_sam", "image_token_lengths")})


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# the int8 KV cache ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_kv_bit_equal_to_compiled_reference(dtype):
    """Per-token-per-head int8 quant: the 1e-6 floor (a zero row), the
    scale max(absmax, 1e-6) * f32(1/127), x / scale rounded half to even:
    values and scales bit-equal to the jitted JAX function."""
    x = np.random.default_rng(0).normal(size=(3, 17, 4, 64)).astype(
        np.float32)
    x[1, 5, 2] = 0.0
    x[0, :, 0, 7] *= 40.0            # one large channel per row
    xj = jnp.asarray(x)
    xt = _t(x)
    if dtype == "bfloat16":
        xj, xt = xj.astype(jnp.bfloat16), xt.to(torch.bfloat16)
    qj, sj = jax.jit(jatt.quantize_kv)(xj)
    qt, st = tatt.quantize_kv(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       ("bfloat16", 4e-3)])
def test_decode_attention_quant_matches_reference(dtype, tol):
    """One decode step over an int8 cache with GQA (8 heads over 4 KV
    heads), ragged valid lengths and a garbage tail past them. f32: the
    same f32 math summed in another order (1e-5); bf16 q: bf16 output,
    rel 4e-3."""
    rng = np.random.default_rng(1)
    b, mx, h, kv, d = 3, 12, 8, 4, 32
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    kc = rng.normal(size=(b, mx, kv, d)).astype(np.float32)
    vc = rng.normal(size=(b, mx, kv, d)).astype(np.float32)
    kq, ks = jax.jit(jatt.quantize_kv)(jnp.asarray(kc))
    vq, vs = jax.jit(jatt.quantize_kv)(jnp.asarray(vc))
    lens = np.array([12, 5, 1], np.int32)
    qj, qt = jnp.asarray(q), _t(q)
    if dtype == "bfloat16":
        qj, qt = qj.astype(jnp.bfloat16), qt.to(torch.bfloat16)
    want = jax.jit(jatt.decode_attention_quant)(qj, kq, ks, vq, vs,
                                                jnp.asarray(lens))
    got = tatt.decode_attention_quant(qt, _t(kq), _t(ks), _t(vq), _t(vs),
                                      _t(lens))
    assert got.dtype == qt.dtype and got.shape == (b, 1, h, d)
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) < tol


# ---------------------------------------------------------------------------
# generate over int8 experts
# ---------------------------------------------------------------------------

def build_model():
    llm = jc.LlamaConfig(vocab_size=512, hidden_size=1024,
                         intermediate_size=1024, num_layers=2, num_heads=16,
                         num_kv_heads=16, head_dim=64,
                         max_position_embeddings=512)
    cfg = jc.MedplibConfig.tiny(
        llm=llm,
        projector=jc.ProjectorConfig(mm_hidden_size=64, hidden_size=1024),
        moe=jc.MoeConfig(enable=True, num_experts=2, top_k=1,
                         capacity_factor=1.5, eval_capacity_factor=2.0))
    p = jm.init_medplib(jax.random.PRNGKey(0), cfg)
    emb = p["llm"]["embed_tokens"]["embedding"]
    p["llm"]["embed_tokens"]["embedding"] = emb * 50.0
    p = jq.quantize_flagship_moe(p, expert_bits=8, attn_bits=8)
    assert p["llm"]["layers"]["moe"]["experts"]["down_proj"]["kernel"] \
        .dtype == jnp.int8
    host = jax.tree_util.tree_map(np.asarray, p)
    return cfg, p, convert.tree_from_numpy(host, device="cpu")


@pytest.fixture(scope="module")
def model():
    return build_model()


def icl_batch(cfg, b, t, rng):
    """benchmarks/run_all.py bench_icl's batch: three image sentinels per
    row (query + 2 in-context examples) at 2, 4, 6 and <SEG> at T-3."""
    n_img = 3
    ids = rng.integers(3, min(cfg.llm.vocab_size, cfg.seg_token_idx),
                       size=(b, t))
    ids[:, 0] = 1
    for k in range(n_img):
        ids[:, 2 + 2 * k] = jc.IMAGE_TOKEN_INDEX
    ids[:, t - 3] = cfg.seg_token_idx
    vs, ss = cfg.vision.image_size, cfg.sam.image_size
    return jm.Batch.make(
        input_ids=jnp.asarray(ids), input_mask=jnp.ones((b, t), jnp.int32),
        labels=jnp.asarray(ids),
        images_clip=jnp.asarray(rng.normal(
            size=(b, n_img, vs, vs, 3)).astype(np.float32)),
        images_sam=jnp.asarray(rng.uniform(
            0, 255, size=(b, ss, ss, 3)).astype(np.float32)),
        image_token_lengths=jnp.full((b, n_img), cfg.vision.num_patches,
                                     jnp.int32),
        sam_frame=ss)


def _count_k3(monkeypatch):
    calls = [0]
    plain = tg.gmm_plain

    def counted(*a, **k):
        calls[0] += 1
        return plain(*a, **k)

    monkeypatch.setattr(tg, "gmm_plain", counted)
    return calls


def _compare(got, want, b):
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
    assert _rel(pm, wm) < 2e-2


def test_int8_expert_generate_with_int8_kv_cache(model, monkeypatch):
    """B=16, T_in=64 (16 x 79 = 1264 spliced tokens): W8A8 prefill through
    the whole-stack int8 gmm (3 grouped matmuls per layer), the int8 KV
    cache written at prefill and at every decode step, decode over the
    sort path (int8 experts keep it, as in JAX)."""
    cfg, jp, tp = model
    b = 16
    batch = ge._make_batch(cfg, b, 64, np.random.default_rng(0))
    with jq.dynamic_act_quant(True):
        want = jax.jit(lambda p, bb: jm.generate(
            p, cfg, bb, max_new_tokens=MAX_NEW, kv_quant=True))(jp, batch)
    calls = _count_k3(monkeypatch)
    with dynamic_act_quant(True):
        got = tm.generate(tp, port_cfg(cfg), _torch_batch(batch),
                          max_new_tokens=MAX_NEW, kv_quant=True)
    assert calls[0] == 3 * cfg.llm.num_layers
    _compare(got, want, b)


def test_icl_three_image_generate(model, monkeypatch):
    """The ICL config (bench_icl): icl_enable, three images per row, no
    activation quant, bf16 KV cache. B=16, T_in=24: 16 x (24 + 3 x 15) =
    1104 spliced tokens, so prefill takes the int8 gmm in weight-only
    mode."""
    cfg, jp, tp = model
    cfg = dataclasses.replace(cfg, icl_enable=True)
    b = 16
    batch = icl_batch(cfg, b, 24, np.random.default_rng(2))
    want = jax.jit(lambda p, bb: jm.generate(
        p, cfg, bb, max_new_tokens=MAX_NEW))(jp, batch)
    calls = _count_k3(monkeypatch)
    tb = _torch_batch(batch)
    assert tuple(tb.images_clip.shape[:2]) == (b, 3)
    got = tm.generate(tp, port_cfg(cfg), tb, max_new_tokens=MAX_NEW)
    assert calls[0] == 3 * cfg.llm.num_layers
    _compare(got, want, b)


def test_icl_splice_places_three_images(model):
    """The spliced embeddings of a 3-image row: each image's projected
    features land at its own sentinel, in order, as in JAX."""
    from medplib_tpu.models import medplib as jmed
    cfg, jp, tp = model
    cfg = dataclasses.replace(cfg, icl_enable=True)
    batch = icl_batch(cfg, 2, 24, np.random.default_rng(3))
    ej, _, mj, _, _ = jax.jit(lambda p, bb: jmed.splice_batch(
        p, cfg, bb, need_region=False))(jp, batch)
    et, _, mt, _, _ = tm.splice_batch(tp, port_cfg(cfg), _torch_batch(batch))
    assert et.shape == ej.shape == (2, 24 + 3 * (cfg.vision.num_patches - 1),
                                    cfg.llm.hidden_size)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-4,
                               atol=1e-4)
