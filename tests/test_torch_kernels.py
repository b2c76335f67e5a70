"""The port's kernel modules (medplib_tpu_torch/ops/cuda) against the JAX
Pallas kernels they replace, on the CPU: there the port's wrappers run
their plain PyTorch versions, and the Pallas kernels run in interpret mode
as the JAX package's own tests run them. Inputs are made with numpy from a
seed and handed to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medplib_tpu.ops.pallas import gmm as jg
from medplib_tpu.ops.pallas import moe_decode as jd
from medplib_tpu.utils.quantize import _quantize_kernel4h
from medplib_tpu_torch.ops.cuda import gmm as tg
from medplib_tpu_torch.ops.cuda import moe_decode as td

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _int4h(rng, e, k, n, lead=()):
    w = rng.normal(size=tuple(lead) + (e, k, n)).astype(np.float32)
    p, s = _quantize_kernel4h(jnp.asarray(w * k ** -0.5), False, 2)
    return np.asarray(p), np.asarray(s)


def _ulp_close(got, want):
    """Elementwise within one bf16 ulp (|d| <= 2^-7 |want|)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return bool(np.all(np.abs(got - want) <= np.abs(want) * 2.0 ** -7))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_quantize_rows_matches_compiled_reference():
    """Per-row int8 activation quant is bit-equal to the compiled JAX
    function (scale = amax * f32(1/127), round half to even)."""
    x = np.random.default_rng(0).normal(size=(64, 256)).astype(np.float32)
    x[3] = 0.0                                   # the 1e-12 floor
    qj, sj = jax.jit(jg.quantize_rows)(jnp.asarray(x))
    qt, st = tg.quantize_rows(_t(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("num_experts,s,bm", [(2, 300, 128), (2, 256, 128),
                                              (4, 300, 64)])
def test_align_groups_matches_reference(num_experts, s, bm):
    """Group-aligned layout, incl. the two-ended E=2 packing (one gap
    tile) and the general layout: equal buffers, destinations, tile ids."""
    rng = np.random.default_rng(s + num_experts)
    x = rng.normal(size=(s, 32)).astype(np.float32)
    idx = rng.integers(0, num_experts, size=s).astype(np.int32)
    xa, dest, gid = jg.align_groups(jnp.asarray(x), jnp.asarray(idx),
                                    num_experts, bm)
    ta, tdest, tgid = tg.align_groups(_t(x), _t(idx), num_experts, bm)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(xa))
    np.testing.assert_array_equal(tdest.numpy(), np.asarray(dest))
    np.testing.assert_array_equal(tgid.numpy(), np.asarray(gid))


def test_unpack_pairs_matches_reference():
    p = np.random.default_rng(1).integers(-128, 128, size=(16, 8)).astype(
        np.int8)
    want = np.asarray(jg.unpack_pairs(jnp.asarray(p), interpret=True))
    np.testing.assert_array_equal(tg.unpack_pairs(_t(p)).numpy(), want)


# (K, N): one K block; K/2 > 2048 packed rows (several K blocks per scale
# group in the Pallas kernel)
@pytest.mark.parametrize("k,n", [(512, 256), (4608, 128)])
@pytest.mark.parametrize("mode", ["a8", "float"])
def test_gmm_int4h_matches_pallas(k, n, mode):
    """K1 over a two-ended aligned buffer (tile ids 0, gap, 1).
    A8: the int32 half sums are exact on both sides and the epilogue is
    the same f32 op sequence -> within one bf16 ulp elementwise.
    float: bf16-rounded x, f32 sums in another order -> rel 1e-5."""
    rng = np.random.default_rng(k + n)
    packed, scale = _int4h(rng, 2, k, n)
    s, bm = 200, 64
    x = rng.normal(size=(s, k)).astype(np.float32)
    idx = rng.integers(0, 2, size=s).astype(np.int32)
    xa, _, gid = jg.align_groups(jnp.asarray(x), jnp.asarray(idx), 2, bm)
    assert set(np.asarray(gid).tolist()) == {0, 1}
    if mode == "a8":
        xq, xs = jax.jit(jg.quantize_rows)(xa)
        want = jg.gmm_int4h(xq, jnp.asarray(packed), jnp.asarray(scale), gid,
                            a_scale=xs, block_m=bm, block_n=128)
        got = tg.gmm_int4h(_t(xq), _t(packed), _t(scale), _t(gid), _t(xs),
                           block_m=bm)
        assert got.dtype == torch.bfloat16
        assert _ulp_close(got.float().numpy(),
                          np.asarray(want).astype(np.float32))
    else:
        want = jg.gmm_int4h(xa, jnp.asarray(packed), jnp.asarray(scale), gid,
                            block_m=bm, block_n=128)
        got = tg.gmm_int4h(_t(xa), _t(packed), _t(scale), _t(gid),
                           block_m=bm)
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), want) < 1e-5


def _stacked_experts(rng, layers, e, h, m):
    out = {}
    for name, (k, n) in (("gate_proj", (h, m)), ("up_proj", (h, m)),
                         ("down_proj", (m, h))):
        p, s = _int4h(rng, e, k, n, (layers,))
        out[name] = {"kernel": p.reshape((layers * e,) + p.shape[2:]),
                     "scale4h": s.reshape((layers * e,) + s.shape[2:])}
    return out


# (B, layer): a non-16-multiple batch (row padding) and a layer offset
@pytest.mark.parametrize("b,layer", [(8, 0), (3, 1)])
@pytest.mark.parametrize("int8_x", [True, False])
def test_moe_decode_matches_pallas(b, layer, int8_x):
    """K2 against the fused Pallas decode kernel. The JAX kernel addresses
    the whole [L*E] stack with gid_offset = layer*E; the port takes that
    layer's [E] view. The op order matches, but the two exp()s may differ
    in the last bit, which can flip a rare act-quant (A8) or bf16
    rounding of the activation by one step: rel Frobenius 1e-3."""
    rng = np.random.default_rng(10 * b + layer)
    e, h, m = 2, 512, 1536                      # bn = 384: 2 x 2 blocks
    st = _stacked_experts(rng, 2, e, h, m)
    x = (rng.normal(size=(b, h)) * 0.5).astype(np.float32)
    idx = rng.integers(0, e, size=b).astype(np.int32)
    gate = rng.uniform(0.5, 1.0, size=b).astype(np.float32)
    jst = jax.tree_util.tree_map(jnp.asarray, st)
    assert jd.fused_decode_eligible(jst, e)
    want = jd.moe_ffn_decode_int4h(jnp.asarray(x), jst, jnp.asarray(idx),
                                   jnp.asarray(gate), layer * e, e,
                                   int8_x=int8_x)
    view = {n: {k: _t(v[layer * e:(layer + 1) * e]) for k, v in node.items()}
            for n, node in st.items()}
    assert td.fused_decode_eligible(view, e)
    got = td.moe_ffn_decode_int4h(_t(x), view, _t(idx), _t(gate), e,
                                  int8_x=int8_x)
    assert got.shape == (b, h) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 1e-3


def test_pick_bn_and_eligibility_match_reference():
    for m2 in (512, 768, 5632, 5504, 100):
        assert td._pick_bn(m2) == jd._pick_bn(m2)
    bad = {"gate_proj": {"kernel": torch.zeros((2, 64, 100), dtype=torch.int8),
                         "scale4h": torch.zeros((2, 2, 1, 100))}}
    assert not td.fused_decode_eligible(bad, 2)
