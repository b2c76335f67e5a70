"""Kernel K3 (`gmm`: grouped matmul over float, int8-weight and W8A8
experts) and the int8 / float expert gmm dispatch, against the JAX package
on the CPU. There the port's `gmm` runs its plain PyTorch version and the
Pallas kernel runs in interpret mode, as the JAX package's own tests run
it. Inputs are made with numpy from a seed and handed to both.

Tolerances: W8A8 sums are exact integers on both sides and the epilogue
is the same rounded f32 ops -> within one bf16 ulp elementwise. f32
outputs (float f32, int8-w with f32 x) are f32 sums of the same products
in another order -> rel Frobenius 1e-5. bf16 outputs -> rel 4e-3 (a sum
that lands near a bf16 rounding boundary may round the other way)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medplib_tpu.config as jc
import medplib_tpu_torch.config as tc
from medplib_tpu.ops import moe as jmoe
from medplib_tpu.ops.pallas import gmm as jg
from medplib_tpu.utils import quantize as jq
from medplib_tpu_torch.ops import moe as tmoe
from medplib_tpu_torch.ops.cuda import gmm as tg
from medplib_tpu_torch.utils import convert
from medplib_tpu_torch.utils import quantize as tq

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _ulp_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return bool(np.all(np.abs(got - want) <= np.abs(want) * 2.0 ** -7))


def _operands(rng, mode, e, s, k, n, bm, transposed):
    """Aligned x (as the mode takes it), w, tile_gid, w_scale, a_scale."""
    x = rng.normal(size=(s, k)).astype(np.float32)
    idx = rng.integers(0, e, size=s).astype(np.int32)
    xa, _, gid = jg.align_groups(jnp.asarray(x), jnp.asarray(idx), e, bm)
    wshape = (e, n, k) if transposed else (e, k, n)
    ws = a_s = None
    if mode in ("w8a8", "int8w_bf16", "int8w_f32"):
        w = jnp.asarray(rng.integers(-127, 128, size=wshape).astype(np.int8))
        ws = jnp.asarray(rng.uniform(1e-3, 2e-2, size=(e, 1, n))
                         .astype(np.float32))
    else:
        w = jnp.asarray((rng.normal(size=wshape) * k ** -0.5)
                        .astype(np.float32))
        if mode == "float_bf16":
            w = w.astype(jnp.bfloat16)
    if mode == "w8a8":
        xa, a_s = jax.jit(jg.quantize_rows)(xa)
    elif mode in ("int8w_bf16", "float_bf16"):
        xa = xa.astype(jnp.bfloat16)
    return xa, w, gid, ws, a_s


def _check(mode, got, want):
    want = np.asarray(want.astype(jnp.float32))
    if mode == "w8a8":
        assert got.dtype == torch.bfloat16
        assert _ulp_close(got.float().numpy(), want)
    elif mode in ("int8w_f32", "float_f32"):
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), want) < 1e-5
    else:
        assert got.dtype == torch.bfloat16
        assert _rel(got.float().numpy(), want) < 4e-3


# (mode, E, K, N, transposed): every mode over the two-ended E=2 layout
# (tiles of group 0, a gap tile, group 1); the general E=4 layout; a K
# whose only 128-multiple divisor is 128 (like the unpadded 11008, the
# Pallas kernel zero-pads it to 3072); N not a multiple of 64; transposed
# weights
CASES = [
    ("w8a8", 2, 256, 192, False),
    ("int8w_bf16", 2, 256, 192, False),
    ("int8w_f32", 2, 256, 192, False),
    ("float_f32", 2, 256, 192, False),
    ("float_bf16", 2, 256, 192, False),
    ("w8a8", 4, 256, 128, False),
    ("int8w_bf16", 4, 256, 128, False),
    ("w8a8", 2, 2176, 128, False),
    ("float_f32", 2, 2176, 128, False),
    ("int8w_bf16", 2, 128, 208, False),
    ("w8a8", 2, 256, 192, True),
    ("int8w_bf16", 2, 256, 192, True),
    ("float_f32", 4, 256, 128, True),
]


@pytest.mark.parametrize("mode,e,k,n,transposed", CASES)
def test_gmm_matches_pallas(mode, e, k, n, transposed):
    rng = np.random.default_rng(k + n + e)
    bm = 64
    xa, w, gid, ws, a_s = _operands(rng, mode, e, 200, k, n, bm, transposed)
    if e == 2:
        assert set(np.asarray(gid).tolist()) == {0, 1}
    want = jg.gmm(xa, w, gid, ws, a_scale=a_s, block_m=bm, block_n=128,
                  transposed=transposed)
    n0 = tg.gmm.launches
    got = tg.gmm(_t(xa.astype(jnp.float32)).to(torch.bfloat16)
                 if xa.dtype == jnp.bfloat16 else _t(xa),
                 _t(w.astype(jnp.float32)).to(torch.bfloat16)
                 if w.dtype == jnp.bfloat16 else _t(w),
                 _t(gid), None if ws is None else _t(ws),
                 None if a_s is None else _t(a_s), block_m=bm,
                 transposed=transposed)
    assert tg.gmm.launches == n0            # CPU tensors: the plain version
    assert got.shape == (xa.shape[0], n)
    _check(mode, got, want)


def test_gmm_w8a8_is_bit_exact_at_large_sums():
    """K = 4096 with |x|, |w| near 127: the s32 sums exceed 2^24, where an
    f32 accumulation would round; the plain version (f64 sums) and the
    Pallas kernel (s32 sums) still agree bit for bit."""
    rng = np.random.default_rng(7)
    k, n, bm = 4096, 64, 64
    x = rng.integers(100, 128, size=(128, k)).astype(np.int8)
    w = rng.integers(100, 128, size=(2, k, n)).astype(np.int8)
    gid = np.array([0, 1], np.int32)
    ws = rng.uniform(1e-3, 2e-2, size=(2, 1, n)).astype(np.float32)
    a_s = rng.uniform(1e-3, 2e-2, size=(128, 1)).astype(np.float32)
    want = jg.gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gid),
                  jnp.asarray(ws), a_scale=jnp.asarray(a_s), block_m=bm)
    got = tg.gmm(_t(x), _t(w), _t(gid), _t(ws), _t(a_s), block_m=bm)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_gmm_out_dtype_and_ignored_tpu_knobs():
    """out_dtype overrides the default; block_n / block_k / allow_pad are
    the TPU kernel's tiling knobs and change nothing."""
    rng = np.random.default_rng(3)
    xa, w, gid, ws, _ = _operands(rng, "int8w_bf16", 2, 100, 256, 128, 64,
                                  False)
    x = _t(xa.astype(jnp.float32)).to(torch.bfloat16)
    base = tg.gmm(x, _t(w), _t(gid), _t(ws), block_m=64)
    knobs = tg.gmm(x, _t(w), _t(gid), _t(ws), block_m=64, block_n=1024,
                   block_k=128, allow_pad=False)
    assert torch.equal(base, knobs)
    f32 = tg.gmm(x, _t(w), _t(gid), _t(ws), block_m=64,
                 out_dtype=torch.float32)
    want = jg.gmm(xa, w, gid, ws, block_m=64, out_dtype=jnp.float32)
    assert f32.dtype == torch.float32 and _rel(f32.numpy(), want) < 1e-5


def test_gmm_rejects_bad_operands():
    x8 = torch.zeros((64, 32), dtype=torch.int8)
    gid = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(TypeError):          # W8A8 needs int8 weights
        tg.gmm(x8, torch.zeros((2, 32, 16)), gid, block_m=64)
    with pytest.raises(ValueError):         # w_scale must be channel-last
        tg.gmm(x8, torch.zeros((2, 16, 32), dtype=torch.int8), gid,
               torch.ones((2, 16, 1)), block_m=64, transposed=True)
    with pytest.raises(ValueError):         # one tile id per m-tile
        tg.gmm(x8, torch.zeros((2, 32, 16), dtype=torch.int8),
               torch.zeros((2,), dtype=torch.int32), block_m=64)


# ---------------------------------------------------------------------------
# the int8 / float expert gmm dispatch (ops/moe._gmm_ffn via moe_mlp)
# ---------------------------------------------------------------------------

E, H, M, L = 2, 128, 256, 2
MCFG = jc.MoeConfig(enable=True, num_experts=E, top_k=1)


def _experts(rng, bits):
    """[L, E, ...] float experts, int8-quantized when bits == 8, and a
    router per layer."""
    ex = {n: {"kernel": jnp.asarray((rng.normal(size=(L, E, k, m))
                                     * k ** -0.5).astype(np.float32))}
          for n, (k, m) in (("gate_proj", (H, M)), ("up_proj", (H, M)),
                            ("down_proj", (M, H)))}
    if bits == 8:
        ex = jq.quantize_tree(ex, skip=(), bits=8)
    router = jnp.asarray((rng.normal(size=(L, H, E)) * H ** -0.5)
                         .astype(np.float32))
    return jax.tree_util.tree_map(np.asarray, ex), np.asarray(router)


# (experts, act quant, stacked): int8 weight-only and W8A8, per layer and
# on the whole-stack path (JAX: the [L*E] stack addressed with a gid
# offset; the port: the layer's [E] view, routed by plan_route for an
# all-MoE stack); float experts per layer (the "dense" kind, act quant
# off by the JAX rule since a node is dense)
@pytest.mark.parametrize("bits,actq,stacked", [
    (8, False, False), (8, True, False), (8, False, True), (8, True, True),
    (16, True, False)])
def test_moe_mlp_gmm_int8_and_float_experts(bits, actq, stacked):
    """One MoE layer (layer 1 of 2), S = 2 x 520 tokens: tolerances as the
    K1 dispatch test: f32 / weight-only rel 1e-4 (bf16-rounded x),
    W8A8 rel 1e-3 (a rare act-quant rounding flip from a last-bit
    difference costs one quant step)."""
    rng = np.random.default_rng(bits + 2 * actq + 4 * stacked)
    ex, router = _experts(rng, bits)
    x = (rng.normal(size=(2, 520, H)) * 0.5).astype(np.float32)
    layer = 1
    view = jax.tree_util.tree_map(lambda a: a[layer], ex)
    jmp = {"router": {"kernel": jnp.asarray(router[layer])}}
    if stacked:
        jmp["experts"] = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a.reshape((-1,) + a.shape[2:])), ex)
        jmp["gid_offset"] = layer * E
    else:
        jmp["experts"] = jax.tree_util.tree_map(jnp.asarray, view)
    with jq.dynamic_act_quant(actq):
        want, aux_j = jax.jit(lambda m, v: jmoe.moe_mlp(
            m, v, MCFG, train=False, dispatch_mode="gmm"))(jmp, jnp.asarray(x))
    tmp = {"router": {"kernel": _t(router[layer])},
           "experts": convert.tree_from_numpy(view, device="cpu")}
    if stacked:
        assert tmoe.plan_route(tmp["experts"], E, 1, x.shape[0] * x.shape[1],
                               decode=False, capacity=2 * 520,
                               all_moe=True) == ("gmm", 512, ("int8",) * 3)
    with tq.dynamic_act_quant(actq):
        got, aux_t = tmoe.moe_mlp(tmp, _t(x), tc.MoeConfig(
            enable=True, num_experts=E, top_k=1), train=False,
            dispatch_mode="auto" if stacked else "gmm", all_moe=stacked)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    tol = 1e-3 if (actq and bits == 8) else 1e-4
    assert _rel(got.numpy(), want) < tol


def test_whole_stack_gmm_rejects_dense_experts():
    """Float experts of an all-MoE stack never take the whole-stack route:
    a decode step sorts (no decode tile, no K2) and an expert-parallel
    prefill sorts; a prefill without ep_shard takes the per-layer grouped
    matmuls on the "dense" kind (a dequantized copy, K3's float mode)."""
    rng = np.random.default_rng(0)
    ex, _ = _experts(rng, 16)
    view = convert.tree_from_numpy(
        jax.tree_util.tree_map(lambda a: a[0], ex), device="cpu")
    dense = ("dense",) * 3
    assert tmoe.plan_route(view, E, 1, 16, decode=True, capacity=16,
                           all_moe=True) == ("sort", None, dense)
    assert tmoe.plan_route(view, E, 1, 2048, decode=False, capacity=2048,
                           all_moe=True, ep_shard=True,
                           ep=2) == ("sort", None, dense)
    assert tmoe.plan_route(view, E, 1, 2048, decode=False, capacity=2048,
                           all_moe=True) == ("gmm", 512, dense)
