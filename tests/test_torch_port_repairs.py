"""Repairs of the port against the JAX package, on the CPU:

- ops/cuda/pad.pad_operands, the zero padding the CUDA wrappers of K1, K3,
  K7, K8 and K9 (f32 x) apply to odd widths: each kernel's plain version
  on the padded operands, sliced back to N columns, equals it on the
  unpadded ones (integer sums: bit-equal; float sums: the same products
  plus exact zeros, summed in f32 in another blocking: rel 1e-6), and
  operands that need no padding come back as they are (no copy);
- the `train` defaults of the MoE entry points equal the JAX signatures;
- K1 `gmm_int4h` takes the Pallas kernel's arguments (a missing A8
  a_scale is ones; out_dtype; block_n, allow_pad and block_k, which tile
  and change no A8 result) and K2 `moe_ffn_decode_int4h` its defaults
  (bf16 x unless int8_x; block_n, the A8 act-quant block), held against
  the Pallas kernels in interpret mode; the port's MoE caller takes K2 in
  A8, the JAX caller's default (MEDPLIB_DECODE_A8 unset).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medplib_tpu.config as jc
import medplib_tpu_torch.config as tc
from medplib_tpu.models import moe_llama as jml
from medplib_tpu.ops import moe as jmoe
from medplib_tpu.ops.pallas import gmm as jg
from medplib_tpu.ops.pallas import moe_decode as jd
from medplib_tpu.utils.quantize import _quantize_kernel4h
from medplib_tpu_torch.models import moe_llama as tml
from medplib_tpu_torch.ops import moe as tmoe
from medplib_tpu_torch.ops.cuda import gmm as G
from medplib_tpu_torch.ops.cuda import int4_matmul as I4
from medplib_tpu_torch.ops.cuda import int8_matmul as I8
from medplib_tpu_torch.ops.cuda import moe_decode as D
from medplib_tpu_torch.ops.cuda.pad import pad_operands

torch.set_num_threads(1)

K, N = 688, 320          # the odd widths of the CPU kernel tests


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, exact):
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        assert torch.equal(got, want)
    else:
        g, w = got.double(), want.double()
        assert float((g - w).norm() / w.norm()) <= 1e-6


def _int8_operands(rng, m, k, n, transposed):
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-127, 128, size=(n, k) if transposed
                                      else (k, n)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(1e-3, 2e-2, size=(n, 1) if transposed
                                     else (1, n)).astype(np.float32))
    return x, w, s


@pytest.mark.parametrize("transposed", [False, True])
def test_pad_keeps_int8_matmul_and_w8a8(transposed):
    """K7 / K8 pad K and N to multiples of 16."""
    x, w, s = _int8_operands(_rng(1 + transposed), 37, K, N - 3, transposed)
    kn = (1, 0) if transposed else (0, 1)
    xp, wp, sp = pad_operands(x, w, s, 16, 16, *kn, scale_n_dim=kn[1])
    assert xp.shape[1] % 16 == 0 and wp.shape[kn[1]] % 16 == 0
    n = N - 3
    got = I8.int8_matmul_plain(xp, wp, sp, transposed)[:, :n]
    _close(got, I8.int8_matmul_plain(x, w, s, transposed), False)
    xq, a_s = I8.quantize_rows(x)
    xqp, wp, sp = pad_operands(xq, w, s, 16, 16, *kn, scale_n_dim=kn[1])
    got = I8.w8a8_matmul_plain(xqp, a_s, wp, sp, transposed,
                               torch.float32)[:, :n]
    _close(got, I8.w8a8_matmul_plain(xq, a_s, w, s, transposed,
                                     torch.float32), True)


@pytest.mark.parametrize("mode", ["W8A8", "int8-w", "float"])
@pytest.mark.parametrize("transposed", [False, True])
def test_pad_keeps_gmm(mode, transposed):
    """K3 pads K and N of the expert stack to multiples of 16."""
    rng = _rng(3)
    e, s, bm, n = 2, 90, 32, N - 5
    xs = torch.from_numpy(rng.normal(size=(s, K)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, e, size=(s,)))
    x_al, _, gid = G.align_groups(xs, idx, e, bm)
    wshape = (e, n, K) if transposed else (e, K, n)
    ws = a_s = None
    if mode == "float":
        w = torch.from_numpy(rng.normal(size=wshape).astype(np.float32))
    else:
        w = torch.from_numpy(rng.integers(-127, 128, size=wshape)
                             .astype(np.int8))
        ws = torch.from_numpy(rng.uniform(1e-3, 2e-2, size=(e, 1, n))
                              .astype(np.float32))
    if mode == "W8A8":
        x_al, a_s = G.quantize_rows(x_al)
    kn = (2, 1) if transposed else (1, 2)
    xp, wp, wsp = pad_operands(x_al, w, ws, 16, 16, *kn)
    got = G.gmm_plain(xp, wp, gid, wsp, a_s, bm, torch.float32,
                      transposed)[:, :n]
    want = G.gmm_plain(x_al, w, gid, ws, a_s, bm, torch.float32, transposed)
    _close(got, want, mode == "W8A8")


@pytest.mark.parametrize("a8", [True, False])
def test_pad_keeps_gmm_int4h(a8):
    """K1 pads N to the multiple its kernels take: 16 in both modes (the
    s8 and the bf16 tensor-core kernels guard N at 16 for their 16-byte
    weight copies)."""
    rng = _rng(4)
    e, s, bm, k, n = 2, 70, 32, 512, 200
    xs = torch.from_numpy(rng.normal(size=(s, k)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, e, size=(s,)))
    x_al, _, gid = G.align_groups(xs, idx, e, bm)
    packed = torch.from_numpy(rng.integers(-128, 128, size=(e, k // 2, n))
                              .astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-3, 2e-2, size=(e, 2, 1, n))
                             .astype(np.float32))
    a_s = None
    if a8:
        x_al, a_s = G.quantize_rows(x_al)
    xp, pp, sp = pad_operands(x_al, packed, scale, 1, 16, 1, 2)
    assert pp.shape[2] == 208 and xp is x_al
    got = G.gmm_int4h_plain(xp, pp, sp, gid, a_s, bm)[:, :n]
    want = G.gmm_int4h_plain(x_al, packed, scale, gid, a_s, bm)
    _close(got.float(), want.float(), a8)


@pytest.mark.parametrize("transposed", [False, True])
def test_pad_keeps_int4h_matmul_n(transposed):
    """K9 pads N (f32 x: to a multiple of 16; its K padding keeps the
    unpadded group map, which the kernel takes as gsize)."""
    rng = _rng(5 + transposed)
    m, n, g = 21, N - 6, 8
    x = torch.from_numpy(rng.normal(size=(m, K)).astype(np.float32))
    packed = torch.from_numpy(rng.integers(
        -128, 128, size=(n, K // 2) if transposed else (K // 2, n))
        .astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-3, 2e-2, size=(
        g, n, 1) if transposed else (g, 1, n)).astype(np.float32))
    kn = (1, 0) if transposed else (0, 1)
    xp, pp, sp = pad_operands(x, packed, scale, 2, 16, *kn,
                              scale_n_dim=1 if transposed else 2,
                              k_per_w_row=2)
    assert xp is x and pp.shape[kn[1]] == N
    got = I4.int4h_matmul_plain(xp, pp, sp, transposed)[:, :n]
    _close(got, I4.int4h_matmul_plain(x, packed, scale, transposed), False)


def test_pad_returns_aligned_operands_as_they_are():
    x, w, s = _int8_operands(_rng(6), 8, 64, 32, False)
    xp, wp, sp = pad_operands(x, w, s, 16, 16, 0, 1, scale_n_dim=1)
    assert xp is x and wp is w and sp is s


@pytest.mark.parametrize("pair", [
    (tmoe.moe_mlp, jmoe.moe_mlp),
    (tml.make_moe_mlp_apply, jml.make_moe_mlp_apply),
    (tml.forward, jml.forward),
], ids=["moe_mlp", "make_moe_mlp_apply", "moe_llama.forward"])
def test_train_defaults_equal_jax(pair):
    port, ref = (inspect.signature(f).parameters["train"].default
                 for f in pair)
    assert port is ref is True


# ---------------------------------------------------------------------------
# K1 / K2 signatures and the K2 mode of the MoE caller, against JAX
# ---------------------------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy()


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _quant4h(rng, e, k, n, lead=()):
    w = rng.normal(size=tuple(lead) + (e, k, n)).astype(np.float32)
    p, sc = _quantize_kernel4h(jnp.asarray(w * k ** -0.5), False, 2)
    return np.asarray(p), np.asarray(sc)


def _k1_inputs(seed, k=512, n=320):
    rng = _rng(seed)
    packed, scale = _quant4h(rng, 2, k, n)
    x = rng.normal(size=(200, k)).astype(np.float32)
    idx = rng.integers(0, 2, size=200).astype(np.int32)
    xa, _, gid = jg.align_groups(jnp.asarray(x), jnp.asarray(idx), 2, 64)
    return xa, packed, scale, gid


def _fused_bound(xq, packed, scale, gid, a_s, bm=64):
    """2^-22 (|acc_lo s0| + |acc_hi s1|) |a_s| per element, in float64:
    about two f32 ulps of the two halves, which covers the port's rounded
    mul / add / mul and the reference's XLA-contracted FMA (interpret mode
    on the CPU fuses acc_lo * s0 + acc_hi * s1)."""
    x = np.asarray(xq, np.float64)
    w = np.asarray(G.unpack_pairs(_t(packed)), np.float64)
    half = x.shape[1] // 2
    rows = np.repeat(np.asarray(gid), bm)
    sc = np.asarray(scale, np.float64)[:, :, 0]            # [E, 2, N]
    lo = np.einsum("rk,rkn->rn", x[:, :half], w[rows, :half])
    hi = np.einsum("rk,rkn->rn", x[:, half:], w[rows, half:])
    mag = np.abs(lo * sc[rows, 0]) + np.abs(hi * sc[rows, 1])
    a = 1.0 if a_s is None else np.asarray(a_s, np.float64)
    return 2.0 ** -22 * mag * a


@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_gmm_int4h_a8_arguments_match_pallas(out_dtype, with_scale):
    """A8 with and without a_scale (missing = ones, as the reference), in
    f32 and bf16 output, with block_n = 128, which does not divide N = 320
    (the reference pads N; the port ignores the knob), block_k and
    allow_pad passed through. f32: within `_fused_bound`; bf16: within
    one bf16 step (the same f32 values, the reference one bf16 step off
    where its FMA crosses a rounding boundary)."""
    xa, packed, scale, gid = _k1_inputs(5 + with_scale)
    xq, xs = jax.jit(jg.quantize_rows)(xa)
    a_s = xs if with_scale else None
    jdt, tdt = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    want = jg.gmm_int4h(xq, jnp.asarray(packed), jnp.asarray(scale), gid,
                        a_scale=a_s, block_m=64, block_n=128,
                        out_dtype=jdt, block_k=128)
    got = G.gmm_int4h(_t(xq), _t(packed), _t(scale), _t(gid),
                      None if a_s is None else _t(a_s), block_m=64,
                      block_n=128, out_dtype=tdt, allow_pad=True,
                      block_k=128)
    assert got.dtype == tdt and got.shape == want.shape
    w = np.asarray(want, np.float32)
    if out_dtype == "float32":
        bound = _fused_bound(xq, packed, scale, gid, a_s)
        assert np.all(np.abs(_np(got) - w) <= bound)
    else:
        assert np.all(np.abs(_np(got) - w) <= np.abs(w) * 2.0 ** -7)
    if not with_scale:
        # ones: the same as passing a_scale = 1 explicitly
        ones = G.gmm_int4h(_t(xq), _t(packed), _t(scale), _t(gid),
                           torch.ones((xq.shape[0], 1)), block_m=64,
                           out_dtype=tdt)
        assert torch.equal(got, ones)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_k", [None, 128])
def test_gmm_int4h_float_arguments_match_pallas(out_dtype, block_k):
    """bf16-rounded f32 x, out_dtype f32 and bf16 (default: x.dtype =
    f32), block_n = 128 (not dividing N) and block_k (None: one K block;
    128: two blocks a scale group, another f32 summation order in the
    reference): f32 sums in another order, rel Frobenius 1e-5 in f32, one
    bf16 rounding (2^-8) in bf16."""
    xa, packed, scale, gid = _k1_inputs(7 + (block_k is None))
    jdt, tdt = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    want = jg.gmm_int4h(xa, jnp.asarray(packed), jnp.asarray(scale), gid,
                        block_m=64, block_n=128, out_dtype=jdt,
                        block_k=block_k)
    got = G.gmm_int4h(_t(xa), _t(packed), _t(scale), _t(gid), block_m=64,
                      block_n=128, out_dtype=tdt, block_k=block_k)
    assert got.dtype == tdt and got.shape == want.shape
    assert _rel(_np(got), want) <= (1e-5 if out_dtype == "float32"
                                    else 2.0 ** -8)
    default = G.gmm_int4h(_t(xa), _t(packed), _t(scale), _t(gid),
                          block_m=64)
    assert default.dtype == torch.float32


def _k2_layer(seed, h=256, m=3072):
    """One layer of int4h(G=2) experts (E = 2); M/2 = 1536, where
    _pick_bn gives 512 (three blocks a half), and 128 / 256 divide it."""
    rng = _rng(seed)
    ex = {}
    for name, (k, n) in (("gate_proj", (h, m)), ("up_proj", (h, m)),
                         ("down_proj", (m, h))):
        p, sc = _quant4h(rng, 2, k, n)
        ex[name] = {"kernel": p, "scale4h": sc}
    assert D._pick_bn(m // 2) == 512
    return rng, ex


def _k2_call(ex, x, idx, gate, **kw):
    jex = jax.tree_util.tree_map(jnp.asarray, ex)
    want = jd.moe_ffn_decode_int4h(jnp.asarray(x), jex, jnp.asarray(idx),
                                   jnp.asarray(gate), 0, 2, **kw)
    tex = {n: {k: _t(v) for k, v in node.items()} for n, node in ex.items()}
    got = D.moe_ffn_decode_int4h(_t(x), tex, _t(idx), _t(gate), 2, **kw)
    return got, np.asarray(want)


def _k2_rows(rng, b=12, h=256):
    x = (rng.normal(size=(b, h)) * 0.5).astype(np.float32)
    idx = rng.integers(0, 2, size=b).astype(np.int32)
    gate = rng.uniform(0.5, 1.0, size=b).astype(np.float32)
    return x, idx, gate


def test_moe_decode_default_mode_matches_pallas():
    """Both sides called without int8_x take the bf16-x mode (the default
    of both signatures): equal within rel 1e-3 (the two exp()s may differ
    in the last bit and flip a rare bf16 rounding of the activation), and
    away from the A8 result."""
    for f in (D.moe_ffn_decode_int4h, D.moe_ffn_decode_int4h_plain):
        sig = inspect.signature(f).parameters
        assert sig["int8_x"].default is False and sig["block_n"].default \
            is None
    rng, ex = _k2_layer(11)
    x, idx, gate = _k2_rows(rng)
    got, want = _k2_call(ex, x, idx, gate)
    assert _rel(_np(got), want) < 1e-3
    a8, _ = _k2_call(ex, x, idx, gate, int8_x=True)
    assert _rel(_np(a8), want) > 1e-3


@pytest.mark.parametrize("block_n", [128, 256])
def test_moe_decode_block_n_matches_pallas(block_n):
    """A8 with block_n = 128 / 256 where _pick_bn gives 512: the act-quant
    block moves the result, and both packages move it alike (rel 1e-3, as
    the default-mode test)."""
    rng, ex = _k2_layer(12 + block_n)
    x, idx, gate = _k2_rows(rng)
    got, want = _k2_call(ex, x, idx, gate, block_n=block_n, int8_x=True)
    assert _rel(_np(got), want) < 1e-3
    default, _ = _k2_call(ex, x, idx, gate, int8_x=True)
    assert not torch.equal(got, default)
    with pytest.raises(ValueError):
        D.moe_ffn_decode_int4h_plain(
            _t(x), {n: {k: _t(v) for k, v in node.items()}
                    for n, node in ex.items()}, _t(idx), _t(gate), 2,
            block_n=1024, int8_x=True)


@pytest.mark.parametrize("a8_env", [None, "1", "0"])
def test_moe_mlp_decode_mode_reads_medplib_decode_a8(monkeypatch, a8_env):
    """A decode call of moe_mlp on the grouped route takes the fused
    decode kernel in A8 on the port whatever MEDPLIB_DECODE_A8 says; the
    JAX caller (a decode tile, block_m 16, on the whole-stack path) reads
    the variable (unset: A8). The port's output is K2 called directly in
    A8, bit for bit; JAX's is within rel 1e-3 (as above) of K2 called
    directly in the mode the variable names, and not of the other."""
    if a8_env is None:
        monkeypatch.delenv("MEDPLIB_DECODE_A8", raising=False)
    else:
        monkeypatch.setenv("MEDPLIB_DECODE_A8", a8_env)
    rng, ex = _k2_layer(13)
    h, e = 256, 2
    router = (rng.normal(size=(h, e)) * h ** -0.5).astype(np.float32)
    x = (rng.normal(size=(4, 1, h)) * 0.5).astype(np.float32)
    jmp = {"router": {"kernel": jnp.asarray(router)},
           "experts": jax.tree_util.tree_map(jnp.asarray, ex)}
    want, _ = jax.jit(lambda m, v: jmoe.moe_mlp(
        dict(m, gid_offset=0, gmm_block_m=16), v,
        jc.MoeConfig(enable=True, num_experts=e, top_k=1), train=False,
        dispatch_mode="gmm"))(jmp, jnp.asarray(x))
    tex = {n: {k: _t(v) for k, v in node.items()} for n, node in ex.items()}
    tmp = {"router": {"kernel": _t(router)}, "experts": tex}
    n0 = D.moe_ffn_decode_int4h.launches
    got, _ = tmoe.moe_mlp(tmp, _t(x), tc.MoeConfig(
        enable=True, num_experts=e, top_k=1), train=False,
        dispatch_mode="gmm", decode=True)
    assert D.moe_ffn_decode_int4h.launches == n0   # CPU: the plain version
    want = np.asarray(want).reshape(4, h)
    # the mode each took: the direct K2 call in that mode, routed alike
    logits = _t(x.reshape(4, h)) @ _t(router)
    gates = torch.softmax(logits, -1)
    idx = gates.argmax(-1)
    g = gates.gather(1, idx[:, None])[:, 0]
    direct = {a8: D.moe_ffn_decode_int4h(_t(x.reshape(4, h)), tex,
                                         idx.to(torch.int32), g, e,
                                         int8_x=a8)
              for a8 in (True, False)}
    assert torch.equal(got.reshape(4, h), direct[True])
    jax_a8 = a8_env != "0"
    assert _rel(_np(direct[jax_a8]), want) < 1e-3
    assert _rel(_np(direct[not jax_a8]), want) > 1e-3
