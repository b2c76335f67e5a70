"""K1's W4A8 mode on the s8 tensor-core tile
(medplib_tpu_torch/csrc/s8_mma.cuh, layout kPairs), modelled in numpy, and
the W8A8 epilogues of K1 and K3 against the JAX package.

The kernel cannot run here. Its nibble constants and transpose selectors
are read from the header, and what a lane does is replayed on random
packed int4h stages: it reads two words of packed rows 2t and 2t + 1 (and
8 + 2t, 9 + 2t) from the swizzled shared tile, widens each word's nibbles
to two s8 words (16 x the nibble: the high nibble masked in place, the low
one shifted up) and transposes the four words as the [K, N] int8 layout
does. The registers must be the m16n8k32 .col B operand of
16 x unpack_pairs(packed) under the column map (n-tile j's column g is
warp column 4 g + j), and the s32 sums they give, shifted right by 4, the
exact integer products. Every load phase must hit 32 distinct banks.
Mutated constants must fail. The chunk swizzle is mirrored from the header
(not read from it).

The epilogues: K1 folds p = f32(acc_lo) * s0 in f32, then
(p + f32(acc_hi) * s1) * a_s; K3 takes (f32(acc) * w_s) * a_s. A numpy f32
model of each must equal the plain version bit for bit, and K8's order
(acc * a_s) * w_s must differ from K3's on the same inputs. Against the
Pallas kernels in interpret mode (as the JAX package's tests run them):
K3's model equals them bit for bit; for K1, XLA's CPU compiler fuses the
first product of acc_lo * s0 + acc_hi * s1 into an FMA, so the Pallas
result equals the model with that one product fused, bit for bit.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medplib_tpu.ops.pallas import gmm as jg
from medplib_tpu_torch.ops.cuda import gmm as tg
from test_torch_s8_fragments import _selectors, transpose4x4

torch.set_num_threads(1)

HEADER = (Path(__file__).resolve().parents[1] / "medplib_tpu_torch" / "csrc"
          / "s8_mma.cuh")
PACKED_ROWS = 64       # packed rows a pipeline stage (128 logical k)


def _nibble_constants():
    text = HEADER.read_text()
    mask = re.search(r"constexpr\s+uint32_t\s+kNibMask\s*=\s*"
                     r"(0x[0-9A-Fa-f]+)u;", text)
    shift = re.search(r"constexpr\s+int\s+kNibShift\s*=\s*(\d+);", text)
    assert mask and shift, f"nibble constants not found in {HEADER.name}"
    return {"kNibMask": np.uint32(int(mask.group(1), 16)),
            "kNibShift": np.uint32(int(shift.group(1)))}


def widen_pairs(w, nib):
    """widen_pairs: a packed word -> (lo, hi) s8 words, as the header."""
    w = np.asarray(w, np.uint32)
    return ((w << nib["kNibShift"]) & nib["kNibMask"]).astype(np.uint32), \
        (w & nib["kNibMask"]).astype(np.uint32)


def pairs_offset(r, c, cpr):
    """KNLoader<.., PAIRS>::offset: chunk c of packed row r at chunk
    address (r cpr + c) ^ (2 ((r >> 1) & 3)), in bytes."""
    return ((r * cpr + c) ^ (2 * ((r >> 1) & 3))) << 4


def pairs_tile(packed, bn):
    """One stage of the packed [64, bn] tile as the copies place it."""
    cpr = bn // 16
    tile = np.zeros(PACKED_ROWS * bn, np.uint8)
    for r in range(PACKED_ROWS):
        for c in range(cpr):
            o = pairs_offset(r, c, cpr)
            tile[o:o + 16] = packed[r, 16 * c:16 * c + 16]
    return tile


def pairs_fragments(packed, bn, wn0, s, sel, nib):
    """The registers of k-step s for the warp at columns wn0: lane (g, t)
    reads, at the kernel's b_off[0] / b_off[1] (packed rows 2t, 2t + 1,
    k-step 0) plus 16 s bn and 8 h bn, the words of packed rows
    16 s + 8 h + 2t + c, widens them and transposes the four of each h.
    -> ([8 g, 4 t, 4 j, 2] uint32, [4 loads, 32 lanes] bank of each read)."""
    cpr = bn // 16
    tile = pairs_tile(packed, bn)
    regs = np.zeros((8, 4, 4, 2), np.uint32)
    banks = np.zeros((4, 32), np.int64)
    for g in range(8):
        for t in range(4):
            col = (wn0 + 4 * g) >> 4
            b_off = [pairs_offset(2 * t + c, col, cpr) + 4 * (g & 3)
                     for c in range(2)]
            for h in range(2):
                rows = []
                for c in range(2):
                    a = b_off[c] + 16 * s * bn + 8 * h * bn
                    word = tile[a:a + 4].view(np.uint32)[0]
                    banks[2 * h + c, 4 * g + t] = (a // 4) % 32
                    rows.extend(widen_pairs(word, nib))
                for j, b in enumerate(transpose4x4(rows, sel)):
                    regs[g, t, j, h] = b
    return regs, banks


def wanted(w16, wn0, s):
    """The m16n8k32 .col B operand of the int8 [128, n] stage w16: b0 =
    k 4t..4t+3, b1 = k 16+4t.. of B column g of n-tile j (warp column
    wn0 + 4 g + j); byte i holds k 4t + i. -> [8 g, 4 t, 4 j, 2] uint32."""
    out = np.zeros((8, 4, 4, 2), np.uint32)
    for g in range(8):
        for t in range(4):
            for j in range(4):
                col = w16[:, wn0 + 4 * g + j]
                for half in range(2):
                    k = 32 * s + 16 * half + 4 * t
                    out[g, t, j, half] = np.ascontiguousarray(
                        col[k:k + 4]).view(np.uint32)[0]
    return out


def _packed(seed, n):
    """One stage of a random packed int4h weight [64, n] (bytes), with
    every nibble value in it."""
    rng = np.random.default_rng(seed)
    p = rng.integers(-128, 128, size=(PACKED_ROWS, n)).astype(np.int8)
    p[0, :16] = np.arange(-128, 128, 16)        # high nibbles -8 .. 7
    p[1, :16] = np.arange(16) - 8               # low nibbles -8 .. 7
    return p.view(np.uint8)


def _unpacked16(p):
    """16 x unpack_pairs(p) as int8 [128, n]: the s8 values the kernel's
    B operand holds."""
    w = tg.unpack_pairs(torch.from_numpy(p.view(np.int8))).numpy()
    return (w.astype(np.int32) * 16).astype(np.int8)


def test_header_nibble_constants():
    assert _nibble_constants() == {"kNibMask": 0xF0F0F0F0, "kNibShift": 4}


def test_widening_is_exact_for_every_byte():
    """All 256 bytes in every byte position of a word: lo holds 16 x the
    sign-extended low nibble, hi 16 x the high nibble, byte for byte, and
    the arithmetic shift the epilogue takes undoes the factor."""
    nib = _nibble_constants()
    b = np.arange(256, dtype=np.uint32)
    lo_want = ((b & 0xF) ^ 8).astype(np.int32) - 8
    hi_want = ((b >> 4) ^ 8).astype(np.int32) - 8
    for pos in range(4):
        lo, hi = widen_pairs(b << np.uint32(8 * pos), nib)
        lo_b = ((lo >> np.uint32(8 * pos)) & 0xFF).astype(np.uint8)
        hi_b = ((hi >> np.uint32(8 * pos)) & 0xFF).astype(np.uint8)
        np.testing.assert_array_equal(lo_b.view(np.int8), 16 * lo_want)
        np.testing.assert_array_equal(hi_b.view(np.int8), 16 * hi_want)
        others = ~np.uint32(0xFF << (8 * pos))
        assert not (lo & others).any() and not (hi & others).any()
    np.testing.assert_array_equal((16 * lo_want) >> 4, lo_want)


@pytest.mark.parametrize("bn", [128, 64])
@pytest.mark.parametrize("s", [0, 1, 2, 3])
def test_pairs_fragments_hold_the_mma_b_operand(bn, s):
    """Every warp of the block tile, k-step s: the widened and transposed
    words give exactly the .col registers of 16 x unpack_pairs, and each
    of the four loads reads 32 distinct banks at both tile widths."""
    sel, nib = _selectors(), _nibble_constants()
    p = _packed(bn + s, bn)
    w16 = _unpacked16(p)
    for wn0 in range(0, bn, 32):
        regs, banks = pairs_fragments(p, bn, wn0, s, sel, nib)
        assert np.array_equal(regs, wanted(w16, wn0, s))
        assert [len(set(b)) for b in banks] == [32] * 4


def test_pairs_sums_shifted_are_the_products():
    """A whole stage through the registers: lane (g, t)'s B bytes times an
    int8 x, summed in s32 as mma.m16n8k32 does (rows of x against the
    .col bytes), shifted right by 4, equal x @ unpack_pairs(packed)."""
    sel, nib = _selectors(), _nibble_constants()
    rng = np.random.default_rng(5)
    bn = 128
    p = _packed(9, bn)
    x = rng.integers(-128, 128, size=(16, 128)).astype(np.int64)
    acc = np.zeros((16, bn), np.int64)
    for wn0 in range(0, bn, 32):
        for s in range(4):
            regs, _ = pairs_fragments(p, bn, wn0, s, sel, nib)
            for g in range(8):
                for t in range(4):
                    for j in range(4):
                        for half in range(2):
                            b = np.frombuffer(regs[g, t, j, half].tobytes(),
                                              np.int8).astype(np.int64)
                            k = 32 * s + 16 * half + 4 * t
                            acc[:, wn0 + 4 * g + j] += x[:, k:k + 4] @ b
    assert (acc % 16 == 0).all() and np.abs(acc).max() < 2 ** 31
    w = tg.unpack_pairs(torch.from_numpy(p.view(np.int8))).numpy()
    np.testing.assert_array_equal(acc >> 4, x @ w.astype(np.int64))


MUTATIONS = {
    "low-nibble mask": {"kNibMask": np.uint32(0x0F0F0F0F)},
    "mask drops the sign bit": {"kNibMask": np.uint32(0x70707070)},
    "no shift": {"kNibShift": np.uint32(0)},
    "shift by a byte": {"kNibShift": np.uint32(8)},
    "pairs swapped": {"kPairLo": np.uint32(0x4051)},
    "halves of the other word": {"kHalfLo": np.uint32(0x1054)},
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutated_constant_fails(name):
    """The fragment check catches each wrong nibble constant or
    selector."""
    mut = MUTATIONS[name]
    sel = dict(_selectors(), **{k: v for k, v in mut.items()
                                if k.startswith("kPair")
                                or k.startswith("kHalf")})
    nib = dict(_nibble_constants(), **{k: v for k, v in mut.items()
                                       if k.startswith("kNib")})
    p = _packed(0, 128)
    regs, _ = pairs_fragments(p, 128, 32, 1, sel, nib)
    assert not np.array_equal(regs, wanted(_unpacked16(p), 32, 1))


# ---------------------------------------------------------------------------
# the epilogues, against the plain versions and the Pallas kernels
# ---------------------------------------------------------------------------

def _bf16_bits(v):
    """f32 -> bf16 (round to nearest even) bits as uint16."""
    return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _jax_bits(a):
    return np.asarray(a).view(np.uint16)


def _routed(rng, e, s, k, bm):
    """Group-aligned int8 rows of S routed tokens over E experts (the
    two-ended layout for E = 2: group 0, a gap tile, group 1) and their
    per-row scales."""
    xs = rng.normal(size=(s, k)).astype(np.float32)
    idx = rng.integers(0, e, size=s).astype(np.int32)
    xa, _, gid = jg.align_groups(jnp.asarray(xs), jnp.asarray(idx), e, bm)
    xq, a_s = tg.quantize_rows(torch.from_numpy(np.array(xa)))
    return xq.numpy(), a_s.numpy(), np.array(gid)


def _k1_model(xq, packed, scale, a_s, gid, bm, fused=False):
    """K1's epilogue in numpy f32: exact integer half sums, p = acc_lo *
    s0, (p + acc_hi * s1) * a_s, each op rounded to f32. fused=True
    contracts the first product into the sum, fma(acc_lo, s0, acc_hi *
    s1), as XLA's CPU compiler does with the Pallas kernel's expression
    in interpret mode (f64 holds acc_lo * s0 exactly, so the f64 sum
    rounded to f32 is the fused op but at double-rounding ties, which
    these inputs do not hit)."""
    k2 = packed.shape[1]
    out = np.zeros((xq.shape[0], packed.shape[2]), np.float32)
    rows = np.repeat(gid, bm)
    for g in range(packed.shape[0]):
        sel = rows == g
        w = tg.unpack_pairs(torch.from_numpy(packed[g])).numpy().astype(
            np.int64)
        x = xq[sel].astype(np.int64)
        lo = (x[:, :k2] @ w[:k2]).astype(np.float32)
        hi = (x[:, k2:] @ w[k2:]).astype(np.float32)
        if fused:
            v = (lo.astype(np.float64) * scale[g, 0].astype(np.float64)
                 + hi * scale[g, 1]).astype(np.float32)
        else:
            v = lo * scale[g, 0] + hi * scale[g, 1]
        out[sel] = v * a_s[sel]
    return out


@pytest.mark.parametrize("e,k,n", [(2, 512, 192), (2, 768, 208),
                                   (4, 256, 128)])
def test_k1_fold_equals_plain_and_pallas(e, k, n):
    """Over layouts with gap tiles: the numpy fold (the kernel's rounded
    ops, in its order) equals gmm_int4h_plain bit for bit. The Pallas
    gmm_int4h in interpret mode equals the same fold with its first
    product fused into the sum bit for bit; the two folds differ by at
    most one bf16 ulp in a few elements."""
    rng = np.random.default_rng(e + k + n)
    bm = 64
    xq, a_s, gid = _routed(rng, e, 300, k, bm)
    assert set(gid.tolist()) == set(range(e))
    packed = rng.integers(-128, 128, size=(e, k // 2, n)).astype(np.int8)
    scale = rng.uniform(1e-3, 1.1e-2, size=(e, 2, 1, n)).astype(np.float32)
    model = _k1_model(xq, packed, scale, a_s, gid, bm)
    want = _bf16_bits(model)
    plain = tg.gmm_int4h_plain(torch.from_numpy(xq),
                               torch.from_numpy(packed),
                               torch.from_numpy(scale), torch.from_numpy(gid),
                               torch.from_numpy(a_s), bm)
    np.testing.assert_array_equal(plain.view(torch.int16).numpy()
                                  .view(np.uint16), want)
    pallas = jg.gmm_int4h(jnp.asarray(xq), jnp.asarray(packed),
                          jnp.asarray(scale), jnp.asarray(gid),
                          a_scale=jnp.asarray(a_s), block_m=bm, block_n=128)
    fused = _k1_model(xq, packed, scale, a_s, gid, bm, fused=True)
    np.testing.assert_array_equal(_jax_bits(pallas), _bf16_bits(fused))
    steps = np.abs(_bf16_bits(fused).astype(np.int32) - want)
    assert steps.max() <= 1 and (steps > 0).mean() < 1e-3


def _k3_model(xq, w, ws, a_s, gid, bm, ws_first=True):
    """K3's epilogue in numpy f32 ((acc * w_s) * a_s), or K8's order
    ((acc * a_s) * w_s) with ws_first=False."""
    out = np.zeros((xq.shape[0], w.shape[2]), np.float32)
    rows = np.repeat(gid, bm)
    for g in range(w.shape[0]):
        sel = rows == g
        acc = (xq[sel].astype(np.int64) @ w[g].astype(np.int64)).astype(
            np.float32)
        out[sel] = (acc * ws[g]) * a_s[sel] if ws_first \
            else (acc * a_s[sel]) * ws[g]
    return out


@pytest.mark.parametrize("e,k,n", [(2, 256, 192), (2, 2176, 128)])
@pytest.mark.parametrize("out", ["bf16", "f32"])
def test_k3_w8a8_epilogue_order(e, k, n, out):
    """(acc * w_s) * a_s equals gmm_plain and the Pallas gmm W8A8 bit for
    bit, in bf16 and in f32 output; K8's order (acc * a_s) * w_s differs on
    the same inputs, so a kernel with the orders swapped would fail its
    bit-equality check."""
    rng = np.random.default_rng(k + n)
    bm = 64
    xq, a_s, gid = _routed(rng, e, 300, k, bm)
    w = rng.integers(-127, 128, size=(e, k, n)).astype(np.int8)
    ws = rng.uniform(1e-3, 2e-2, size=(e, 1, n)).astype(np.float32)
    model = _k3_model(xq, w, ws, a_s, gid, bm)
    swapped = _k3_model(xq, w, ws, a_s, gid, bm, ws_first=False)
    bf16 = out == "bf16"
    want = _bf16_bits(model) if bf16 else model.view(np.uint32)
    plain = tg.gmm_plain(torch.from_numpy(xq), torch.from_numpy(w),
                         torch.from_numpy(gid), torch.from_numpy(ws),
                         torch.from_numpy(a_s), bm, out_dtype=torch.bfloat16
                         if bf16 else torch.float32)
    plain = plain.view(torch.int16) if bf16 else plain
    np.testing.assert_array_equal(plain.numpy().view(want.dtype), want)
    pallas = jg.gmm(jnp.asarray(xq), jnp.asarray(w), jnp.asarray(gid),
                    jnp.asarray(ws), a_scale=jnp.asarray(a_s), block_m=bm,
                    block_n=128, out_dtype=jnp.bfloat16 if bf16
                    else jnp.float32)
    np.testing.assert_array_equal(np.asarray(pallas).view(want.dtype), want)
    assert ((_bf16_bits(swapped) if bf16 else swapped.view(np.uint32))
            != want).any()
