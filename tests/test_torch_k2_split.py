"""CPU models of the arithmetic and the fragment maps of K2's tensor-core
kernels (medplib_tpu_torch/csrc/moe_decode_int4h.cu) and of K1's float
fold (csrc/int4h_mma.cuh), which cannot run here.

- The widened down pass: one f32 partial per (e, j, nh) block, p =
  (f32(s32 sum) * a_s) * d_s, then the partials added from 0 in the TPU
  grid's (e, j, nh) order. The model is bit-equal to
  moe_ffn_decode_int4h_plain (A8) for block_n 128 / 256 / 512, and the
  same partials added in block order c instead differ: the order is what
  keeps the sum bit-equal.
- K1's fold: the separately rounded (acc_lo * s0) + (acc_hi * s1) that the
  K1 instance of int4h_mma_kernel takes (read from the header) equals
  gmm_int4h_plain's epilogue bit for bit; K9's fmaf fold differs from it.
- The 16-row tiles: the A fragments that ldmatrix.x4 gives from a 16-row
  ATileLoader tile (s8 m16k32, and bf16 m16k16 from the two 64-k tiles of
  a 128-k stage), and the bf16 B registers K2 reads from the
  pairs-swizzled packed tile (the words of packed rows 8 s + t and
  8 s + 4 + t, a byte of each paired by __byte_perm, the nibbles decoded
  to bf16x2), each replayed lane by lane against the mma operand
  layouts; wrong rows or selectors fail. The s8 B registers are K1's
  kPairs map, replayed by test_torch_s8_int4h_fragments.py; the rows,
  strides and selector both models take are read from the K2 source.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from medplib_tpu_torch.ops.activations import silu
from medplib_tpu_torch.ops.cuda import gmm as tg
from medplib_tpu_torch.ops.cuda import moe_decode as td
from test_torch_s8_int4h_fragments import _packed, pairs_offset, pairs_tile

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "medplib_tpu_torch" / "csrc"


# ---------------------------------------------------------------------------
# the widened down pass and its combine
# ---------------------------------------------------------------------------

def _experts(rng, e, h, m):
    ex = {}
    for name, (k, n) in (("gate_proj", (h, m)), ("up_proj", (h, m)),
                         ("down_proj", (m, h))):
        ex[name] = {
            "kernel": torch.from_numpy(rng.integers(
                -128, 128, size=(e, k // 2, n)).astype(np.int8)),
            "scale4h": torch.from_numpy(rng.uniform(
                1e-3, 1.1e-2, size=(e, 2, 1, n)).astype(np.float32))}
    return ex


def _int_mm(a, w):
    """Exact integer product of int8 a [B, K] and int8 w [K, N] -> f32
    (the s32 sum, exact in f32 below 2^24)."""
    s = a.long() @ w.long()
    assert int(s.abs().max()) < 2 ** 24
    return s.float()


def split_model(x, ex, idx, gate, e_n, bn, order="ejn"):
    """K2 in A8 as the card runs it: gate / up with K1's fold and * xs;
    act = silu(g) * u * mask; act quant per row per bn block; one f32
    partial (f32(s32) * a_s) * d_s per (e, c); the partials added from 0,
    in (e, j, nh) order ("ejn") or, to show that the order matters, in
    block order c ("ec")."""
    b, h = x.shape
    gp, up, dp = (ex[n] for n in ("gate_proj", "up_proj", "down_proj"))
    m2 = gp["kernel"].shape[-1] // 2
    n_j = m2 // bn
    xq, xs = tg.quantize_rows(x)
    parts = {}
    for e in range(e_n):
        def gu(node):
            w = tg.unpack_pairs(node["kernel"][e])
            s = node["scale4h"][e]
            lo = _int_mm(xq[:, :h // 2], w[:h // 2])
            hi = _int_mm(xq[:, h // 2:], w[h // 2:])
            return (lo * s[0] + hi * s[1]) * xs
        mask = torch.where(idx == e, gate, torch.zeros_like(gate))
        act = silu(gu(gp)) * gu(up) * mask[:, None]
        wd = tg.unpack_pairs(dp["kernel"][e])
        for c in range(2 * n_j):
            q, a_s = tg.quantize_rows(act[:, c * bn:(c + 1) * bn])
            s32 = _int_mm(q, wd[c * bn:(c + 1) * bn])
            parts[e, c] = s32 * a_s * dp["scale4h"][e, c // n_j]
    if order == "ejn":
        keys = [(e, nh * n_j + j) for e in range(e_n) for j in range(n_j)
                for nh in range(2)]
    else:
        keys = [(e, c) for e in range(e_n) for c in range(2 * n_j)]
    out = torch.zeros((b, h), dtype=torch.float32)
    for k in keys:
        out = out + parts[k]
    return out


@pytest.mark.parametrize("block_n", [128, 256, 512])
def test_down_partials_combined_in_order_equal_plain(block_n):
    """B = 16, H = 512, M = 3072 (M/2 = 1536: n_j = 12, 6, 3), 2 experts:
    bit-equal to the plain version, which adds each block's product to
    one accumulator in the reference's order; the block-order sum
    differs."""
    rng = np.random.default_rng(block_n)
    e, b, h, m = 2, 16, 512, 3072
    ex = _experts(rng, e, h, m)
    x = torch.from_numpy((rng.normal(size=(b, h)) * 0.5).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, e, size=b).astype(np.int32))
    gate = torch.from_numpy(rng.uniform(0.5, 1.0, size=b).astype(np.float32))
    plain = td.moe_ffn_decode_int4h_plain(x, ex, idx, gate, e,
                                          block_n=block_n, int8_x=True)
    model = split_model(x, ex, idx, gate, e, block_n)
    assert torch.equal(model, plain)
    assert not torch.equal(split_model(x, ex, idx, gate, e, block_n, "ec"),
                           plain)


# ---------------------------------------------------------------------------
# K1's fold on float x
# ---------------------------------------------------------------------------

def test_k1_fold_is_the_rounded_one_in_the_header():
    """int4h_mma_kernel folds a group sum with fmaf for K9 and with the
    separately rounded product and sum for K1, and gmm_int4h.cu launches
    the K1 instances for float x."""
    text = (CSRC / "int4h_mma.cuh").read_text()
    m = re.search(r"return\s+K1\s*\?\s*__fadd_rn\(t,\s*__fmul_rn\(a,\s*s\)\)"
                  r"\s*:\s*fmaf\(a,\s*s,\s*t\);", text)
    assert m, "the fold choice is not in int4h_mma.cuh"
    launches = re.findall(r"launch_mma<\d+,\s*\d+,\s*\d+,\s*\d+,\s*false,"
                          r"\s*16,\s*true>", (CSRC / "gmm_int4h.cu")
                          .read_text())
    assert len(launches) == 2


def _fold(lo, hi, s0, s1, fused):
    """tot = 0; tot = fold(lo, s0, tot); tot = fold(hi, s1, tot) in f32:
    rounded (K1) or fmaf (K9; f64 holds each product exactly, so the f64
    sum rounded to f32 is the fused op but at double-rounding ties)."""
    if not fused:
        return (np.float32(0) + lo * s0) + hi * s1
    t = (lo.astype(np.float64) * s0).astype(np.float32)
    return (hi.astype(np.float64) * s1 + t).astype(np.float32)


def test_k1_plain_epilogue_is_the_rounded_fold():
    """gmm_int4h_plain on bf16 x (f32 out) equals the rounded fold of its
    own half sums bit for bit, and the fmaf fold differs from it."""
    rng = np.random.default_rng(3)
    e, k, n, bm = 2, 512, 192, 64
    packed = torch.from_numpy(rng.integers(-128, 128, size=(e, k // 2, n))
                              .astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-3, 1.1e-2, size=(e, 2, 1, n))
                             .astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(256, k)).astype(np.float32))
    gid = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    plain = tg.gmm_int4h_plain(x, packed, scale, gid, block_m=bm,
                               out_dtype=torch.float32).numpy()
    xf = x.to(torch.bfloat16).float()
    rows = gid.long().repeat_interleave(bm)
    want = {}
    for fused in (False, True):
        out = np.zeros_like(plain)
        for g in range(e):
            sel = rows == g
            w = tg.unpack_pairs(packed[g]).float()
            lo = (xf[sel][:, :k // 2] @ w[:k // 2]).numpy()
            hi = (xf[sel][:, k // 2:] @ w[k // 2:]).numpy()
            out[sel.numpy()] = _fold(lo, hi, scale[g, 0].numpy(),
                                     scale[g, 1].numpy(), fused)
        want[fused] = out
    assert np.array_equal(plain.view(np.uint32), want[False].view(np.uint32))
    assert not np.array_equal(want[True], want[False])


# ---------------------------------------------------------------------------
# the fragment maps of the 16-row tiles
# ---------------------------------------------------------------------------

KAROW = 128    # bytes of one A-tile row (mma_tile.cuh kARow)


def a_tile(rows):
    """A 16-row ATileLoader tile: chunk c of row r at r * 128 +
    ((c ^ (r & 7)) << 4). rows: [16, 128] uint8."""
    tile = np.zeros(16 * KAROW, np.uint8)
    for r in range(16):
        for c in range(8):
            o = r * KAROW + ((c ^ (r & 7)) << 4)
            tile[o:o + 16] = rows[r, 16 * c:16 * c + 16]
    return tile


def ldmatrix_a(tile, s):
    """ldmatrix.x4 at a_frag_offset(0, s): lane l addresses row l & 15 of
    chunk 2 s + (l >> 4); matrix i comes from lanes 8 i .. 8 i + 7, and
    lane (g, t) gets word t of matrix i's row g. -> [8 g, 4 t, 4] uint32."""
    addr = [(l & 15) * KAROW + (((2 * s + (l >> 4)) ^ (l & 7)) << 4)
            for l in range(32)]
    out = np.zeros((8, 4, 4), np.uint32)
    for i in range(4):
        for g in range(8):
            row = tile[addr[8 * i + g]:addr[8 * i + g] + 16].view(np.uint32)
            out[g, :, i] = row
    return out


@pytest.mark.parametrize("mode", ["s8", "bf16"])
def test_a_fragments_of_the_16_row_tile(mode):
    """s8: the A registers of k-step s (0..3) are a0 = row g, k 4t..4t+3,
    a1 = row g + 8, a2 / a3 = the same at k + 16 (m16n8k32). bf16: a
    128-k stage is two 64-k tiles; k-step s (0..7) reads tile s >> 2 at
    step s & 3, and a0a1 = row g, k 2t, 2t+1, a2a3 = row g + 8, a4a5 /
    a6a7 the same at k + 8 (m16n8k16), of the stage's logical k."""
    rng = np.random.default_rng(1)
    if mode == "s8":
        x = rng.integers(0, 256, size=(16, 128)).astype(np.uint8)
        tiles, steps, ek = [a_tile(x)], 4, 4
    else:
        x = rng.integers(0, 2 ** 16, size=(16, 128)).astype(np.uint16)
        xb = x.view(np.uint8)                      # [16, 256] bytes
        tiles = [a_tile(xb[:, :128]), a_tile(xb[:, 128:])]
        steps, ek = 8, 2                           # 2 bf16 k a word
    for s in range(steps):
        tile, ss = (tiles[0], s) if mode == "s8" else (tiles[s >> 2], s & 3)
        regs = ldmatrix_a(tile, ss)
        kd = 32 if mode == "s8" else 16            # k a step
        for g in range(8):
            for t in range(4):
                for i, (r, dk) in enumerate([(g, 0), (g + 8, 0),
                                             (g, kd // 2), (g + 8, kd // 2)]):
                    k = kd * s + dk + ek * t
                    want = np.ascontiguousarray(x[r, k:k + ek]).view(
                        np.uint32)[0]
                    assert regs[g, t, i] == want


def test_k2_reads_the_modelled_rows():
    """K2's kernels read the packed rows the models here and in
    test_torch_s8_int4h_fragments.py replay: A8, K1's kPairs words of
    packed rows 2 t, 2 t + 1 (+ 8 h) at 16 s rows a k-step; bf16, rows t
    and 4 + t at 8 s rows a k-step, byte j of each paired by the selector
    j | (j + 4) << 4; both on the 128-byte pairs tile of 128 threads
    (KNLoader<128, 128, true>, the instance of K1's 64-row tile)."""
    text = (CSRC / "moe_decode_int4h.cu").read_text()
    for pattern in (
            r"s8mma::KNLoader<kBN, kThreads, true>",
            r"constexpr int kBN = 128;",
            r"BLoad::offset\(A8 \? 2 \* t : t, cc\) \+ wb",
            r"BLoad::offset\(A8 \? 2 \* t \+ 1 : 4 \+ t, cc\) \+ wb",
            r"sb \+ 16 \* s \* kBN",
            r"q \+ b0 \+ 8 \* h \* kBN",
            r"sb \+ 8 \* s \* kBN",
            r"__byte_perm\(w0, w1, j \| \(\(j \+ 4\) << 4\)\)",
            r"ldmatrix_x4\(af, sa \+ \(s >> 2\) \* kBM \* kARow \+ "
            r"a_off\[s & 3\]\)"):
        assert re.search(pattern, text), pattern


def _bf16_sub136(v):
    """bf16x2 v minus (136, 136), lane by lane (exact: small integers)."""
    h = np.array([v & 0xFFFF, v >> 16], np.uint16).view(np.int16)
    f = torch.from_numpy(h.copy()).view(torch.bfloat16).float() - 136.0
    r = f.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    return np.uint32(int(r[0]) | (int(r[1]) << 16))


def nibbles_to_bf16x2(two):
    """mma_tile.cuh's decode, op for op: the low and the high nibbles of
    bytes 0 and 1 masked and flipped beside two 0x43 bytes, paired by
    byte permutes into (l0, 43, h0, 43) and (l1, 43, h1, 43), then 136
    subtracted from each bf16 half."""
    two = np.uint32(two)
    lo = np.uint32((int(two) & 0x0F0F) ^ 0x43430808)
    hi = np.uint32(((int(two) >> 4) & 0x0F0F) ^ 0x43430808)
    return (_bf16_sub136(int(byte_perm(lo, hi, 0x6420))),
            _bf16_sub136(int(byte_perm(lo, hi, 0x7531))))


def byte_perm(a, b, sel):
    """__byte_perm(a, b, sel) for selector nibbles 0..7 (no sign mode)."""
    src = np.array([a, b], np.uint32).view(np.uint8)
    out = 0
    for i in range(4):
        out |= int(src[(sel >> (4 * i)) & 7]) << (8 * i)
    return np.uint32(out)


def bf16_fragments(packed, wn0, s, rows=lambda t: (t, 4 + t),
                   sel=lambda j: j | (j + 4) << 4):
    """K2's bf16 B registers of k-step s (0..7) for the warp at columns
    wn0 of the pairs tile (BN 128): lane (g, t) reads the words of packed
    rows 8 s + rows(t) at columns wn0 + 4 g .. + 3, pairs byte j of each
    (selector sel(j)) and decodes. -> ([8 g, 4 t, 4 j, 2] uint32,
    [2 loads, 32 lanes] bank of each read)."""
    tile = pairs_tile(packed, 128)
    regs = np.zeros((8, 4, 4, 2), np.uint32)
    banks = np.zeros((2, 32), np.int64)
    for g in range(8):
        for t in range(4):
            cc, wb = (wn0 + 4 * g) >> 4, 4 * (g & 3)
            words = []
            for i, r in enumerate(rows(t)):
                a = pairs_offset(r, cc, 8) + wb + 8 * s * 128
                words.append(tile[a:a + 4].view(np.uint32)[0])
                banks[i, 4 * g + t] = (a // 4) % 32
            for j in range(4):
                two = byte_perm(words[0], words[1], sel(j))
                regs[g, t, j] = nibbles_to_bf16x2(two)
    return regs, banks


def bf16_wanted(packed, wn0, s):
    """The m16n8k16 .col B operand of unpack_pairs(packed) in bf16: b0b1 =
    k 2t, 2t + 1, b2b3 = k 2t + 8, 2t + 9 of step s, column g of n-tile j
    (warp column wn0 + 4 g + j); the lower k in the lower half."""
    w = tg.unpack_pairs(torch.from_numpy(packed.view(np.int8))).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    out = np.zeros((8, 4, 4, 2), np.uint32)
    for g in range(8):
        for t in range(4):
            for j in range(4):
                col = w[:, wn0 + 4 * g + j].astype(np.uint32)
                for half in range(2):
                    k = 16 * s + 8 * half + 2 * t
                    out[g, t, j, half] = col[k] | (col[k + 1] << 16)
    return out


@pytest.mark.parametrize("s", [0, 3, 7])
def test_bf16_b_fragments_from_the_pairs_tile(s):
    """Every warp: the registers are the bf16 .col operand of
    unpack_pairs; each of the two loads touches every bank at most twice
    (rows t = 0, 1 and 2, 3 share a swizzle mask: a 2-way conflict)."""
    p = _packed(50 + s, 128)
    for wn0 in range(0, 128, 32):
        regs, banks = bf16_fragments(p, wn0, s)
        assert np.array_equal(regs, bf16_wanted(p, wn0, s))
        for b in banks:
            assert np.bincount(b, minlength=32).max() <= 2


@pytest.mark.parametrize("name,kw", [
    ("the s8 rows 2t / 2t + 1", {"rows": lambda t: (2 * t, 2 * t + 1)}),
    ("rows t / t + 8", {"rows": lambda t: (t, t + 8)}),
    ("bytes j, j + 1", {"sel": lambda j: j | (j + 1) << 4}),
])
def test_bf16_b_fragments_mutated_fail(name, kw):
    """Wrong rows or a wrong byte pairing give another operand."""
    p = _packed(60, 128)
    regs, _ = bf16_fragments(p, 32, 1, **kw)
    assert not np.array_equal(regs, bf16_wanted(p, 32, 1))
