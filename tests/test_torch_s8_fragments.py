"""The B fragments of K8's s8 tensor-core kernel
(medplib_tpu_torch/csrc/s8_mma.cuh), modelled byte for byte in numpy.

The kernel cannot run here, so its transpose selectors are read from the
header and the byte permutes it performs are replayed on whole warp tiles
of an int8 [K, N] weight, as the lanes read them from the swizzled shared
tile. Each lane's two registers per n-tile must be what mma.m16n8k32 .s8
takes as its .col B operand under the column map (n-tile j's column g is
warp column 4 g + j); a mutated selector must fail. The transposed [N, K]
weight, read by ldmatrix from rows the loader permutes, is modelled the
same way. The swizzles and the permutation are mirrored from the header
(not read from it); the model also checks that every load phase of the
[K, N] tile hits 32 distinct banks.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from test_torch_int8_decode import byte_perm

HEADER = (Path(__file__).resolve().parents[1] / "medplib_tpu_torch" / "csrc"
          / "s8_mma.cuh")
NAMES = ("kPairLo", "kPairHi", "kHalfLo", "kHalfHi")
STAGE_K = 128   # int8 k a pipeline stage (128-byte rows)


def _selectors():
    text = HEADER.read_text()
    out = {}
    for name in NAMES:
        m = re.search(rf"constexpr\s+uint32_t\s+{name}\s*=\s*"
                      r"(0x[0-9A-Fa-f]+)u;", text)
        assert m, f"{name} not found in {HEADER.name}"
        out[name] = np.uint32(int(m.group(1), 16))
    return out


def transpose4x4(w, sel):
    """transpose4x4: the words of four k rows -> the B words of n-tiles
    0..3, with the header's byte permutes."""
    x0 = byte_perm(w[0], w[1], sel["kPairLo"])
    x1 = byte_perm(w[0], w[1], sel["kPairHi"])
    y0 = byte_perm(w[2], w[3], sel["kPairLo"])
    y1 = byte_perm(w[2], w[3], sel["kPairHi"])
    return [byte_perm(x0, y0, sel["kHalfLo"]),
            byte_perm(x0, y0, sel["kHalfHi"]),
            byte_perm(x1, y1, sel["kHalfLo"]),
            byte_perm(x1, y1, sel["kHalfHi"])]


def kn_tile(w_kn, bn):
    """KNLoader: 128 k rows x bn bytes, 16-byte chunk c of row r at chunk
    c ^ (2 ((r >> 2) & 3)) of the row's bn / 16."""
    cpr = bn // 16
    tile = np.zeros((STAGE_K, bn), np.uint8)
    for r in range(STAGE_K):
        swz = (2 * ((r >> 2) & 3)) & (cpr - 1)
        for c in range(cpr):
            p = c ^ swz
            tile[r, 16 * p:16 * p + 16] = w_kn[r, 16 * c:16 * c + 16]
    return tile.reshape(-1)


def kn_fragments(w_kn, bn, wn0, s, sel):
    """The registers of k-step s for the warp at columns wn0: lane (g, t)
    reads the words of k rows 32 s + 4 t + c and 32 s + 16 + 4 t + c at
    the kernel's b_off, and transposes each four.
    -> ([8 g, 4 t, 4 j, 2] uint32, [8 loads, 32 lanes] bank of each read)."""
    cpr = bn // 16
    tile = kn_tile(w_kn, bn)
    regs = np.zeros((8, 4, 4, 2), np.uint32)
    banks = np.zeros((8, 32), np.int64)
    for g in range(8):
        for t in range(4):
            off = ((32 * s + 4 * t) * bn
                   + ((((wn0 + 4 * g) >> 4) ^ (2 * t & (cpr - 1))) << 4)
                   + 4 * (g & 3))
            for half in range(2):
                words = []
                for c in range(4):
                    a = off + (16 * half + c) * bn
                    words.append(tile[a:a + 4].view(np.uint32)[0])
                    banks[4 * half + c, 4 * g + t] = (a // 4) % 32
                for j, b in enumerate(transpose4x4(words, sel)):
                    regs[g, t, j, half] = b
    return regs, banks


def perm_row(r):
    """ATileLoader<.., PERM>: tile row 32 G + 4 g + j at smem row
    32 G + 8 j + g."""
    return (r & ~31) | ((r & 3) << 3) | ((r >> 2) & 7)


def nk_fragments(w_nk, s):
    """The transposed weight: the tile holds weight rows (output columns)
    of 128 k bytes at their permuted smem rows; ldmatrix.x4 at
    a_frag_offset(16 h, s) gives lane (g, t) 4 bytes of row g of each of
    its four 8-row matrices: smem rows 16 h + 8 (i & 1) + g at k bytes
    32 s + 16 (i >> 1) + 4 t. Registers {r0, r2} are n-tile 2 h's
    (b0, b1), {r1, r3} n-tile 2 h + 1's. -> [8 g, 4 t, 4 j, 2] uint32."""
    smem = np.zeros((32, STAGE_K), np.uint8)
    for r in range(32):
        smem[perm_row(r)] = w_nk[r]
    regs = np.zeros((8, 4, 4, 2), np.uint32)
    for h in range(2):
        for g in range(8):
            for t in range(4):
                r = [smem[16 * h + 8 * (i & 1) + g,
                          32 * s + 16 * (i >> 1) + 4 * t:
                          32 * s + 16 * (i >> 1) + 4 * t + 4]
                     .view(np.uint32)[0] for i in range(4)]
                regs[g, t, 2 * h] = (r[0], r[2])
                regs[g, t, 2 * h + 1] = (r[1], r[3])
    return regs


def wanted(w_kn, wn0, s):
    """What mma.m16n8k32 takes: b0 = k 4t..4t+3, b1 = k 16+4t.. of B
    column g of n-tile j, which is warp column wn0 + 4 g + j; byte i holds
    k 4t + i. -> [8 g, 4 t, 4 j, 2] uint32."""
    out = np.zeros((8, 4, 4, 2), np.uint32)
    for g in range(8):
        for t in range(4):
            for j in range(4):
                col = w_kn[:, wn0 + 4 * g + j]
                for half in range(2):
                    k = 32 * s + 16 * half + 4 * t
                    out[g, t, j, half] = np.ascontiguousarray(
                        col[k:k + 4]).view(np.uint32)[0]
    return out


def _weight(seed, n):
    """One stage of a random int8 weight [128 k, n] as bytes, with -128
    and 127 in it."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-128, 128, size=(STAGE_K, n))
    w[3, :] = -128
    w[:, 5] = 127
    return w.astype(np.int8).view(np.uint8)


@pytest.mark.parametrize("bn", [128, 64])
@pytest.mark.parametrize("s", [0, 1, 2, 3])
def test_kn_fragments_hold_the_mma_b_operand(bn, s):
    """Every warp of the block tile, k-step s: the byte transpose of the
    words the lanes read from the swizzled [K, N] tile gives exactly the
    m16n8k32 .col registers, and each of the eight loads reads 32 distinct
    banks (bn = 128; the 64-column decode tile pairs its t two by two)."""
    sel = _selectors()
    w = _weight(bn + s, bn)
    for wn0 in range(0, bn, 32):
        regs, banks = kn_fragments(w, bn, wn0, s, sel)
        assert np.array_equal(regs, wanted(w, wn0, s))
        distinct = [len(set(b)) for b in banks]
        assert min(distinct) == (32 if bn == 128 else 16)


@pytest.mark.parametrize("s", [0, 1, 2, 3])
def test_nk_fragments_hold_the_mma_b_operand(s):
    """The transposed weight (32 output columns of one warp, 128 k bytes
    each): the permuted rows and one ldmatrix.x4 per n-tile pair give the
    same registers under the same column map."""
    w_nk = _weight(10 + s, 32).T.copy()           # [32 columns, 128 k]
    assert np.array_equal(nk_fragments(w_nk, s),
                          wanted(np.ascontiguousarray(w_nk.T), 0, s))


def test_header_selectors():
    assert _selectors() == {"kPairLo": 0x5140, "kPairHi": 0x7362,
                            "kHalfLo": 0x5410, "kHalfHi": 0x7632}


MUTATIONS = {
    "pairs swapped": {"kPairLo": np.uint32(0x4051)},
    "high pair from the low bytes": {"kPairHi": np.uint32(0x5140)},
    "halves of the other word": {"kHalfLo": np.uint32(0x1054)},
    "high half low": {"kHalfHi": np.uint32(0x3276)},
    "sign-replicating byte": {"kHalfLo": np.uint32(0x5418)},
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutated_selector_fails(name):
    """The fragment check catches each wrong selector."""
    sel = dict(_selectors(), **MUTATIONS[name])
    w = _weight(0, 128)
    regs, _ = kn_fragments(w, 128, 32, 1, sel)
    assert not np.array_equal(regs, wanted(w, 32, 1))
