"""The int8 -> bf16 weight decode of the tensor-core kernel
(medplib_tpu_torch/csrc/int8w_mma.cuh), modelled bit for bit in numpy.

The kernel cannot run here, so its decode constants are read from the
header and the exact bit operations it performs on them (the XOR, the
byte permute into the f32 magic, the f32 subtraction, the high-half pack,
the selectors that pick each n-tile's byte) are replayed on every int8
value and on whole B-fragment tiles in both weight layouts. Mutated
constants, among them the bf16 0x4300 route of the int4 nibbles, must
fail the same check.
"""

import re
from pathlib import Path

import numpy as np
import pytest

HEADER = (Path(__file__).resolve().parents[1] / "medplib_tpu_torch" / "csrc"
          / "int8w_mma.cuh")
NAMES = ("kI8Flip", "kI8Magic", "kI8Sel", "kI8Bias", "kI8Pack")


def _constants():
    text = HEADER.read_text()
    out = {}
    for name in NAMES:
        m = re.search(rf"constexpr\s+\w+\s+{name}\s*=\s*"
                      r"(0x[0-9A-Fa-f]+|[0-9.]+)[uf]?;", text)
        assert m, f"{name} not found in {HEADER.name}"
        v = m.group(1)
        out[name] = np.float32(float(v)) if name == "kI8Bias" else \
            np.uint32(int(v, 16))
    return out


def byte_perm(x, y, s):
    """__byte_perm(x, y, s) (PRMT default mode), elementwise on uint32:
    result byte i is byte (s >> 4i) & 7 of the pool (x, y), or that byte's
    sign replicated when bit 3 of the selector nibble is set."""
    x, y = np.asarray(x, np.uint64), np.asarray(y, np.uint64)
    s = np.broadcast_to(np.asarray(s, np.uint64), np.broadcast(x, y).shape)
    pool = x | (y << np.uint64(32))
    out = np.zeros(np.broadcast(x, y, s).shape, np.uint64)
    for i in range(4):
        n = (s >> np.uint64(4 * i)) & np.uint64(0xF)
        b = (pool >> (np.uint64(8) * (n & np.uint64(7)))) & np.uint64(0xFF)
        sign = np.where(b & np.uint64(0x80), np.uint64(0xFF), np.uint64(0))
        b = np.where(n & np.uint64(8), sign, b)
        out |= b << np.uint64(8 * i)
    return out.astype(np.uint32)


def i8_f32(flipped, sel, c):
    """i8_f32: the f32 bits of the magic word minus the bias (f32, RN)."""
    bits = byte_perm(flipped, c["kI8Magic"], sel)
    return bits.view(np.float32) - c["kI8Bias"]


def bf16x2_of(lo, hi, c):
    return byte_perm(np.asarray(lo, np.float32).view(np.uint32),
                     np.asarray(hi, np.float32).view(np.uint32), c["kI8Pack"])


def bf16_bits(v):
    """bf16 bits of small integers (exact: the low 16 f32 bits are 0)."""
    f = np.asarray(v, np.float32).view(np.uint32)
    assert not (f & np.uint32(0xFFFF)).any()
    return (f >> np.uint32(16)).astype(np.uint32)


def words(b):
    """int8 [..., 4] -> uint32 [...], byte j at bits 8j."""
    return np.ascontiguousarray(b.astype(np.int8)).view(np.uint32)[..., 0]


def normal_fragments(wt, c):
    """B registers of a 16 k x 32 column warp tile of an int8 [K, N]
    weight: lane (g, t) reads the words of k rows 2t, 2t+1, 2t+8, 2t+9 at
    columns 4g .. 4g+3, XORs each, and decodes byte j for n-tile j.
    -> [8 g, 4 t, 4 j, 2 registers] uint32."""
    out = np.zeros((8, 4, 4, 2), np.uint32)
    for g in range(8):
        for t in range(4):
            u = [words(wt[r, 4 * g:4 * g + 4]) ^ c["kI8Flip"]
                 for r in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)]
            for j in range(4):
                sel = c["kI8Sel"] | np.uint32(j)
                out[g, t, j, 0] = bf16x2_of(i8_f32(u[0], sel, c),
                                            i8_f32(u[1], sel, c), c)
                out[g, t, j, 1] = bf16x2_of(i8_f32(u[2], sel, c),
                                            i8_f32(u[3], sel, c), c)
    return out


def transposed_fragments(wt, c):
    """The same from the [N, K] layout: lane (g, t), n-tile j reads the
    words at bytes 4 (t >> 1) and 8 + 4 (t >> 1) of column 4g + j's 16 k,
    and decodes bytes 2 (t & 1) and 2 (t & 1) + 1 of each."""
    w_nk = np.ascontiguousarray(wt.T)                   # [32 cols, 16 k]
    out = np.zeros((8, 4, 4, 2), np.uint32)
    for g in range(8):
        for t in range(4):
            sel0 = c["kI8Sel"] | np.uint32(2 * (t & 1))
            sel1 = sel0 + np.uint32(1)
            for j in range(4):
                row = w_nk[4 * g + j]
                lo = words(row[4 * (t >> 1):4 * (t >> 1) + 4]) ^ c["kI8Flip"]
                hi = words(row[8 + 4 * (t >> 1):12 + 4 * (t >> 1)]) \
                    ^ c["kI8Flip"]
                out[g, t, j, 0] = bf16x2_of(i8_f32(lo, sel0, c),
                                            i8_f32(lo, sel1, c), c)
                out[g, t, j, 1] = bf16x2_of(i8_f32(hi, sel0, c),
                                            i8_f32(hi, sel1, c), c)
    return out


def wanted_fragments(wt):
    """What mma.m16n8k16 wants: b0 = (k 2t, 2t+1), b1 = (2t+8, 2t+9) of
    B column g of n-tile j, which is warp column 4g + j; lower k in the low
    half."""
    out = np.zeros((8, 4, 4, 2), np.uint32)
    for g in range(8):
        for t in range(4):
            for j in range(4):
                col = wt[:, 4 * g + j]
                for r, k in enumerate((2 * t, 2 * t + 8)):
                    lo, hi = bf16_bits(col[k]), bf16_bits(col[k + 1])
                    out[g, t, j, r] = lo | (hi << np.uint32(16))
    return out


def _all_bytes_decode(c):
    """Every int8 value at every byte position j of a word: -> (got, want)
    bf16 bits of the pairs (word a byte j, word b byte j)."""
    vals = np.arange(-128, 128, dtype=np.int64)
    got, want = [], []
    for j in range(4):
        for shift in range(4):
            a = np.zeros((256, 4), np.int64)
            b = np.zeros((256, 4), np.int64)
            a[:, j] = vals
            b[:, j] = np.roll(vals, 37 * shift + 1)
            # the other bytes carry other values, which must not leak in
            a[:, (j + 1) % 4] = np.roll(vals, 5)
            b[:, (j + 2) % 4] = -128
            sel = c["kI8Sel"] | np.uint32(j)
            ua, ub = words(a) ^ c["kI8Flip"], words(b) ^ c["kI8Flip"]
            got.append(bf16x2_of(i8_f32(ua, sel, c), i8_f32(ub, sel, c), c))
            want.append(bf16_bits(a[:, j]) | (bf16_bits(b[:, j])
                                              << np.uint32(16)))
    return np.concatenate(got), np.concatenate(want)


def test_header_constants_are_the_f32_route():
    c = _constants()
    assert c["kI8Flip"] == 0x80808080 and c["kI8Magic"] == 0x4B000000
    assert c["kI8Sel"] == 0x7650 and c["kI8Pack"] == 0x7632
    assert c["kI8Bias"] == np.float32(2.0 ** 23 + 128)


def test_decode_is_exact_for_every_byte():
    """Each of the 256 int8 values, -128 and 127 included, at each byte
    position, decodes to the bf16 bits of that integer."""
    got, want = _all_bytes_decode(_constants())
    assert np.array_equal(got, want)


@pytest.mark.parametrize("layout", ["normal", "transposed"])
def test_fragments_hold_the_mma_b_operand(layout):
    """A random int8 warp tile (16 k x 32 columns, with -128 and 127):
    every lane's two B registers of every n-tile hold exactly the bf16
    weights mma.m16n8k16 expects under the column map 4g + j."""
    c = _constants()
    rng = np.random.default_rng(0)
    wt = rng.integers(-128, 128, size=(16, 32))
    wt[0, :] = -128
    wt[:, 5] = -128
    wt[9, ::3] = 127
    fn = normal_fragments if layout == "normal" else transposed_fragments
    assert np.array_equal(fn(wt, c), wanted_fragments(wt))


MUTATIONS = {
    # the bf16 nibble magic of int4h (0x4300 | u = 128 + u) in the f32
    # word's high half: u has 8 bits, bf16 keeps 7 after the leading one
    "0x4300 magic": {"kI8Magic": np.uint32(0x43000000),
                     "kI8Bias": np.float32(128.0 + 128 * 2.0 ** -16)},
    "no sign flip": {"kI8Flip": np.uint32(0)},
    "bias without the 128": {"kI8Bias": np.float32(2.0 ** 23)},
    "low halves packed": {"kI8Pack": np.uint32(0x5410)},
    "byte j + 1": {"kI8Sel": np.uint32(0x7651)},
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutated_constants_fail(name):
    """The exactness check catches each wrong constant."""
    c = dict(_constants(), **MUTATIONS[name])
    got, want = _all_bytes_decode(c)
    assert not np.array_equal(got, want)


def test_bf16_nibble_route_fails_on_a_whole_byte():
    """K9's nibble route widened to a byte, bf16 0x4300 | (byte ^ 0x80)
    minus 256, is wrong for every positive byte (flipped value > 128)."""
    vals = np.arange(-128, 128, dtype=np.int64)
    u = (vals & 0xFF) ^ 0x80
    bits = (np.uint32(0x4300) | u.astype(np.uint32)) << np.uint32(16)
    dec = bits.view(np.float32) - np.float32(256.0)
    wrong = dec != vals.astype(np.float32)
    assert wrong.any() and not wrong[u < 128].any()
