"""A PNG codec on zlib and numpy, so that the serving wire format needs no
Pillow.

decode_rgb reads 8-bit non-interlaced PNGs of color types 0 (gray, also
at 1 / 2 / 4 bits), 2 (RGB), 3 (palette, also at 1 / 2 / 4 bits), 4 (gray
+ alpha) and 6 (RGBA), with all five row filters, and returns the [H, W,
3] uint8 array that Pillow's `Image.open(...).convert("RGB")` gives: gray
replicated (scaled to 8 bits as Pillow scales 1 / 2 / 4-bit gray), palette
entries looked up, alpha dropped. Other PNGs (16-bit, interlaced) raise
`Unsupported`. encode writes uint8 [H, W] / [H, W, 3] / [H, W, 4] arrays
as gray / RGB / RGBA PNGs (filter None on every row), as Pillow's
`Image.fromarray(a).save(..., "PNG")` maps them.

Rows filtered with None, Sub or Up are undone one row at a time with
whole-row numpy operations. Average and Paeth depend on the pixel to the
left, so an image with such rows is undone along anti-diagonals of pixels
(each depends only on the two diagonals before it): H + W - 1 steps, each
vectorized over the diagonal.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class Unsupported(ValueError):
    """A valid PNG this codec does not read (16-bit, interlaced)."""


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError("truncated PNG chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"bad CRC in PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG without IEND")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(ftype, data, bpp):
    """Filters None / Sub / Up only: row by row."""
    h, stride = data.shape
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for r in range(h):
        x = data[r].astype(np.int64)
        f = ftype[r]
        if f == 1:
            x = np.cumsum(x.reshape(-1, bpp), axis=0).reshape(-1)
        elif f == 2:
            x = x + prev
        prev = x & 255
        out[r] = prev
    return out


def _unfilter_diagonals(ftype, data, bpp):
    """Any filters: pixels along anti-diagonals r + c = d, in a skewed
    layout where each diagonal is a row: t[d + 2, r + 1] holds pixel
    (r, d - r), zero outside the image, so a diagonal's left, up and
    up-left neighbours are slices of the two rows before it."""
    h, stride = data.shape
    w = stride // bpp
    rr, cc = np.mgrid[:h, :w]
    x = np.zeros((h + w - 1, h, bpp), np.int16)
    x[rr + cc, rr] = data.reshape(h, w, bpp)
    t = np.zeros((h + w + 1, h + 1, bpp), np.int16)
    f = ftype.astype(np.int16)[:, None]
    for d in range(h + w - 1):
        lo, hi = max(0, d - w + 1), min(h, d + 1)
        a, b, c = t[d + 1, lo + 1:hi + 1], t[d + 1, lo:hi], t[d, lo:hi]
        fr = f[lo:hi]
        pred = np.where(fr == 1, a, np.where(fr == 2, b, np.where(
            fr == 3, (a + b) >> 1, np.where(fr == 4, _paeth(a, b, c), 0))))
        t[d + 2, lo + 1:hi + 1] = (x[d, lo:hi] + pred) & 255
    return t[rr + cc + 2, rr + 1].reshape(h, stride).astype(np.uint8)


def _unpack_bits(rows, depth, n):
    """[H, stride] bytes of `depth`-bit samples -> [H, n] uint8 values."""
    if depth == 8:
        return rows[:, :n]
    per = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(rows.shape[0], rows.shape[1] * per)[:, :n]


def decode_rgb(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 3] uint8, as Pillow's convert("RGB")."""
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, comp, filt, interlace = header
    if ctype not in _CHANNELS or comp or filt:
        raise ValueError(f"invalid PNG header {header}")
    if interlace or depth == 16:
        raise Unsupported(f"PNG with bit depth {depth}, interlace "
                          f"{interlace}")
    if depth != 8 and ctype not in (0, 3):
        raise ValueError(f"invalid PNG bit depth {depth} for color type "
                         f"{ctype}")
    ch = _CHANNELS[ctype]
    stride = (w * ch * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError("truncated PNG image data")
    raw = raw[:h * (stride + 1)].reshape(h, stride + 1)
    ftype, body = raw[:, 0], raw[:, 1:]
    if int(ftype.max(initial=0)) > 4:
        raise ValueError("invalid PNG row filter")
    bpp = max(1, ch * depth // 8)
    if int(ftype.max(initial=0)) <= 2:
        rows = _unfilter_rows(ftype, body, bpp)
    else:
        rows = _unfilter_diagonals(ftype, body, bpp)
    px = _unpack_bits(rows, depth, w * ch).reshape(h, w, ch)
    if ctype == 3:
        if palette is None or int(px.max(initial=0)) >= len(palette):
            raise Unsupported("palette index outside the PNG's PLTE")
        return palette[px[..., 0]]
    if ctype in (0, 4):
        gray = px[..., 0]
        if depth < 8:
            gray = (gray * (255 // ((1 << depth) - 1))).astype(np.uint8)
        return np.repeat(gray[..., None], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode(image: np.ndarray, level: int = 6) -> bytes:
    """uint8 [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4] (RGBA) -> PNG."""
    a = np.ascontiguousarray(image, np.uint8)
    ctype = {2: 0, 3: {3: 2, 4: 6}.get(a.shape[-1])}.get(a.ndim)
    if ctype is None:
        raise ValueError(f"no PNG color type for shape {a.shape}")
    h, w = a.shape[:2]
    rows = a.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))
