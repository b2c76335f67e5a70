"""Serving wire protocol (medplib_tpu/serve/protocol.py): JSON bodies,
streamed chunks separated by NUL bytes, masks shipped as sparse nonzero
[y, x] coordinates, base64 PNG images in requests. The same constants
and payloads, so a client or controller of the JAX package talks to this
package's worker unchanged.

PNG goes through the package's own codec (serve/png.py), so the worker
path needs no Pillow. Other image formats, and PNG variants the codec
does not read (16-bit, interlaced), are decoded by Pillow, imported in
the call; without Pillow they raise.
"""

from __future__ import annotations

import base64
import io
import json
from typing import List, Tuple

import numpy as np

from medplib_tpu_torch.serve import png

HEARTBEAT_WORKER_INTERVAL = 15
HEARTBEAT_EXPIRATION = 30
STREAM_DELIMITER = b"\0"

ERROR_CODE_OK = 0
ERROR_CODE_OVERLOAD = 1
ERROR_CODE_ERROR = 2


def encode_sparse_mask(mask: np.ndarray) -> Tuple[List[List[int]], int, int]:
    """Binary mask -> (nonzero [y, x] coords, height, width)."""
    h, w = mask.shape
    coords = np.transpose(np.nonzero(mask)).tolist()
    return coords, h, w


def decode_sparse_mask(coords: List[List[int]], height: int,
                       width: int) -> np.ndarray:
    mask = np.zeros((height, width), np.uint8)
    if coords:
        arr = np.asarray(coords, np.int64)
        mask[arr[:, 0], arr[:, 1]] = 1
    return mask


def encode_image_b64(image_rgb: np.ndarray) -> str:
    return base64.b64encode(png.encode(image_rgb.astype(np.uint8))).decode()


def _pillow_rgb(raw: bytes, why: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{why}: decoding it needs Pillow, which is not "
                           f"installed (PNG of 8 bits or fewer, not "
                           f"interlaced, needs none)") from None
    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))


def decode_image_b64(data: str) -> np.ndarray:
    """base64 image -> [H, W, 3] uint8 RGB."""
    raw = base64.b64decode(data)
    if raw[:8] != png.SIGNATURE:
        return _pillow_rgb(raw, "the image is not a PNG")
    try:
        return png.decode_rgb(raw)
    except png.Unsupported as e:
        return _pillow_rgb(raw, str(e))


def stream_chunks(raw: bytes):
    """Split a NUL-delimited response body into JSON chunks."""
    for part in raw.split(STREAM_DELIMITER):
        if part:
            yield json.loads(part)
