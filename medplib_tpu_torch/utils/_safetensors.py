"""The safetensors file format, read and written without the `safetensors`
package: an 8-byte little-endian header length, a JSON header ({name:
{"dtype", "shape", "data_offsets": [begin, end]}}, optionally
"__metadata__" of strings) padded with spaces to 8 bytes, then the tensors'
raw little-endian bytes, back to back. bf16 is written from the tensor's
bytes (`view(torch.uint8)`), which numpy could not hold.
"""

from __future__ import annotations

import json
import struct
import sys
from typing import Dict, Mapping, Optional

import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _check_byteorder() -> None:
    if sys.byteorder != "little":
        raise RuntimeError("safetensors holds little-endian bytes; this "
                           "host is big-endian")


def _raw(t: torch.Tensor) -> bytes:
    t = t.detach().to("cpu").contiguous().reshape(-1)
    if t.numel() == 0:
        return b""
    return t.view(torch.uint8).numpy().tobytes()


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write `tensors` (any device, any layout) as one safetensors file."""
    _check_byteorder()
    header: Dict[str, dict] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs, off = [], 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors "
                             f"name")
        raw = _raw(t)
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def read_header(path: str):
    """-> (header dict without __metadata__, metadata or None, the byte
    offset where the data starts)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    meta = header.pop("__metadata__", None)
    return header, meta, 8 + n


def load_file(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, in its stored dtype, on
    `device`."""
    _check_byteorder()
    header, _, start = read_header(path)
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        for name, h in sorted(header.items(),
                              key=lambda kv: kv[1]["data_offsets"][0]):
            b0, b1 = h["data_offsets"]
            dtype, shape = _DTYPES[h["dtype"]], tuple(h["shape"])
            nbytes = (torch.Size(shape).numel()
                      * torch.empty((), dtype=dtype).element_size())
            if b1 - b0 != nbytes or start + b1 > size:
                raise ValueError(f"{path}: {name} holds {b1 - b0} bytes at "
                                 f"{b0}, its dtype and shape need {nbytes}")
            if nbytes == 0:
                out[name] = torch.empty(shape, dtype=dtype, device=device)
                continue
            buf = bytearray(nbytes)
            f.seek(start + b0)
            f.readinto(buf)
            t = torch.frombuffer(buf, dtype=torch.uint8).view(dtype)
            out[name] = t.reshape(shape).to(device)
    return out
