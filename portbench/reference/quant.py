"""The benchmark's own frozen copy of the serving quantization, as plain
float32 arithmetic: what an int8 / int4 weight means after it is stored.

int8: symmetric, one scale per output channel (absmax / 127 over the
input axis). int4 "halves" (int4h): `groups` contiguous scale groups along
the input axis, absmax / 7, values clamped to [-8, 7]. Each function takes
the float weight and returns the float32 weight that the stored integers
and scales stand for.
"""

from __future__ import annotations

import torch


def int8_channel(w: torch.Tensor, in_axis: int) -> torch.Tensor:
    w = w.float()
    scale = w.abs().amax(dim=in_axis, keepdim=True) * (1 / 127)
    q = torch.round(w / scale.clamp(min=1e-12)).clamp(-127, 127)
    return q * scale


def int4_groups(w: torch.Tensor, in_axis: int, groups: int) -> torch.Tensor:
    w = w.float()
    in_axis = in_axis % w.dim()
    k = w.shape[in_axis]
    shape = w.shape[:in_axis] + (groups, k // groups) + w.shape[in_axis + 1:]
    wb = w.reshape(shape)
    scale = wb.abs().amax(dim=in_axis + 1, keepdim=True) * (1 / 7)
    q = torch.round(wb / scale.clamp(min=1e-12)).clamp(-8, 7)
    return (q * scale).reshape(w.shape)


def linear_weight(w: torch.Tensor, in_axis: int, bits: int,
                  groups: int = 2) -> torch.Tensor:
    """A linear's weight stored in `bits` (8: per channel; 4: int4h with
    `groups` groups; 16: as it is), as float32."""
    if bits == 16:
        return w.float()
    if bits == 8:
        return int8_channel(w, in_axis)
    if bits == 4:
        return int4_groups(w, in_axis, groups)
    raise ValueError(f"no {bits}-bit form")


def padded_experts(w: torch.Tensor, m_axis: int, align: int,
                   groups: int) -> torch.Tensor:
    """An expert stack [E, K, N] (input axis 1) whose intermediate width M
    (axis 2 of gate / up, axis 1 of down) is zero-padded to a multiple of
    `align` before int4h quantization (the padding moves the group
    boundary of down), returned at the unpadded width."""
    m = w.shape[m_axis]
    pad = -m % align
    if pad:
        pads = [0, 0] * w.dim()
        pads[2 * (w.dim() - 1 - m_axis) + 1] = pad
        w = torch.nn.functional.pad(w.float(), pads)
    return int4_groups(w, 1, groups).narrow(m_axis, 0, m)
