"""Token sampling: temperature + nucleus (top-p) filtering
(medplib_tpu/ops/sampling.py).

The filter is the JAX package's: logits / max(t, 1e-6) in float32, a
descending sort, softmax and cumsum; token k is kept iff the mass before it
is < max(top_p, 1e-9), and the cutoff is by value, so tied logits are all
kept. Rows whose temperature is below 1e-4 take the exact argmax of the raw
logits. `temperature` and `top_p` are Python numbers or per-row tensors
([B] or [B, 1]).

The draw is jax.random.categorical's: argmax(filtered + g) with g Gumbel
noise. The noise comes from per-row counter-based streams instead of
threefry keys: a row's state is (key, step) in a [B, 2] int64 tensor, and
its noise is an integer hash of (key, step, vocab index) computed with
torch ops on the logits' device. So a row's tokens depend on its own seed
alone (never on what else shares the batch), the CPU and the card draw the
same bits, and the decode loop needs no host sync.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

_M32 = 0xFFFFFFFF
_GOLDEN = 0x1E3779B9           # < 2**31, as every multiplier below


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mixer on int64 tensors holding values in
    [0, 2**32). Its multipliers are below 2**31, so no product overflows
    int64 and every op is exact on any device."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def _mix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _hash32(a ^ _hash32(b + _GOLDEN))


Seed = Union[None, int, Sequence[int], torch.Tensor]


def row_keys(rng: Seed, b: int, device="cuda") -> torch.Tensor:
    """[B, 2] int64 per-row stream states (key, step = 0).

    rng: None (seed 0), an int seed (row r's stream comes from (seed, r)),
    B per-row seeds (a sequence or a [B] tensor: row r's stream comes from
    its seed alone), or a [B, 2] state, returned as it is."""
    if isinstance(rng, torch.Tensor) and rng.dim() == 2:
        return rng
    if rng is None or isinstance(rng, int):
        s = torch.tensor(int(rng or 0), dtype=torch.int64, device=device)
        seeds = _mix(_hash32(s & _M32) ^ (s >> 32),
                     torch.arange(b, dtype=torch.int64, device=device))
    else:
        seeds = torch.as_tensor(rng, dtype=torch.int64).to(device)
        if seeds.shape != (b,):
            raise ValueError(f"expected {b} per-row seeds, got shape "
                             f"{tuple(seeds.shape)}")
        seeds = _mix(seeds & _M32, (seeds >> 32) & _M32)
    return torch.stack([seeds, torch.zeros_like(seeds)], dim=1)


def split_rows(keys: torch.Tensor):
    """Advance [B, 2] row streams one step -> (new_keys, this step's
    keys)."""
    return torch.stack([keys[:, 0], keys[:, 1] + 1], dim=1), keys


def gumbel_rows(keys: torch.Tensor, n: int) -> torch.Tensor:
    """[B, 2] step keys -> [B, n] float32 Gumbel noise: 23 random bits per
    element from the hash of (key, step, index), u = (bits + 0.5) / 2**23
    (exact in float32, inside (0, 1)), g = -log(-log(u))."""
    step_key = _mix(keys[:, 0], keys[:, 1])[:, None]
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    bits = _mix(step_key, idx) >> 9
    u = (bits.to(torch.float32) + 0.5) * (1.0 / (1 << 23))
    return -torch.log(-torch.log(u))


def per_row(v, device) -> torch.Tensor:
    """A number or a [B] / [B, 1] value -> a float32 tensor on `device`
    that broadcasts against [B, V]. A number is filled on the device and a
    tensor already there is not copied, so neither syncs the host."""
    if isinstance(v, (int, float)):
        return torch.full((1, 1), float(v), device=device)
    t = torch.as_tensor(v, dtype=torch.float32).to(device)
    return t[:, None] if t.dim() == 1 else t


def sample_token(keys: torch.Tensor, logits: torch.Tensor,
                 temperature=1.0, top_p=1.0) -> torch.Tensor:
    """Sample one token per row of [B, V] logits with the rows' step keys
    [B, 2] (split_rows' second output)."""
    t = per_row(temperature, logits.device)
    raw = logits.float()
    x = raw / t.clamp(min=1e-6)
    sorted_x = torch.sort(x, dim=-1, descending=True).values
    probs = torch.softmax(sorted_x, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < per_row(top_p, logits.device).clamp(min=1e-9)
    min_kept = torch.where(keep, sorted_x,
                           torch.full_like(sorted_x, float("inf"))
                           ).amin(dim=-1, keepdim=True)
    filtered = torch.where(x >= min_kept, x,
                           torch.full_like(x, float("-inf")))
    sampled = torch.argmax(filtered + gumbel_rows(keys, x.shape[-1]), dim=-1)
    greedy_rows = torch.broadcast_to(t, raw.shape)[:, 0] < 1e-4
    return torch.where(greedy_rows, torch.argmax(raw, dim=-1), sampled)


def select_token(logits: torch.Tensor, keys: Optional[torch.Tensor],
                 do_sample: bool, temperature, top_p) -> torch.Tensor:
    """Greedy argmax (do_sample=False: no sort, no noise) or temperature /
    top-p sampling."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    return sample_token(keys, logits, temperature, top_p)
