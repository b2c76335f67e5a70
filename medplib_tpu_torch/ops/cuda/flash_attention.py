"""Causal flash attention with a [B, S] keep mask: forward (kernel K4) and
backward (kernels K5 dQ and K6 dK/dV), and the autograd function that ties
them together.

Counterpart of medplib_tpu/ops/pallas/flash_attention.py. The CUDA kernels
in csrc/flash_attention.cu replace its three Pallas kernels:

  flash_forward  (K4)  <- _flash_forward / _flash_kernel  (pallas_call :138)
  flash_dq       (K5)  <- _dq_kernel                       (pallas_call :306)
  flash_dkv      (K6)  <- _dkv_kernel                      (pallas_call :333)

Each wrapper runs its plain PyTorch version (`*_plain`, the same function
over the whole [T, S] score matrix in float32) on a CPU tensor; on a CUDA
tensor it launches its kernel or raises. Layouts are the model's:
q [B, T, H, D], k / v [B, S, H, D] with S >= T (queries are the last T
key positions), mask [B, S] int32 (> 0 keeps a key), lse / delta [B, H, T]
float32. The kernels take D = 128 in bfloat16 or float32; K4 also takes
q / k heads of 192 and v heads of 128 in bfloat16 (DeepSeek-V2's latent
attention in its expanded form; `flash_forward.launches_qk192` counts
them), with the softmax scale passed in (default D^-0.5).

What bounds the kernels on the H100, and what their design does about it,
is noted at the top of csrc/flash_attention.cu (compute bound): on f32
the three kernels run f32 FMA; on bf16 they run bf16 mma.sync on the
tensor cores, with P (K4, K6) and dS (K5, K6) split into hi + lo bf16
halves so that their products keep the reference's f32 precision.

Rows with no kept key: the plain forward averages v over every key
(p = exp(0) everywhere); the kernel, like the Pallas kernel, over the key
tiles its schedule processed. Both are finite, and the backward gives such
rows zero gradient on both sides (p = 0 where nothing is kept).
"""

from __future__ import annotations

from typing import Optional

import torch

from medplib_tpu_torch.ops.cuda.gmm import _check_cuda

NEG_INF = -2.3819763e38   # the JAX package's finite mask value
HEAD_DIM = 128            # the head size the CUDA kernels take
# (q / k, v) head sizes K4 also takes on bf16 (forward only)
FWD_DIMS = ((192, 128),)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _keep(mask: torch.Tensor, t: int, s: int) -> torch.Tensor:
    """[B, 1, T, S]: causal (query t sits at key position t + S - T) and the
    key mask."""
    rows = torch.arange(t, device=mask.device)[:, None] + (s - t)
    cols = torch.arange(s, device=mask.device)[None, :]
    return (rows >= cols)[None, None] & (mask[:, None, None, :] > 0)


def _scaled_q(q: torch.Tensor, scale: Optional[float] = None
              ) -> torch.Tensor:
    return q.float() * (q.shape[-1] ** -0.5 if scale is None else scale)


def _probs(q, k, mask, lse):
    """Backward probabilities p = keep ? exp(s - lse) : 0, [B, H, T, S]."""
    s = torch.einsum("bthd,bshd->bhts", _scaled_q(q), k.float())
    keep = _keep(mask, q.shape[1], k.shape[1])
    return torch.where(keep, torch.exp(s - lse[..., None]),
                       torch.zeros((), device=q.device))


def flash_forward_plain(q, k, v, mask, scale: Optional[float] = None):
    """Plain PyTorch version of K4 -> (out [B, T, H, Dv] q.dtype,
    lse [B, H, T] f32 of the scaled logits)."""
    s = torch.einsum("bthd,bshd->bhts", _scaled_q(q, scale), k.float())
    s = torch.where(_keep(mask, q.shape[1], k.shape[1]), s,
                    torch.full((), NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    lm = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)       # [B, H, T, 1]
    acc = torch.einsum("bhts,bshd->bthd", p, v.float())
    out = (acc / lm.permute(0, 2, 1, 3)).to(q.dtype)
    return out, (m + torch.log(lm))[..., 0]


def flash_dq_plain(q, k, v, mask, dout, lse, delta):
    """Plain PyTorch version of K5: dQ = (P * (dO V^T - delta)) K * scale."""
    p = _probs(q, k, mask, lse)
    dp = torch.einsum("bthd,bshd->bhts", dout.float(), v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhts,bshd->bthd", ds, k.float()) * q.shape[-1] ** -0.5
    return dq.to(q.dtype)


def flash_dkv_plain(q, k, v, mask, dout, lse, delta):
    """Plain PyTorch version of K6 -> (dK = dS^T (q scale), dV = P^T dO)."""
    p = _probs(q, k, mask, lse)
    dv = torch.einsum("bhts,bthd->bshd", p, dout.float())
    dp = torch.einsum("bthd,bshd->bhts", dout.float(), v.float())
    ds = p * (dp - delta[..., None])
    dk = torch.einsum("bhts,bthd->bshd", ds, _scaled_q(q))
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_shapes(q, k, v, mask, same_dims: bool = True):
    """same_dims=False (the forward): v's head size may differ from q's
    and k's."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            k.shape[:3] != v.shape[:3] or \
            (same_dims and k.shape != v.shape):
        raise ValueError(f"q [B, T, H, D] and k, v [B, S, H, D] expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, t, h, d = q.shape
    if k.shape[0] != b or k.shape[2:] != (h, d) or k.shape[1] < t:
        raise ValueError(f"k / v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (S >= T, same B, H, D)")
    if tuple(mask.shape) != (b, k.shape[1]):
        raise ValueError(f"mask {tuple(mask.shape)} must be [B, S]")


def fwd_dims_supported(q: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether K4 takes these head sizes on the card: D = 128 (bf16 or
    f32), or (q / k, v) in FWD_DIMS (bf16)."""
    dims = (q.shape[-1], v.shape[-1])
    return dims == (HEAD_DIM, HEAD_DIM) or (
        dims in FWD_DIMS and q.dtype == torch.bfloat16)


def _cuda_args(q, k, v, mask, extra=(), fwd: bool = False):
    """Validate the kernels' inputs on the card -> (lib, dims, dtype code,
    scale, stream). fwd: K4's head sizes (fwd_dims_supported), else
    D = 128."""
    if not q.is_cuda:
        raise ValueError(f"flash attention: unsupported device {q.device}")
    b, t, h, d = q.shape
    s = k.shape[1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"the flash kernels take bf16 or f32, not {q.dtype}")
    if not (fwd_dims_supported(q, v) if fwd else d == HEAD_DIM):
        raise ValueError(f"the flash kernels take head_dim {HEAD_DIM} (K4 "
                         f"also (q / k, v) {FWD_DIMS} in bf16), got "
                         f"({d}, {v.shape[-1]}) {q.dtype}")
    if b * h > 65535 or t < 1:
        raise ValueError(f"unsupported shape B*H={b * h}, T={t}")
    dev = q.device
    for name, x in (("q", q), ("k", k), ("v", v)) + tuple(extra):
        like = {"k": k, "v": v}.get(name, q)
        _check_cuda(name, x, q.dtype, like.shape, dev)
    _check_cuda("mask", mask, torch.int32, (b, s), dev)
    from medplib_tpu_torch.ops.cuda._build import load_library
    return (load_library(), (b, t, s, h), _DTYPES[q.dtype], d ** -0.5,
            torch.cuda.current_stream(dev).cuda_stream)


def flash_forward(q, k, v, mask, scale: Optional[float] = None):
    """Kernel K4 -> (out [B, T, H, Dv] q.dtype, lse [B, H, T] f32). scale:
    the softmax scale of the q . k sums (default D^-0.5)."""
    _check_shapes(q, k, v, mask, same_dims=False)
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, mask, scale)
    from medplib_tpu_torch.ops.cuda._build import check
    lib, (b, t, s, h), code, d_scale, stream = _cuda_args(q, k, v, mask,
                                                          fwd=True)
    scale = d_scale if scale is None else scale
    dk, dv = q.shape[-1], v.shape[-1]
    out = torch.empty((b, t, h, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, t, s, h)
    if (dk, dv) == (HEAD_DIM, HEAD_DIM):
        err = lib.flash_fwd_launch(*ptrs, code, scale, stream)
    else:
        err = lib.flash_fwd_dims_launch(*ptrs, dk, dv, scale, stream)
        flash_forward.launches_qk192 += 1
    check(err, "flash_forward")
    flash_forward.launches += 1
    return out, lse


def _check_rows(lse, delta, q):
    b, t, h, _ = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        _check_cuda(name, x, torch.float32, (b, h, t), q.device)


def flash_dq(q, k, v, mask, dout, lse, delta):
    """Kernel K5 -> dQ [B, T, H, D] in q.dtype."""
    _check_shapes(q, k, v, mask)
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, mask, dout, lse, delta)
    from medplib_tpu_torch.ops.cuda._build import check
    lib, (b, t, s, h), code, scale, stream = _cuda_args(
        q, k, v, mask, (("dout", dout),))
    _check_rows(lse, delta, q)
    dq = torch.empty_like(q)
    err = lib.flash_bwd_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        b, t, s, h, code, scale, stream)
    check(err, "flash_dq")
    flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, mask, dout, lse, delta):
    """Kernel K6 -> (dK, dV) [B, S, H, D] in k.dtype."""
    _check_shapes(q, k, v, mask)
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, mask, dout, lse, delta)
    from medplib_tpu_torch.ops.cuda._build import check
    lib, (b, t, s, h), code, scale, stream = _cuda_args(
        q, k, v, mask, (("dout", dout),))
    _check_rows(lse, delta, q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = lib.flash_bwd_dkv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, t, s, h, code, scale, stream)
    check(err, "flash_dkv")
    flash_dkv.launches += 1
    return dk, dv


flash_forward.launches = 0
flash_forward.launches_qk192 = 0     # the (192, 128) instantiation alone
flash_dq.launches = 0
flash_dkv.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class FlashAttention(torch.autograd.Function):
    """out = flash attention(q, k, v, mask). Forward: K4, saving q, k, v,
    mask, out and lse. Backward: delta = rowsum(dO * O) in f32 from the
    saved (rounded) out, then K5 and K6. The mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale=None):
        out, lse = flash_forward(q, k, v, mask, scale)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, mask, out, lse = ctx.saved_tensors
        if ctx.scale is not None or k.shape != v.shape:
            raise NotImplementedError(
                "K5 / K6 take D = 128 and the default scale only")
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()                               # [B, H, T]
        dq = flash_dq(q, k, v, mask, dout, lse, delta)
        dk, dv = flash_dkv(q, k, v, mask, dout, lse, delta)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    attn_mask: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention through the flash kernels. q [B, T, H, D]; k, v
    [B, S, H, D] (heads repeated; v's D may differ, forward only);
    attn_mask [B, S] 1 = keep, or None for an all-ones mask, which keeps
    the autograd function on the mask-less path too. scale: the softmax
    scale (default D^-0.5)."""
    if not causal:
        raise NotImplementedError("only causal flash attention is ported")
    if attn_mask is None:
        attn_mask = torch.ones((q.shape[0], k.shape[1]), dtype=torch.int32,
                               device=q.device)
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(),
                                attn_mask.to(torch.int32).contiguous(),
                                scale)
