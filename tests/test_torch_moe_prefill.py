"""The MoE prefill's int8 activation passes (ops/cuda/moe_prefill.py) on
the CPU, where each wrapper runs its plain version: quantizing each token
once and writing it to its k aligned rows gives the bits of quantizing
the aligned buffer; the fused SwiGLU-quantize gives silu then
quantize_rows; the grouped SwiGLU through them gives the bits of the
sequence they replace; the combine's fixed order stays within one bf16
step of PyTorch's (plus the f32 summation bounds where products cancel).
Top-1 of 2 experts (the flagship's two-ended layout) and top-6 of 64
(DeepSeek-V2-Lite's), int4h and int8 experts."""

import pytest
import torch

import chip_smoke as cs
from medplib_tpu_torch.ops import moe as M
from medplib_tpu_torch.ops.activations import silu
from medplib_tpu_torch.ops.cuda import gmm as G
from medplib_tpu_torch.ops.cuda import moe_prefill as P
from medplib_tpu_torch.utils.quantize import dynamic_act_quant

torch.set_num_threads(1)

S, H, MW, BM = 150, 256, 256, 16


def _experts(gen, kind, e):
    out = {}
    for name, (k, n) in (("gate_proj", (H, MW)), ("up_proj", (H, MW)),
                         ("down_proj", (MW, H))):
        if kind == "int4h":
            out[name] = {"kernel": torch.randint(
                -128, 128, (e, k // 2, n), generator=gen, dtype=torch.int8),
                "scale4h": torch.rand((e, 2, 1, n), generator=gen) * 0.01
                + 1e-3}
        else:
            out[name] = {"kernel": torch.randint(
                -127, 128, (e, k, n), generator=gen, dtype=torch.int8),
                "scale": torch.rand((e, 1, n), generator=gen) * 0.01 + 1e-3}
    return out


@pytest.mark.parametrize("kind", ["int4h", "int8"])
@pytest.mark.parametrize("e,k", [(2, 1), (64, 6)])
def test_prefill_int8_passes(e, k, kind):
    gen = torch.Generator().manual_seed(10 * e + k)
    xs = (torch.randn((S, H), generator=gen) * 0.5).to(torch.bfloat16)
    xs[3] = 0.0                       # a zero row takes the 1e-12 floor
    if k == 1:
        idx = torch.randint(0, e, (S,), generator=gen)
    else:
        idx = torch.stack([torch.randperm(e, generator=gen)[:k]
                           for _ in range(S)]).reshape(-1)
    dest, tile_gid, sp = G.align_rows(idx, e, BM)

    # dispatch: the plain version gathers, then quantizes every aligned
    # row; quantizing each token once and gathering gives the same bits
    xq, xsc = P.moe_dispatch_quant(xs, dest, sp, k)
    q1, s1 = G.quantize_rows(xs)
    want_q = torch.zeros((sp, H), dtype=torch.int8)
    want_q[dest] = q1.repeat_interleave(k, 0)
    want_s = G.quantize_rows(torch.zeros((sp, H)))[1]
    want_s[dest] = s1.repeat_interleave(k, 0)
    assert torch.equal(xq, want_q) and torch.equal(xsc, want_s)
    x_al, dest_g, gid_g = G.align_groups(xs.repeat_interleave(k, 0), idx, e,
                                         BM)
    assert torch.equal(dest_g, dest) and torch.equal(gid_g, tile_gid)

    # the grouped SwiGLU through the new passes against the sequence they
    # replace: x_al quantized for gate and for up, silu then the product in
    # f32, quantize_rows, down
    experts = _experts(gen, kind, e)
    kinds = M.plan_route(experts, e, k, S, decode=False).kinds
    assert kinds == (kind,) * 3
    with dynamic_act_quant(True):
        assert M._ffn_specs(experts, kinds, torch.bfloat16)[1]
        got = M._gmm_ffn(xs, dest, k, sp, tile_gid, experts, kinds,
                         torch.bfloat16, BM)

    def mm(xin, name):
        xq_, xs_ = G.quantize_rows(xin)
        node = experts[name]
        if kind == "int4h":
            return G.gmm_int4h(xq_, node["kernel"], node["scale4h"],
                               tile_gid, a_scale=xs_, block_m=BM)
        return G.gmm(xq_, node["kernel"], tile_gid, node["scale"],
                     a_scale=xs_, block_m=BM)

    h1, h2 = mm(x_al, "gate_proj"), mm(x_al, "up_proj")
    want = mm(silu(h1).float() * h2.float(), "down_proj")
    assert torch.equal(got, want)

    # SwiGLU-quantize: the fused plain version is silu, then quantize_rows
    aq, asc = P.moe_swiglu_quant(h1, h2)
    wq, ws = G.quantize_rows(silu(h1).float() * h2.float())
    assert torch.equal(aq, wq) and torch.equal(asc, ws)
    assert aq.dtype == torch.int8 and asc.shape == (sp, 1)

    # combine: the kernel's order (a[j % 4] += p_j from 0, then ((a0 + a1)
    # + a2) + a3, rounded once) against the plain version's (PyTorch's f32
    # sum order on this device): one bf16 step, plus the two orders' f32
    # summation bounds where the products cancel
    w = torch.softmax(torch.randn((S, k), generator=gen), -1)
    y = P.moe_topk_combine(got, dest, w, torch.bfloat16)
    a = [torch.zeros((S, H)) for _ in range(4)]
    rows = dest.view(S, k)
    for j in range(k):
        a[j % 4] = a[j % 4] + got[rows[:, j]].float() * w[:, j:j + 1]
    model = (((a[0] + a[1]) + a[2]) + a[3]).to(torch.bfloat16)
    assert y.dtype == torch.bfloat16 and y.shape == (S, H)
    assert cs.combine_order_close(model, y, got, dest, w)[0]


def test_align_rows_counts_groups_by_search():
    """E > 2: the group sizes from the sorted ids' bounds are bincount's,
    empty experts included, and each row's aligned slot lies inside its
    expert's tiles."""
    gen = torch.Generator().manual_seed(3)
    e, bm = 16, 8
    idx = torch.randint(0, 12, (300,), generator=gen)   # experts 12-15 empty
    dest, gid, sp = G.align_rows(idx, e, bm)
    assert sp == (300 // bm + e) * bm and gid.dtype == torch.int32
    assert torch.equal(torch.sort(dest).values, torch.unique(dest))
    assert torch.equal(gid.long()[dest // bm], idx)
    sizes = torch.bincount(gid.long()[dest // bm], minlength=e)
    assert torch.equal(sizes, torch.bincount(idx, minlength=e))
