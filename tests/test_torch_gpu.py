"""The CUDA kernels against their plain PyTorch versions on the card.

Marked `gpu`: on a machine without a CUDA device every test here skips
(decided inside the fixture, so all workers collect the same tests). On
the card: `python -m pytest tests/test_torch_gpu.py -m gpu`.
"""

import pytest
import torch

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _int8_weight(gen, shape, dev):
    """Random int8 weights over the whole range, every 7th byte -128: the
    quantizer never writes -128, but the kernels' decode must read it."""
    w = torch.randint(-128, 128, shape, generator=gen, device=dev,
                      dtype=torch.int8)
    w.view(-1)[::7] = -128
    return w


def _int4h(gen, e, k, n, dev):
    packed = torch.randint(-128, 128, (e, k // 2, n), generator=gen,
                           device=dev, dtype=torch.int8)
    scale = torch.rand((e, 2, 1, n), generator=gen, device=dev) * 0.01 + 1e-3
    return packed, scale


# (block_m, A8, K, N): both modes on the tensor cores, at the 16-row tile
# (block_m 16, 32) and the 64-row tile (64, 512: two tiles of one expert
# each), K = 768 with N = 208 (the wrapper pads N to 16)
@pytest.mark.parametrize("block_m,a8,k,n", [
    (64, True, 512, 192), (32, True, 512, 192), (16, True, 512, 192),
    (512, True, 512, 192), (64, True, 768, 208), (16, True, 768, 208),
    (64, False, 512, 192), (32, False, 512, 192), (512, False, 768, 208),
    (16, False, 512, 192), (16, False, 768, 208),
])
def test_gmm_int4h_kernel_matches_plain(dev, block_m, a8, k, n):
    """A8: exact integer sums, the plain version's rounded epilogue in its
    order -> bit-equal. bf16 x: f32 sums in another order, the plain
    version's rounded fold -> rel 1e-5."""
    from medplib_tpu_torch.ops.cuda import gmm as G
    gen = torch.Generator(device=dev).manual_seed(block_m + k)
    packed, scale = _int4h(gen, 2, k, n, dev)
    xs = torch.randn((300, k), generator=gen, device=dev)
    idx = torch.randint(0, 2, (300,), generator=gen, device=dev)
    x_al, _, gid = G.align_groups(xs, idx, 2, block_m)
    assert int(gid.min()) == 0 and int(gid.max()) == 1
    xin, a_s = G.quantize_rows(x_al) if a8 else (x_al, None)
    n0 = G.gmm_int4h.launches
    got = G.gmm_int4h(xin, packed, scale, gid, a_s, block_m)
    want = G.gmm_int4h_plain(xin, packed, scale, gid, a_s, block_m)
    torch.cuda.synchronize()
    assert G.gmm_int4h.launches == n0 + 1
    assert got.shape == (x_al.shape[0], n)
    if a8:
        assert torch.equal(got, want)
    else:
        assert float((got - want).norm() / want.norm()) < 1e-5


@pytest.mark.parametrize("block_m", [16, 64])
@pytest.mark.parametrize("a8", [True, False])
def test_gmm_int4h_out_dtype_and_ones_on_card(dev, block_m, a8):
    """The reference's arguments on the card: out_dtype f32 and bf16 in
    both modes, A8 without a_scale (ones), block_n / block_k / allow_pad
    passed and ignored. A8 bit-equal to plain in either dtype; bf16 x
    rel 1e-5 in f32 (and its bf16 output is that f32 result rounded)."""
    from medplib_tpu_torch.ops.cuda import gmm as G
    gen = torch.Generator(device=dev).manual_seed(7 + block_m)
    packed, scale = _int4h(gen, 2, 512, 208, dev)
    xs = torch.randn((300, 512), generator=gen, device=dev)
    idx = torch.randint(0, 2, (300,), generator=gen, device=dev)
    x_al, _, gid = G.align_groups(xs, idx, 2, block_m)
    xin = G.quantize_rows(x_al)[0] if a8 else x_al
    kw = dict(block_n=128, block_k=256, allow_pad=False)
    outs = {}
    for dt in (torch.float32, torch.bfloat16):
        got = G.gmm_int4h(xin, packed, scale, gid, None, block_m,
                          out_dtype=dt, **kw)
        want = G.gmm_int4h_plain(xin, packed, scale, gid, None, block_m,
                                 out_dtype=dt)
        torch.cuda.synchronize()
        assert got.dtype == dt and got.shape == (x_al.shape[0], 208)
        if a8:
            assert torch.equal(got, want)
        elif dt == torch.float32:
            assert float((got - want).norm() / want.norm()) < 1e-5
        outs[dt] = got
    assert torch.equal(outs[torch.float32].to(torch.bfloat16),
                       outs[torch.bfloat16])


@pytest.mark.parametrize("b", [16, 5, 40, 80])
@pytest.mark.parametrize("a8", [True, False])
def test_moe_decode_kernel_matches_plain(dev, b, a8):
    """Same op order on both sides; exp() may differ in its last bit and
    flip a rare act-quant / bf16 rounding by one step: rel 1e-3. More
    than 64 rows launch once per 64."""
    from medplib_tpu_torch.ops.cuda import moe_decode as D
    gen = torch.Generator(device=dev).manual_seed(b)
    e, h, m = 2, 512, 1536
    experts = {}
    for name, (k, n) in (("gate_proj", (h, m)), ("up_proj", (h, m)),
                         ("down_proj", (m, h))):
        p, s = _int4h(gen, e, k, n, dev)
        experts[name] = {"kernel": p, "scale4h": s}
    x = (torch.randn((b, h), generator=gen, device=dev) * 0.5).to(
        torch.bfloat16)
    idx = torch.randint(0, e, (b,), generator=gen, device=dev)
    gate = torch.rand((b,), generator=gen, device=dev)
    n0 = D.moe_ffn_decode_int4h.launches
    got = D.moe_ffn_decode_int4h(x, experts, idx, gate, e, int8_x=a8)
    want = D.moe_ffn_decode_int4h_plain(x, experts, idx, gate, e,
                                        int8_x=a8)
    torch.cuda.synchronize()
    assert D.moe_ffn_decode_int4h.launches == n0 + (b + 63) // 64
    assert got.shape == (b, h) and got.dtype == torch.bfloat16
    assert float((got.float() - want.float()).norm()
                 / want.float().norm()) < 1e-3


@pytest.mark.parametrize("block_n", [128, 256])
@pytest.mark.parametrize("b", [1, 16, 33, 80])
@pytest.mark.parametrize("a8", [True, False])
def test_moe_decode_block_n_on_card(dev, a8, b, block_n):
    """K2 with block_n 128 / 256 (M/2 = 768, where _pick_bn gives 384) in
    both modes, at B = 1 / 16 / 33 / 80 (16, 16, 64 and 64 + 16 padded
    rows): rel 1e-3 as above, one counted launch per 64 rows, and a
    block_n the kernel cannot tile raises."""
    from medplib_tpu_torch.ops.cuda import moe_decode as D
    gen = torch.Generator(device=dev).manual_seed(100 * b + block_n)
    e, h, m = 2, 512, 1536
    experts = {}
    for name, (k, n) in (("gate_proj", (h, m)), ("up_proj", (h, m)),
                         ("down_proj", (m, h))):
        p, s = _int4h(gen, e, k, n, dev)
        experts[name] = {"kernel": p, "scale4h": s}
    x = (torch.randn((b, h), generator=gen, device=dev) * 0.5).to(
        torch.bfloat16)
    idx = torch.randint(0, e, (b,), generator=gen, device=dev)
    gate = torch.rand((b,), generator=gen, device=dev)
    n0 = D.moe_ffn_decode_int4h.launches
    got = D.moe_ffn_decode_int4h(x, experts, idx, gate, e, block_n=block_n,
                                 int8_x=a8)
    want = D.moe_ffn_decode_int4h_plain(x, experts, idx, gate, e,
                                        block_n=block_n, int8_x=a8)
    torch.cuda.synchronize()
    assert D.moe_ffn_decode_int4h.launches == n0 + (b + 63) // 64
    assert got.shape == (b, h) and got.dtype == torch.bfloat16
    assert float((got.float() - want.float()).norm()
                 / want.float().norm()) < 1e-3
    with pytest.raises(ValueError):
        D.moe_ffn_decode_int4h(x, experts, idx, gate, e, block_n=192,
                               int8_x=a8)


@pytest.mark.parametrize("a8", [True, False])
def test_moe_decode_f32_rows_on_card(dev, a8):
    """f32 x (B = 5): the kernel's first launch quantizes (A8) or rounds
    (bf16) the f32 rows as the plain version does, and the output is f32:
    rel 1e-3 as above."""
    from medplib_tpu_torch.ops.cuda import moe_decode as D
    gen = torch.Generator(device=dev).manual_seed(3)
    e, h, m = 2, 512, 1536
    experts = {}
    for name, (k, n) in (("gate_proj", (h, m)), ("up_proj", (h, m)),
                         ("down_proj", (m, h))):
        p, s = _int4h(gen, e, k, n, dev)
        experts[name] = {"kernel": p, "scale4h": s}
    x = torch.randn((5, h), generator=gen, device=dev) * 0.5
    idx = torch.randint(0, e, (5,), generator=gen, device=dev)
    gate = torch.rand((5,), generator=gen, device=dev)
    got = D.moe_ffn_decode_int4h(x, experts, idx, gate, e, int8_x=a8)
    want = D.moe_ffn_decode_int4h_plain(x, experts, idx, gate, e,
                                        int8_x=a8)
    torch.cuda.synchronize()
    assert got.shape == (5, h) and got.dtype == torch.float32
    assert float((got - want).norm() / want.norm()) < 1e-3


# (B, T, H, keep lengths, seed): a >= 1024-token prompt with a padded row;
# the serving cell's shape class (B=16 right-padded rows of 623-687
# spliced tokens, 32 heads); a short prompt, which takes flash too (no
# length gate)
@pytest.mark.parametrize("b,t,h,lens,seed", [
    (2, 1030, 4, (1030, 1000), 1),
    (16, 687, 32, tuple(623 + round(64 * i / 15) for i in range(16)), 687),
    (2, 40, 32, (40, 33), 40),
])
def test_long_prompt_attention_takes_flash(dev, b, t, h, lens, seed):
    """A prompt with head_dim 128 on the card goes through K4 (one launch,
    the plain route's counter unchanged) at any length and matches the
    plain attention path (bf16 out: rel 1e-2, the plain path rounds the
    probabilities to bf16, flash does not)."""
    from medplib_tpu_torch.ops import attention as A
    from medplib_tpu_torch.ops.cuda import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, t, h, 128), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    assert len(lens) == b
    mask = (torch.arange(t, device=dev)[None, :]
            < torch.tensor(lens, device=dev)[:, None]).to(torch.int32)
    n0, p0 = FA.flash_forward.launches, A.causal_attention.plain_calls
    got = A.causal_attention(q, k, v, mask)
    assert FA.flash_forward.launches == n0 + 1
    assert A.causal_attention.plain_calls == p0
    bias = A.make_causal_bias(mask, t, t, device=dev)
    want = A._plain_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).norm()
                 / want.float().norm()) < 1e-2


def test_long_prompt_head_dim_256_takes_plain_attention(dev):
    """A 1024-token prompt with head_dim 256 on the card: the flash kernels
    take head_dim 128 only, so it takes the plain attention (no launch, one
    plain call counted), equal to the same function on the CPU (f32: rel
    1e-5)."""
    from medplib_tpu_torch.ops import attention as A
    from medplib_tpu_torch.ops.cuda import flash_attention as FA
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((1, 1024, 2, 256), generator=gen)
               for _ in range(3))
    mask = torch.ones((1, 1024), dtype=torch.int32)
    mask[0, 1000:] = 0
    n0, p0 = FA.flash_forward.launches, A.causal_attention.plain_calls
    got = A.causal_attention(q.to(dev), k.to(dev), v.to(dev), mask.to(dev))
    torch.cuda.synchronize()
    assert FA.flash_forward.launches == n0
    assert A.causal_attention.plain_calls == p0 + 1
    want = A.causal_attention(q, k, v, mask)
    assert float((got.cpu() - want).norm() / want.norm()) < 1e-5


def test_grounded_generate_prefill_takes_flash(dev):
    """A B=16 grounded generate at the serving widths (int4h MoE flagship,
    32 heads x 128, 2 layers), rows right-padded to 623-687 spliced tokens
    as in the serving benchmark: the prefill launches K4 once a layer and
    the plain route never runs; tokens in range, masks finite."""
    import numpy as np

    import chip_smoke as cs
    from medplib_tpu_torch.config import flagship_cfg
    from medplib_tpu_torch.models import medplib
    from medplib_tpu_torch.ops import attention as A
    from medplib_tpu_torch.ops.cuda import flash_attention as FA
    from medplib_tpu_torch.utils.quantize import dynamic_act_quant
    cfg = flagship_cfg(2, moe=True)
    params = cs.init_flagship(cfg, torch.Generator(device=dev).manual_seed(0),
                              dev)
    rng = np.random.default_rng(0)
    b, t, new = 16, 112, 4
    batch = cs.make_batch(cfg, b, t, rng, dev)
    ids, mask = batch.input_ids.clone(), batch.input_mask.clone()
    ids[:, t - 3] = 5
    for r, n in enumerate(rng.permutation(np.rint(np.linspace(48, t, b)))):
        n = int(n)
        ids[r, n:], mask[r, n:] = 0, 0
        ids[r, n - 3] = cfg.seg_token_idx
    batch = batch._replace(input_ids=ids, input_mask=mask)
    n0, p0 = FA.flash_forward.launches, A.causal_attention.plain_calls
    with dynamic_act_quant(True):
        r = medplib.generate(params, cfg, batch, max_new_tokens=new)
    torch.cuda.synchronize()
    assert FA.flash_forward.launches == n0 + cfg.llm.num_layers
    assert A.causal_attention.plain_calls == p0
    cs.check_result(r, cfg, b, new)


@pytest.mark.parametrize("b,t,s,h,dtype", [
    (3, 70, 70, 2, torch.float32),
    (3, 1087, 1087, 2, torch.bfloat16),
    (3, 50, 130, 2, torch.bfloat16),
    (4, 1789, 1789, 32, torch.bfloat16),   # the ICL prefill
    (12, 700, 700, 32, torch.bfloat16),    # a short stage-3 prompt
])
def test_flash_kernels_match_plain(dev, b, t, s, h, dtype):
    """K4 / K5 / K6 against their plain versions (the backward ones from
    the kernel's lse and delta): out, dq, dk, dv within rel Frobenius 1e-3
    (f32 sums in another order, then the output dtype's rounding), lse
    within 1e-4; rows that keep no key finite. Ragged T, T < S, padded key
    tails, a row whose first queries keep no key; f32 takes the FMA
    kernels, bf16 the tensor-core ones."""
    from medplib_tpu_torch.ops.cuda import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(t + s)
    d = 128
    q = torch.randn((b, t, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    g = torch.randn((b, t, h, d), generator=gen, device=dev).to(dtype)
    mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    mask[0, s - 9:] = 0
    mask[2, :4] = 0
    n = (FA.flash_forward.launches, FA.flash_dq.launches,
         FA.flash_dkv.launches)
    out, lse = FA.flash_forward(q, k, v, mask)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = FA.flash_dq(q, k, v, mask, g, lse, delta)
    dk, dv = FA.flash_dkv(q, k, v, mask, g, lse, delta)
    torch.cuda.synchronize()
    assert (FA.flash_forward.launches, FA.flash_dq.launches,
            FA.flash_dkv.launches) == tuple(x + 1 for x in n)
    want_out, want_lse = FA.flash_forward_plain(q, k, v, mask)
    want = (FA.flash_dq_plain(q, k, v, mask, g, lse, delta),
            *FA.flash_dkv_plain(q, k, v, mask, g, lse, delta))
    live = FA._keep(mask, t, s).any(-1)[:, 0]
    lv = live[..., None].expand(-1, -1, h)

    def rel(a, w):
        return float((a.float() - w.float()).norm() / w.float().norm())

    assert rel(out[lv], want_out[lv]) < 1e-3
    assert float((lse.transpose(1, 2)[lv]
                  - want_lse.transpose(1, 2)[lv]).abs().max()) < 1e-4
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == dtype and rel(got, w) < 1e-3
    for x in (out, lse, dq, dk, dv):
        assert bool(torch.isfinite(x.float()).all())


def test_flash_dkv_whole_masked_key_tiles(dev):
    """K6 on bf16 at T < S with whole 64-key tiles masked (keys 64-191 of
    row 0, 128-255 of row 1): those keys' dK / dV rows are exactly zero,
    the rest within rel Frobenius 1e-3 of the plain version."""
    from medplib_tpu_torch.ops.cuda import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(11)
    b, t, s, h, d = 2, 100, 300, 2, 128
    bf = torch.bfloat16
    q, g = (torch.randn((b, t, h, d), generator=gen, device=dev).to(bf)
            for _ in range(2))
    k, v = (torch.randn((b, s, h, d), generator=gen, device=dev).to(bf)
            for _ in range(2))
    mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    mask[0, 64:192] = 0
    mask[1, 128:256] = 0
    mask[1, s - 7:] = 0
    out, lse = FA.flash_forward(q, k, v, mask)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = FA.flash_dkv(q, k, v, mask, g, lse, delta)
    want = FA.flash_dkv_plain(q, k, v, mask, g, lse, delta)
    torch.cuda.synchronize()
    dead = (mask == 0)[:, :, None, None].expand(-1, -1, h, d)
    for got, w in zip((dk, dv), want):
        assert got.dtype == bf and bool(torch.isfinite(got.float()).all())
        assert not bool(got[dead].any())
        assert float((got.float() - w.float()).norm()
                     / w.float().norm()) < 1e-3


def test_flash_fwd_dq_whole_masked_key_tiles(dev):
    """K4 and K5 on bf16 at T < S with whole 64-key tiles masked (keys
    0-255 of row 0, so its queries 0-55 keep no key and 56-99 find their
    first kept key after four masked tiles; keys 128-255 and a padded tail
    of row 1): out and lse of the live rows, and dq, match the plain
    versions (rel Frobenius 1e-3, lse 1e-4); the no-key rows' out is
    finite and their dq exactly zero."""
    from medplib_tpu_torch.ops.cuda import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(12)
    b, t, s, h, d = 2, 100, 300, 2, 128
    bf = torch.bfloat16
    q, g = (torch.randn((b, t, h, d), generator=gen, device=dev).to(bf)
            for _ in range(2))
    k, v = (torch.randn((b, s, h, d), generator=gen, device=dev).to(bf)
            for _ in range(2))
    mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    mask[0, :256] = 0
    mask[1, 128:256] = 0
    mask[1, s - 7:] = 0
    out, lse = FA.flash_forward(q, k, v, mask)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = FA.flash_dq(q, k, v, mask, g, lse, delta)
    want_out, want_lse = FA.flash_forward_plain(q, k, v, mask)
    want_dq = FA.flash_dq_plain(q, k, v, mask, g, lse, delta)
    torch.cuda.synchronize()
    live = FA._keep(mask, t, s).any(-1)[:, 0]
    assert int((~live).sum()) == 56
    lv = live[..., None].expand(-1, -1, h)

    def rel(a, w):
        return float((a.float() - w.float()).norm() / w.float().norm())

    assert rel(out[lv], want_out[lv]) < 1e-3
    assert float((lse.transpose(1, 2)[lv]
                  - want_lse.transpose(1, 2)[lv]).abs().max()) < 1e-4
    assert dq.dtype == bf and rel(dq, want_dq) < 1e-3
    assert not bool(dq[~lv].any())
    for x in (out, lse, dq):
        assert bool(torch.isfinite(x.float()).all())


def test_flash_autograd_on_card(dev):
    """flash_attention under torch.autograd on the card: the backward runs
    K5 and K6 once each and matches autograd through the plain attention
    in f32 (rel 1e-4)."""
    from medplib_tpu_torch.ops import attention as A
    from medplib_tpu_torch.ops.cuda import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(2)
    shape = (2, 100, 2, 128)
    base = [torch.randn(shape, generator=gen, device=dev) for _ in range(4)]
    grads = []
    for fn in ("flash", "plain"):
        q, k, v = (x.clone().requires_grad_(True) for x in base[:3])
        if fn == "flash":
            n = (FA.flash_dq.launches, FA.flash_dkv.launches)
            out = FA.flash_attention(q, k, v)
        else:
            out = A._plain_attention(q, k, v,
                                     A.make_causal_bias(None, 100, 100,
                                                        device=dev))
        grads.append(torch.autograd.grad(out, (q, k, v), base[3]))
        if fn == "flash":
            assert (FA.flash_dq.launches, FA.flash_dkv.launches) == (
                n[0] + 1, n[1] + 1)
    for a, w in zip(*grads):
        assert float((a - w).norm() / w.norm()) < 1e-4


def _gmm_sum_order_close(got, want, x, w, ws, gid, block_m, transposed):
    """_sum_order_close on the rows of each expert against its own
    dequantized weight."""
    rows = gid.long().repeat_interleave(block_m)
    ok = True
    for g in range(w.shape[0]):
        sel = rows == g
        wg = (w[g].t() if transposed else w[g]).double()
        if ws is not None:
            wg = wg * ws[g].double()
        ok &= _sum_order_close(got[sel], want[sel], x[sel], wg)
    return ok


def _k8_order(x, w, gid, ws, a_s, bm, transposed):
    """f32 (acc * a_s) * w_s per expert: K8's epilogue order, not K3's."""
    rows = gid.long().repeat_interleave(bm)
    out = torch.zeros((x.shape[0], ws.shape[-1]), device=x.device)
    for g in range(w.shape[0]):
        sel = rows == g
        wg = w[g].t() if transposed else w[g]
        acc = (x[sel].double() @ wg.double()).float()
        out[sel] = (acc * a_s[sel]) * ws[g]
    return out


# (x dtype, w dtype, transposed, N, block_m): W8A8 (the s8 tensor cores)
# in both layouts at block_m 16, 32 (16-row tiles), 64 and 512; int8-w
# with bf16 and f32 x; float bf16 / f32; transposed weights; N not a
# multiple of the 64-column tile; the main path's block_m 512, whose two
# tiles hold one expert each
@pytest.mark.parametrize("xd,wd,transposed,n,block_m", [
    (torch.int8, torch.int8, False, 192, 64),
    (torch.int8, torch.int8, True, 208, 32),
    (torch.int8, torch.int8, False, 208, 16),
    (torch.int8, torch.int8, True, 192, 16),
    (torch.int8, torch.int8, False, 192, 32),
    (torch.int8, torch.int8, True, 192, 64),
    (torch.int8, torch.int8, True, 208, 512),
    (torch.bfloat16, torch.int8, False, 192, 64),
    (torch.float32, torch.int8, True, 192, 64),
    (torch.bfloat16, torch.bfloat16, False, 208, 64),
    (torch.float32, torch.float32, True, 192, 32),
    (torch.bfloat16, torch.int8, True, 208, 32),
    (torch.bfloat16, torch.bfloat16, True, 192, 32),
    (torch.bfloat16, torch.int8, False, 208, 512),
    (torch.bfloat16, torch.int8, True, 192, 512),
    (torch.bfloat16, torch.bfloat16, False, 192, 512),
    (torch.int8, torch.int8, False, 192, 512),
])
def test_gmm_kernel_matches_plain(dev, xd, wd, transposed, n, block_m):
    """K3 against gmm_plain over a two-ended E=2 buffer (a gap tile of
    zero rows), K = 2176 (a ragged last 128-deep stage), int8 weights with
    -128. W8A8: exact integer sums, the same rounded epilogue ops in the
    same order -> bit-equal, in bf16 and in f32 output; K8's order
    (acc * a_s) * w_s differs from it in f32. Otherwise the same products
    summed in another order (_sum_order_close; f32 outputs also rel
    1e-5)."""
    from medplib_tpu_torch.ops.cuda import gmm as G
    gen = torch.Generator(device=dev).manual_seed(n + block_m)
    k, e = 2176, 2
    xs = torch.randn((300, k), generator=gen, device=dev)
    idx = torch.randint(0, e, (300,), generator=gen, device=dev)
    x_al, _, gid = G.align_groups(xs, idx, e, block_m)
    assert int(gid.min()) == 0 and int(gid.max()) == 1
    a_s = None
    if xd == torch.int8:
        x_al, a_s = G.quantize_rows(x_al)
    else:
        x_al = x_al.to(xd)
    wshape = (e, n, k) if transposed else (e, k, n)
    ws = None
    if wd == torch.int8:
        w = _int8_weight(gen, wshape, dev)
        ws = torch.rand((e, 1, n), generator=gen, device=dev) * 0.01 + 1e-3
    else:
        w = (torch.randn(wshape, generator=gen, device=dev)
             * k ** -0.5).to(wd)
    n0 = G.gmm.launches
    got = G.gmm(x_al, w, gid, ws, a_s, block_m, transposed=transposed)
    want = G.gmm_plain(x_al, w, gid, ws, a_s, block_m, transposed=transposed)
    torch.cuda.synchronize()
    assert G.gmm.launches == n0 + 1
    assert got.dtype == want.dtype and got.shape == (x_al.shape[0], n)
    if xd == torch.int8:
        assert torch.equal(got, want)
        f32 = dict(block_m=block_m, out_dtype=torch.float32,
                   transposed=transposed)
        got32 = G.gmm(x_al, w, gid, ws, a_s, **f32)
        want32 = G.gmm_plain(x_al, w, gid, ws, a_s, **f32)
        torch.cuda.synchronize()
        assert torch.equal(got32, want32)
        assert not torch.equal(got32, _k8_order(x_al, w, gid, ws, a_s,
                                                block_m, transposed))
    else:
        xb = x_al.to(torch.bfloat16) if wd == torch.int8 else x_al
        assert _gmm_sum_order_close(got, want, xb, w, ws, gid, block_m,
                                    transposed)
        if got.dtype == torch.float32:
            rel = float((got.float() - want.float()).norm()
                        / want.float().norm())
            assert rel < 1e-5


def test_int8_kv_cache_decode_on_card(dev):
    """quantize_kv and decode_attention_quant on the card equal the same
    functions on the CPU (int8 values and scales bit-equal; the attention
    output within rel 1e-5 in f32)."""
    from medplib_tpu_torch.ops import attention as A
    gen = torch.Generator().manual_seed(4)
    q = torch.randn((3, 1, 8, 64), generator=gen)
    kc, vc = (torch.randn((3, 40, 4, 64), generator=gen) for _ in range(2))
    lens = torch.tensor([40, 7, 1], dtype=torch.int32)
    want = [A.quantize_kv(kc), A.quantize_kv(vc)]
    got = [A.quantize_kv(kc.to(dev)), A.quantize_kv(vc.to(dev))]
    for (gq, gs), (wq, wsc) in zip(got, want):
        assert torch.equal(gq.cpu(), wq) and torch.equal(gs.cpu(), wsc)
    out = A.decode_attention_quant(q.to(dev), *got[0], *got[1], lens.to(dev))
    ref = A.decode_attention_quant(q, *want[0], *want[1], lens)
    assert float((out.cpu() - ref).norm() / ref.norm()) < 1e-5


def _sum_order_close(got, want, x, w_deq):
    """|got - want| <= both f32 summation error bounds (K * 2^-24 *
    sum_k |x w| each) + one rounding of the output dtype."""
    k = x.shape[-1]
    sums = x.double().abs() @ w_deq.double().abs()
    ulp = 2.0 ** -7 if got.dtype == torch.bfloat16 else 2.0 ** -23
    tol = 2 * k * 2.0 ** -24 * sums + want.double().abs() * ulp
    return bool(((got.double() - want.double()).abs() <= tol).all())


# (x dtype, transposed, M, K): decode-sized M (16-row tiles, M = 1 too)
# and a ragged M over 64-row tiles; K = 1040 ends in a ragged 64-deep
# chunk, N = 208 in a ragged column tile; M = 9968 at K = 4096 is the
# packed int8 prefill
@pytest.mark.parametrize("xd,transposed,m,k", [
    (torch.bfloat16, False, 16, 1040), (torch.bfloat16, True, 16, 1040),
    (torch.bfloat16, False, 300, 1040), (torch.bfloat16, True, 300, 1040),
    (torch.float32, True, 300, 1040), (torch.float32, False, 5, 1040),
    (torch.bfloat16, False, 1, 4096), (torch.bfloat16, True, 9968, 4096),
])
def test_int8_matmul_kernel_matches_plain(dev, xd, transposed, m, k):
    """K7 against its plain version, weights with -128: the same exact
    products summed in f32 in another order, then one rounding."""
    from medplib_tpu_torch.ops.cuda import int8_matmul as I
    gen = torch.Generator(device=dev).manual_seed(m + int(transposed))
    n = 208
    x = torch.randn((m, k), generator=gen, device=dev).to(xd)
    w = _int8_weight(gen, (n, k) if transposed else (k, n), dev)
    s = torch.rand((n, 1) if transposed else (1, n), generator=gen,
                   device=dev) * 0.01 + 1e-3
    n0 = I.int8_matmul_2d.launches
    got = I.int8_matmul_2d(x, w, s, transposed)
    want = I.int8_matmul_plain(x, w, s, transposed)
    torch.cuda.synchronize()
    assert I.int8_matmul_2d.launches == n0 + 1
    assert got.dtype == xd and got.shape == (m, n)
    wd = w.double() * s.double()
    assert _sum_order_close(got, want, x, wd.t() if transposed else wd)


# (transposed, M, K, N, x / out dtype): 64-row tiles at M = 300, the
# 16-row decode tile at M = 16, f32 outputs, and the ragged K = 688 (not a
# multiple of the 32-deep s8 mma step) with N = 320 (not one of the
# 128-column tile), which the wrapper pads to K, N % 16
@pytest.mark.parametrize("transposed,m,k,n,xd", [
    (False, 300, 2048, 208, torch.bfloat16),
    (True, 300, 2048, 208, torch.bfloat16),
    (True, 16, 1040, 208, torch.bfloat16),
    (False, 16, 1040, 208, torch.bfloat16),
    (False, 300, 2048, 208, torch.float32),
    (True, 300, 2048, 208, torch.float32),
    (False, 16, 1040, 208, torch.float32),
    (True, 16, 1040, 208, torch.float32),
    (False, 300, 688, 320, torch.bfloat16),
    (True, 300, 688, 320, torch.bfloat16),
    (False, 300, 688, 320, torch.float32),
    (True, 300, 688, 320, torch.float32),
])
def test_w8a8_matmul_kernel_bit_equal_to_plain(dev, transposed, m, k, n,
                                               xd):
    """K8: exact s32 sums on both sides (above 2^24 at K = 2048 with |x|,
    |w| near 127), the same rounded epilogue -> bit-equal, in bf16 and in
    f32 output."""
    from medplib_tpu_torch.ops.cuda import int8_matmul as I
    gen = torch.Generator(device=dev).manual_seed(k + m)
    x = (torch.rand((m, k), generator=gen, device=dev) * 27 + 100) \
        * torch.randn((m, 1), generator=gen, device=dev)
    w = torch.randint(100, 128, (n, k) if transposed else (k, n),
                      generator=gen, device=dev, dtype=torch.int8)
    s = torch.rand((n, 1) if transposed else (1, n), generator=gen,
                   device=dev) * 0.01 + 1e-3
    x = x.to(xd)
    n0 = I.w8a8_matmul_2d.launches
    got = (I.w8a8_matmul_t if transposed else I.w8a8_matmul)(x, w, s)
    x_q, a_s = I.quantize_rows(x)
    want = I.w8a8_matmul_plain(x_q, a_s, w, s, transposed, x.dtype)
    torch.cuda.synchronize()
    assert I.w8a8_matmul_2d.launches == n0 + 1
    assert got.dtype == xd and got.shape == (m, n) and torch.equal(got, want)


# (x dtype, transposed, groups, M, K, N). K = 1056 at G = 8: 132-deep
# groups, ends off the 16-deep mma steps; K = 688, N = 320: ragged K and
# N (86-deep groups, a transposed row of 344 bytes); K = 1028, N = 98:
# the widths the wrapper pads for the kernel's copies (x rows to K % 8, a
# normal weight row to N % 4); M = 12 takes the decode tile, 7476 is the
# prefill M
@pytest.mark.parametrize("xd,transposed,groups,m,k,n", [
    (torch.bfloat16, False, 8, 12, 1056, 208),
    (torch.bfloat16, True, 8, 12, 1056, 208),
    (torch.bfloat16, False, 8, 300, 1056, 208),
    (torch.bfloat16, True, 2, 300, 1056, 208),
    (torch.float32, True, 8, 70, 1056, 208),
    (torch.float32, False, 2, 70, 1056, 208),
    (torch.bfloat16, True, 8, 300, 1056, 208),
    (torch.bfloat16, False, 8, 7476, 1056, 208),
    (torch.bfloat16, True, 8, 7476, 1056, 208),
    (torch.bfloat16, False, 8, 12, 688, 320),
    (torch.bfloat16, True, 8, 12, 688, 320),
    (torch.bfloat16, False, 8, 300, 688, 320),
    (torch.bfloat16, True, 8, 300, 688, 320),
    (torch.float32, False, 8, 70, 688, 320),
    (torch.float32, True, 8, 70, 688, 320),
    (torch.bfloat16, False, 2, 300, 1028, 98),
    (torch.bfloat16, True, 2, 300, 1028, 98),
])
def test_int4h_matmul_kernel_matches_plain(dev, xd, transposed, groups, m,
                                           k, n):
    """K9 against its plain version: bf16 x on the tensor cores (group
    sums scaled at each group end), f32 x on the FMA kernel (nibble *
    group scale before the product); either way the f32 sums of the plain
    version in another order, plus one rounding per weight."""
    from medplib_tpu_torch.ops.cuda import int4_matmul as I
    gen = torch.Generator(device=dev).manual_seed(m + groups + k)
    x = torch.randn((m, k), generator=gen, device=dev).to(xd)
    packed = torch.randint(-128, 128, (n, k // 2) if transposed
                           else (k // 2, n), generator=gen, device=dev,
                           dtype=torch.int8)
    s = torch.rand((groups, n, 1) if transposed else (groups, 1, n),
                   generator=gen, device=dev) * 0.01 + 1e-3
    n0 = I.int4h_matmul_2d.launches
    got = I.int4h_matmul_2d(x, packed, s, transposed)
    want = I.int4h_matmul_plain(x, packed, s, transposed)
    torch.cuda.synchronize()
    assert I.int4h_matmul_2d.launches == n0 + 1
    assert got.dtype == xd and got.shape == (m, n)
    assert _sum_order_close(got, want, x,
                            I.dequant_f32(packed, s, transposed))


# ragged widths the CUDA wrappers pad (K7, K8, K3) or take as they are
# (K9, above); K1 needs K / 2 % 128 == 0 (as the JAX kernel), so K = 768,
# with N = 320 and N = 208 (no multiple of its 64-column tile)
@pytest.mark.parametrize("kernel,transposed", [
    ("int8_matmul", False), ("int8_matmul", True), ("w8a8_matmul", False),
    ("w8a8_matmul", True), ("gmm W8A8", False), ("gmm int8-w", True),
    ("gmm float", False), ("gmm_int4h A8 320", False),
    ("gmm_int4h bf16 208", False), ("gmm_int4h A8 208", False),
])
def test_ragged_widths_match_plain(dev, kernel, transposed):
    """N = 320, K = 688 (K1: K = 768) on the card against the plain
    versions on the same operands, with the kernel tests' tolerances."""
    from medplib_tpu_torch.ops.cuda import gmm as G
    from medplib_tpu_torch.ops.cuda import int8_matmul as I
    gen = torch.Generator(device=dev).manual_seed(len(kernel) + transposed)
    k, n, m = 688, 320, 300
    if kernel.startswith("gmm"):
        e, bm = 2, 64
        if kernel.startswith("gmm_int4h"):
            k, n = 768, int(kernel.split()[-1])
        xs = torch.randn((m, k), generator=gen, device=dev)
        idx = torch.randint(0, e, (m,), generator=gen, device=dev)
        x_al, _, gid = G.align_groups(xs, idx, e, bm)
        if kernel.startswith("gmm_int4h"):
            packed, scale = _int4h(gen, e, k, n, dev)
            a8 = " A8 " in kernel
            xin, a_s = G.quantize_rows(x_al) if a8 else (x_al, None)
            fn, args = G.gmm_int4h, (xin, packed, scale, gid, a_s, bm)
            plain, exact = G.gmm_int4h_plain, a8
        else:
            mode = kernel.split()[1]
            wshape = (e, n, k) if transposed else (e, k, n)
            ws = a_s = None
            if mode == "float":
                w = (torch.randn(wshape, generator=gen, device=dev)
                     * k ** -0.5).to(torch.bfloat16)
                x_al = x_al.to(torch.bfloat16)
            else:
                w = torch.randint(-127, 128, wshape, generator=gen,
                                  device=dev, dtype=torch.int8)
                ws = torch.rand((e, 1, n), generator=gen, device=dev) \
                    * 0.01 + 1e-3
                x_al = x_al.to(torch.bfloat16)
            if mode == "W8A8":
                x_al, a_s = G.quantize_rows(x_al)
            fn, plain = G.gmm, G.gmm_plain
            args = (x_al, w, gid, ws, a_s, bm)
            exact = mode == "W8A8"
        n0 = fn.launches
        got = fn(*args) if fn is G.gmm_int4h else fn(*args,
                                                      transposed=transposed)
        want = plain(*args) if fn is G.gmm_int4h else plain(
            *args, transposed=transposed)
    else:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randint(-127, 128, (n, k) if transposed else (k, n),
                          generator=gen, device=dev, dtype=torch.int8)
        s = torch.rand((n, 1) if transposed else (1, n), generator=gen,
                       device=dev) * 0.01 + 1e-3
        if kernel == "int8_matmul":
            fn, n0 = I.int8_matmul_2d, I.int8_matmul_2d.launches
            got = fn(x, w, s, transposed)
            want = I.int8_matmul_plain(x, w, s, transposed)
            wd = w.double() * s.double()
            torch.cuda.synchronize()
            assert fn.launches == n0 + 1 and got.shape == (m, n)
            assert _sum_order_close(got, want, x,
                                    wd.t() if transposed else wd)
            return
        x_q, a_s = I.quantize_rows(x)
        fn, n0 = I.w8a8_matmul_2d, I.w8a8_matmul_2d.launches
        got = fn(x_q, a_s, w, s, transposed, torch.bfloat16)
        want = I.w8a8_matmul_plain(x_q, a_s, w, s, transposed, torch.bfloat16)
        exact = True
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.shape[1] == n
    if exact:       # integer sums, the same rounded epilogue
        assert torch.equal(got, want)
    elif fn is G.gmm:   # f32 sums in another order
        assert _gmm_sum_order_close(got, want, x_al, w, ws, gid, bm,
                                    transposed)
    else:
        rel = float((got.float() - want.float()).norm()
                    / want.float().norm())
        assert rel < (1e-5 if got.dtype == torch.float32 else 4e-3)


def test_span_summary_puts_moe_kernels_under_moe_experts(dev):
    """A small MoE generate (tests/test_torch_profiling.py's model, B=16 x
    1264 spliced tokens) on the card under torch.profiler and
    utils/profiling.recording(): every K1 launch (W4A8 prefill) and every
    K2 kernel (fused decode) belongs to moe.experts through the launch's
    CUPTI correlation, there are MAX_NEW decode steps, and the spans below
    `generate` hold at least 95% of the device time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from medplib_tpu_torch.models import medplib
    from medplib_tpu_torch.utils import profiling
    from medplib_tpu_torch.utils.quantize import (dynamic_act_quant,
                                                  quantize_flagship_moe)
    from test_torch_profiling import MAX_NEW, _batch, _cfg
    cfg = _cfg()
    p = medplib.init_medplib(torch.Generator(device=dev).manual_seed(0),
                             cfg, torch.float32, dev)
    p["llm"]["embed_tokens"]["embedding"] *= 50.0
    p = quantize_flagship_moe(p, 4, 8)
    batch = medplib.Batch(*(t.to(dev) if t is not None else None for t in
                            _batch(cfg, 16, 64, np.random.default_rng(0))))
    # one DeepSeek-V2 top-4 of 8 MoE layer (int4h experts) beside it, for
    # the top-k combine
    from medplib_tpu_torch.config import DeepseekMoeConfig
    from medplib_tpu_torch.models import deepseek_v2
    from medplib_tpu_torch.ops.cuda import moe_prefill as P
    gen = torch.Generator(device=dev).manual_seed(1)
    dcfg = DeepseekMoeConfig(enable=True, num_experts=8, top_k=4,
                             moe_intermediate_size=256, num_shared_experts=1)
    experts = {}
    for name, (kk, nn) in (("gate_proj", (256, 256)), ("up_proj", (256, 256)),
                           ("down_proj", (256, 256))):
        packed, scale = _int4h(gen, 8, kk, nn, dev)
        experts[name] = {"kernel": packed, "scale4h": scale}
    layer = {"router": {"kernel": torch.randn((256, 8), generator=gen,
                                              device=dev)},
             "experts": experts,
             "shared_mlp": {n: {"kernel": torch.randn(
                 (256, 256), generator=gen, device=dev).to(torch.bfloat16)
                 * 0.05} for n in ("gate_proj", "up_proj", "down_proj")}}
    xd = torch.randn((2, 300, 256), generator=gen, device=dev).to(
        torch.bfloat16)
    from medplib_tpu_torch.ops.cuda import gmm as G
    passes = (G.gmm_int4h, P.moe_dispatch_quant, P.moe_swiglu_quant,
              P.moe_topk_combine)
    with dynamic_act_quant(True):
        medplib.generate(p, cfg, batch, max_new_tokens=MAX_NEW)
        deepseek_v2.moe_layer(layer, xd, dcfg)
        torch.cuda.synchronize()
        n0 = [f.launches for f in passes]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof, \
                profiling.recording() as rec:
            medplib.generate(p, cfg, batch, max_new_tokens=MAX_NEW)
            deepseek_v2.moe_layer(layer, xd, dcfg)
            torch.cuda.synchronize()
    # every grouped SwiGLU (K1 three times): dispatch and SwiGLU-quantize
    # once; the top-k combine only in the top-k layer
    k1, *got = [f.launches - c for f, c in zip(passes, n0)]
    assert k1 > 3 and got == [k1 // 3, k1 // 3, 1]
    out = profiling.span_summary(prof, rec)
    spans = out["spans"]
    moe = ("s8_mma_kernel", "moe_prep_kernel", "moe_gateup_kernel",
           "moe_act_kernel", "moe_down_kernel", "moe_combine_kernel",
           "moe_dispatch_quant_kernel", "moe_swiglu_quant_kernel",
           "moe_topk_combine_kernel")
    under = {k for k in moe
             if any(k in n for n in spans["moe.experts"]["self_kernels"])}
    assert under == set(moe)
    for name, r in spans.items():
        if name != "moe.experts":
            assert not [n for n in r["self_kernels"]
                        if any(k in n for k in moe)], name
    assert spans["decode_step"]["instances"] == MAX_NEW
    outside = spans["generate"]["self_device_s"] + \
        spans.get(None, {"device_s": 0.0})["device_s"]
    assert out["device_s"] > 0 and outside <= 0.05 * out["device_s"]


def test_engine_card_matches_cpu(dev):
    """The tiny int4h MoE serving model (chip_smoke.tiny_serving_cfg)
    through BatchedEngine on the CPU and on the card: 4 slots, 4 requests
    with <SEG>, group admission, prefill_chunk 256 (a group pads to 4 x
    256 = 1024 rows: K1). Equal tokens; the card launches K1 3 per layer
    per extend of >= 1024 rows and K2 once per layer per decode step, the
    CPU nothing."""
    import numpy as np

    import chip_smoke as cs
    from medplib_tpu_torch.ops.cuda import gmm as G
    from medplib_tpu_torch.ops.cuda import moe_decode as D
    from medplib_tpu_torch.serve.engine import BatchedEngine
    from medplib_tpu_torch.utils.convert import tree_from_numpy
    cfg = cs.tiny_serving_cfg(512, 8)
    host = cs._tiny_moe_tree(cfg, 4)
    L = cfg.llm.num_layers
    toks = {}
    for where in ("cpu", dev):
        rng = np.random.default_rng(0)
        batches = [cs.engine_request(cfg, i, 64, rng, where, seg=True)
                   for i in range(4)]
        eng = BatchedEngine(cfg, tree_from_numpy(host, where), slots=4,
                            max_new_tokens=8, chunk=4, group_admission=True,
                            prefill_chunk=256)
        try:
            k1, k2 = G.gmm_int4h.launches, D.moe_ffn_decode_int4h.launches
            with cs.engine_tally() as tally:
                reqs, toks[str(where)], _ = cs.engine_wave(eng, batches,
                                                           timeout=300)
            launched = (G.gmm_int4h.launches - k1,
                        D.moe_ffn_decode_int4h.launches - k2)
        finally:
            eng.shutdown()
        assert all(r.error is None for r in reqs)
        assert tally.k1_extends() >= 1
        assert launched == ((0, 0) if where == "cpu" else
                            (3 * L * tally.k1_extends(), L * tally.steps))
    assert toks["cpu"] == toks[str(dev)]


def test_worker_card_matches_cpu(dev):
    """The serving worker (serve/worker.py, batched) on the tiny int4h MoE
    model with the region adapter, on the CPU and on the card: greedy,
    <SEG>, region and seeded sampled PNG requests give equal texts, masks
    within 1% of pixels, K2 once per layer per decode step on the card
    (chip_smoke.small_worker_check)."""
    import chip_smoke as cs
    out = cs.small_worker_check(dev)
    assert set(out["cpu"]) == {"vqa", "seg", "region", "sampled"}


def test_sam_predict_card_matches_cpu(dev):
    """SamPredictor.predict at SamConfig.tiny (f32) on the card against
    the same predictor on the CPU: points, a box, points + box, then a
    mask prompt from the previous low-res logits; IoU predictions 1e-3,
    low-res logits 1e-3 norm-relative, masks within 0.1% of pixels
    (chip_smoke.sam_card_vs_cpu)."""
    import numpy as np

    import chip_smoke as cs
    from medplib_tpu_torch.config import SamConfig
    from medplib_tpu_torch.models import sam_med2d
    cfg = SamConfig.tiny()
    params = sam_med2d.init_sam(torch.Generator().manual_seed(0), cfg,
                                torch.float32, "cpu")
    img = np.random.default_rng(0).integers(0, 256, (48, 80, 3)).astype(
        np.uint8)
    _, worst = cs.sam_card_vs_cpu(dev, cfg, params, img)
    assert set(worst) == {"iou", "logits", "pixels"}


def test_moe_train_card_matches_cpu(dev):
    """Two steps of the tiny stage-4-style model (sparse Residual-MoE,
    top-1 at capacity 1.5, a skewed router that drops tokens, a 1039-token
    row through K4-K6) on the card and on the CPU: losses 1e-4 relative,
    LoRA updates 1e-2 (chip_smoke.moe_train_check)."""
    import chip_smoke as cs
    cs.moe_train_check(dev)


def test_train_cli_on_card(dev):
    """train/cli.py --tiny --moe-enable with donor experts on the card:
    two steps, a checkpoint, validation, then --eval-only to the same
    numbers (chip_smoke.cli_check)."""
    import math

    import chip_smoke as cs
    vres = cs.cli_check(dev)
    assert set(vres) == {"giou", "ciou", "miou", "dice", "loss"}
    assert all(math.isfinite(v) for v in vres.values())


def test_stage4_step_and_validate_at_two_layers(dev):
    """The stage-4 phase at full width and 2 layers: ga 8 x B=4 x 1087
    tokens, flash launches 8 x (4, 2, 2) a step, frozen bf16 experts
    unchanged, lora_b moved, no SDPA; validation K3 3 x 2 and K4 2 a
    batch, finite metrics (chip_smoke.moe_train_phase checks each)."""
    import chip_smoke as cs
    out = cs.moe_train_phase(dev, cs.gpu_line(), layers=2)
    assert out["tok_s"] > 0 and len(out["aux"]) == 8


def test_export_pipeline_card_matches_cpu(dev):
    """The tiny int4h MoE serving model with LoRA q / v: merge_lora ->
    quantize_flagship_moe -> generate on the card and on the CPU, tokens
    and masks as the tiny checks hold them, K1 6 / K2 8 on the card
    (chip_smoke.small_export_check)."""
    import chip_smoke as cs
    cs.small_export_check(dev)


def test_block_int4_linear_card_matches_cpu(dev):
    """int4_scheme="block" on the card and on the CPU: equal packed bytes
    and scales, linear / linear_t within 1e-5 norm-relative in f32, at
    a 1024 x 2816 kernel and its transpose
    (chip_smoke.block_int4_check)."""
    import chip_smoke as cs
    w = torch.randn((1024, 2816), generator=torch.Generator().manual_seed(0))
    out = cs.block_int4_check(dev, w.to(torch.bfloat16))
    assert set(out) == {"up_proj", "q_proj"}


def test_mpt_tiny_card_matches_cpu(dev):
    """A tiny ALiBi MPT in f32: greedy tokens equal on the card and the
    CPU, logits within 1e-4 (chip_smoke.small_mpt_check)."""
    import chip_smoke as cs
    assert cs.small_mpt_check(dev) <= 1e-4


def test_export_path_at_two_layers(dev):
    """The stage-4 phase at full width and 2 layers, then export_path on
    its trained tree: the merge held element by element and in the
    teacher-forced logits, the file tools and the command line round
    trip, the exported decoder, block int4, and the merged tree served
    (K1 6, K2 20 a call; repeats equal)."""
    import chip_smoke as cs
    from medplib_tpu_torch.config import flagship_cfg
    out = cs.moe_train_phase(dev, cs.gpu_line(), layers=2, keep_params=True)
    exp = cs.export_path(dev, cs.gpu_line(), out.pop("params"), 0.0,
                         cfg=flagship_cfg(2, moe=True))
    assert exp["masks_s"] > 0 and exp["agree"] >= cs.MERGE_MIN_AGREE


# ---------------------------------------------------------------------------
# DeepSeek-V2: K4 at q / k 192, v 128; K2 with k experts a row
# ---------------------------------------------------------------------------

def _mla_qkv(gen, b, t, dev, lens=None):
    """bf16 q / k [B, T, 16, 192], v [B, T, 16, 128] and a right-padded
    mask (row lengths `lens`, else T)."""
    q, k = (torch.randn((b, t, 16, 192), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    v = torch.randn((b, t, 16, 128), generator=gen, device=dev) \
        .to(torch.bfloat16)
    mask = torch.ones((b, t), dtype=torch.int32, device=dev)
    for r, n in enumerate(lens or ()):
        mask[r, n:] = 0
    return q, k, v, mask


def _cuda_ms(fn, n=20):
    fn()
    torch.cuda.synchronize()
    a, z = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        fn()
    z.record()
    torch.cuda.synchronize()
    return a.elapsed_time(z) / n


@pytest.mark.parametrize("b,t,spread", [(64, 687, True), (1, 623, False),
                                        (3, 130, True)])
def test_flash_forward_qk192_v128_matches_plain(dev, b, t, spread):
    """K4 <192, 128> with DeepSeek-V2-Lite's YaRN softmax scale against
    flash_forward_plain at the serving shape (B = 64 rows of 623-687 of
    687 positions), B = 1 and a ragged T: out within rel Frobenius 1e-3
    over the rows that keep a key (f32 sums in another order, P split
    hi + lo, then bf16 rounding; the D = 128 kernel reads 8e-5), lse
    within 1e-4; counted as one launch of the instantiation. Its time is
    printed beside its bound (portbench/counts_dsv2.k4_bound_s)."""
    from medplib_tpu_torch.ops.cuda import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(b * t)
    lens = ([round(t * 623 / 687 + (t - t * 623 / 687) * r / max(b - 1, 1))
             for r in range(b)] if spread else None)
    q, k, v, mask = _mla_qkv(gen, b, t, dev, lens)
    scale = 192 ** -0.5 * (0.1 * 0.707 * __import__("math").log(40) + 1) ** 2
    n0, n1 = FA.flash_forward.launches, FA.flash_forward.launches_qk192
    out, lse = FA.flash_forward(q, k, v, mask, scale)
    torch.cuda.synchronize()
    assert (FA.flash_forward.launches, FA.flash_forward.launches_qk192) \
        == (n0 + 1, n1 + 1)
    assert out.shape == (b, t, 16, 128) and out.dtype == torch.bfloat16
    want_out, want_lse = FA.flash_forward_plain(q, k, v, mask, scale)
    lv = FA._keep(mask, t, t).any(-1)[:, 0][..., None].expand(-1, -1, 16)
    rel = float((out[lv].float() - want_out[lv].float()).norm()
                / want_out[lv].float().norm())
    assert rel < 1e-3
    assert float((lse.transpose(1, 2)[lv]
                  - want_lse.transpose(1, 2)[lv]).abs().max()) < 1e-4
    assert bool(torch.isfinite(out.float()).all())
    ms = _cuda_ms(lambda: FA.flash_forward(q, k, v, mask, scale))
    plain = _cuda_ms(lambda: FA.flash_forward_plain(q, k, v, mask, scale),
                     3)
    lens_ = lens or [t] * b
    by = b * t * 16 * (2 * 192 + 2 * 128) * 2 + b * 16 * t * 4
    pairs = sum(n * (n + 1) / 2 + (t - n) * n for n in lens_)
    bound = max(by / 3.35e12, pairs * 16 * 640 / 989e12) * 1e3
    print(f"[k4-192] B={b} T={t} rel {rel:.2e} kernel {ms:.3f} ms, plain "
          f"{plain:.3f} ms, bound {bound:.3f} ms ({100 * bound / ms:.1f}%)")


def test_causal_attention_takes_k4_qk192_on_card(dev):
    """causal_attention at q / k 192, v 128 in bf16 goes to K4 (no plain
    call); the D = 128 kernel on the same layout is the same kernel as
    before (out within rel 1e-3 of plain)."""
    from medplib_tpu_torch.ops import attention as A
    from medplib_tpu_torch.ops.cuda import flash_attention as FA
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v, mask = _mla_qkv(gen, 4, 200, dev, [200, 190, 150, 101])
    plain0, n0 = A.causal_attention.plain_calls, \
        FA.flash_forward.launches_qk192
    out = A.causal_attention(q, k, v, mask, scale=0.1)
    assert A.causal_attention.plain_calls == plain0
    assert FA.flash_forward.launches_qk192 == n0 + 1
    want = A._plain_attention(q, k, v, A.make_causal_bias(mask, 200, 200),
                              0.1)
    rel = float((out.float() - want.float()).norm() / want.float().norm())
    assert rel < 5e-3      # the plain path rounds P to bf16 (~2.6e-3)
    q2, k2, v2 = (x[..., :128].contiguous() for x in (q, k, q))
    o2, _ = FA.flash_forward(q2, k2, v2, mask)
    w2, _ = FA.flash_forward_plain(q2, k2, v2, mask)
    assert FA.flash_forward.launches_qk192 == n0 + 1
    assert float((o2.float() - w2.float()).norm() / w2.float().norm()) < 1e-3


@pytest.mark.parametrize("a8", [True, False])
def test_k2_topk_rows_match_plain(dev, a8):
    """K2 with 6 of 64 experts a row (DeepSeek-V2-Lite's decode at B = 64,
    expert width 1536 padded) against its plain version: A8 bit-equal (the
    integer products and the combine's order are the plain version's),
    bf16 within rel 1e-4; top-1 rows as [B] and as [B, 1] give the same
    bits."""
    from medplib_tpu_torch.ops.cuda import moe_decode as D
    gen = torch.Generator(device=dev).manual_seed(6)
    e, h, m, b = 64, 2048, 1536, 64
    experts = {}
    for name, (kk, nn) in (("gate_proj", (h, m)), ("up_proj", (h, m)),
                           ("down_proj", (m, h))):
        p, s = _int4h(gen, e, kk, nn, dev)
        experts[name] = {"kernel": p, "scale4h": s}
    x = torch.randn((b, h), generator=gen, device=dev).to(torch.bfloat16)
    idx = torch.stack([torch.randperm(e, generator=gen, device=dev)[:6]
                       for _ in range(b)]).to(torch.int32)
    w = torch.rand((b, 6), generator=gen, device=dev) * 0.2
    n0 = D.moe_ffn_decode_int4h.launches
    got = D.moe_ffn_decode_int4h(x, experts, idx, w, e, int8_x=a8)
    torch.cuda.synchronize()
    assert D.moe_ffn_decode_int4h.launches == n0 + 1
    want = D.moe_ffn_decode_int4h_plain(x, experts, idx, w, e, int8_x=a8)
    if a8:
        assert torch.equal(got, want)
    else:
        assert float((got.float() - want.float()).norm()
                     / want.float().norm()) < 1e-4
    one = D.moe_ffn_decode_int4h(x, experts, idx[:, 0], w[:, 0], e,
                                 int8_x=a8)
    assert torch.equal(one, D.moe_ffn_decode_int4h(
        x, experts, idx[:, :1], w[:, :1], e, int8_x=a8))


def _routes(gen, dev, s, e, k):
    """[S·k] token-major expert ids: k distinct of e a token."""
    if k == 1:
        return torch.randint(0, e, (s,), generator=gen, device=dev)
    scores = torch.rand((s, e), generator=gen, device=dev)
    return scores.topk(k, -1).indices.reshape(-1)


# the two cells' widths: DeepSeek-V2-Lite (H 2048, expert width 1408
# padded to 1536, top-6 of 64) and the flagship (H 4096, M 11264, top-1
# of 2, two-ended); S tokens at the prefill's block_m of 512
@pytest.mark.parametrize("h,m,e,k,s", [(2048, 1536, 64, 6, 4096),
                                       (4096, 11264, 2, 1, 2048)])
def test_moe_prefill_kernels_match_plain(dev, h, m, e, k, s):
    """The three int8 prefill passes against their plain versions: the
    dispatch's int8 rows and scales (K1's input) and the SwiGLU-quantize's
    (the down projection's input, from K1's own gate / up output) bit-equal
    at every aligned row, gap rows included; the top-k combine within one
    bf16 ulp, plus the f32 summation bounds of both orders where the
    products cancel (chip_smoke.combine_order_close): the tolerance is for
    the order of the f32 sum, which the kernel fixes in its own code and
    PyTorch in its reduction's. One counted launch each."""
    import chip_smoke as cs
    from medplib_tpu_torch.ops.cuda import gmm as G
    from medplib_tpu_torch.ops.cuda import moe_prefill as P
    gen = torch.Generator(device=dev).manual_seed(h + k)
    xs = (torch.randn((s, h), generator=gen, device=dev) * 0.5).to(
        torch.bfloat16)
    xs[5] = 0.0
    dest, gid, sp = G.align_rows(_routes(gen, dev, s, e, k), e, 512)
    n0 = (P.moe_dispatch_quant.launches, P.moe_swiglu_quant.launches,
          P.moe_topk_combine.launches)
    xq, xsc = P.moe_dispatch_quant(xs, dest, sp, k)
    wq, wsc = P.moe_dispatch_quant_plain(xs, dest, sp, k)
    torch.cuda.synchronize()
    assert torch.equal(xq, wq) and torch.equal(xsc, wsc)
    gp, gs = _int4h(gen, e, h, m, dev)
    up, us = _int4h(gen, e, h, m, dev)
    h1 = G.gmm_int4h(xq, gp, gs, gid, a_scale=xsc)
    h2 = G.gmm_int4h(xq, up, us, gid, a_scale=xsc)
    aq, asc = P.moe_swiglu_quant(h1, h2)
    wq, wsc = P.moe_swiglu_quant_plain(h1, h2)
    torch.cuda.synchronize()
    assert torch.equal(aq, wq) and torch.equal(asc, wsc)
    y_al = (torch.randn((sp, h), generator=gen, device=dev) * 0.1).to(
        torch.bfloat16)
    w = torch.softmax(torch.randn((s, k), generator=gen, device=dev), -1)
    y = P.moe_topk_combine(y_al, dest, w, torch.bfloat16)
    want = P.moe_topk_combine_plain(y_al, dest, w, torch.bfloat16)
    torch.cuda.synchronize()
    assert cs.combine_order_close(y, want, y_al, dest, w)[0]
    assert (P.moe_dispatch_quant.launches, P.moe_swiglu_quant.launches,
            P.moe_topk_combine.launches) == tuple(c + 1 for c in n0)


def test_topk_moe_prefill_takes_no_host_sync(dev):
    """One DeepSeek-V2-Lite MoE layer at prefill on the card (int4h routed
    experts, int8 shared experts under W4A8 / W8A8, 2048 tokens) runs
    under torch.cuda.set_sync_debug_mode("error"): the routing, the
    aligned layout (no CUDA bincount), the three int8 passes and K1 never
    wait on the host. It launches K1 three times and each pass once."""
    from medplib_tpu_torch.config import DeepseekMoeConfig
    from medplib_tpu_torch.models import deepseek_v2
    from medplib_tpu_torch.ops.cuda import gmm as G
    from medplib_tpu_torch.ops.cuda import moe_prefill as P
    from medplib_tpu_torch.utils.quantize import (dynamic_act_quant,
                                                  quantize_tree)
    h, m, e, k, ms = 2048, 1536, 64, 6, 2816
    cfg = DeepseekMoeConfig(enable=True, num_experts=e, top_k=k,
                            moe_intermediate_size=1408, num_shared_experts=2)
    gen = torch.Generator(device=dev).manual_seed(9)
    experts = {}
    for name, (kk, nn) in (("gate_proj", (h, m)), ("up_proj", (h, m)),
                           ("down_proj", (m, h))):
        packed, scale = _int4h(gen, e, kk, nn, dev)
        experts[name] = {"kernel": packed, "scale4h": scale}
    shared = {n: {"kernel": torch.randn(shape, generator=gen, device=dev)
                  * 0.02} for n, shape in (("gate_proj", (h, ms)),
                                           ("up_proj", (h, ms)),
                                           ("down_proj", (ms, h)))}
    params = {"router": {"kernel": torch.randn((h, e), generator=gen,
                                               device=dev) * 0.05},
              "experts": experts,
              "shared_mlp": quantize_tree({"mlp": shared}, skip=())["mlp"]}
    x = torch.randn((4, 512, h), generator=gen, device=dev).to(
        torch.bfloat16)
    wrappers = (G.gmm_int4h, P.moe_dispatch_quant, P.moe_swiglu_quant,
                P.moe_topk_combine)
    with dynamic_act_quant(True):
        deepseek_v2.moe_layer(params, x, cfg)          # builds, allocates, warms up
        torch.cuda.synchronize()
        n0 = [f.launches for f in wrappers]
        torch.cuda.set_sync_debug_mode("error")
        try:
            y = deepseek_v2.moe_layer(params, x, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert y.shape == x.shape and bool(torch.isfinite(y.float()).all())
    assert [f.launches - c for f, c in zip(wrappers, n0)] == [3, 1, 1, 1]


def test_dsv2_tiny_cell_on_card(tmp_path):
    """The tiny DeepSeek-V2 cell (portbench/tests/tiny_dsv2.py) traced on the
    card: correct, K4 <192, 128> once a layer a call with no plain
    attention, K1 at prefill and K2 at decode counted, and the new
    per-layer metrics read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import time
    from medplib_tpu_torch.ops.cuda import _build
    from medplib_tpu_torch.ops.cuda import gmm as G
    from medplib_tpu_torch.ops.cuda import moe_prefill as P
    from portbench import harness
    from portbench.tests import tiny_dsv2 as tiny
    _build.load_library()
    bench = tiny.write(tmp_path)
    wrappers = (G.gmm_int4h, P.moe_dispatch_quant, P.moe_swiglu_quant,
                P.moe_topk_combine)
    n0 = [f.launches for f in wrappers]
    out = harness.run_cell(tiny.CELL, 2 ** 31 + 77, 1.0, True,
                           "cuda:0", time.time(), bench_path=bench,
                           root=tmp_path)
    assert out["correct"] is True
    # every MoE layer's prefill: K1 three times, each int8 pass once
    k1, *passes = [f.launches - c for f, c in zip(wrappers, n0)]
    assert k1 > 0 and passes == [k1 // 3] * 3
    la = out["launches"]
    assert la["plain_attention"] == 0 and la["K4_qk192"] == 3 * 2
    assert la["K1"] > 0 and la["K2"] == 2 * 2 * 3    # 2 MoE layers
    for name in ("k4_roofline.serve", "attn_ms.serve", "moe_ms.serve"):
        assert name in out["metrics"], name
