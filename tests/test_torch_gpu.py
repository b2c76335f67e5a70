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


def _int4h(gen, e, k, n, dev):
    packed = torch.randint(-128, 128, (e, k // 2, n), generator=gen,
                           device=dev, dtype=torch.int8)
    scale = torch.rand((e, 2, 1, n), generator=gen, device=dev) * 0.01 + 1e-3
    return packed, scale


@pytest.mark.parametrize("block_m", [64, 32])
@pytest.mark.parametrize("a8", [True, False])
def test_gmm_int4h_kernel_matches_plain(dev, block_m, a8):
    """A8: exact integer sums, same epilogue ops -> within one bf16 ulp.
    bf16 x: f32 sums in another order -> rel 1e-5."""
    from medplib_tpu_torch.ops.cuda import gmm as G
    gen = torch.Generator(device=dev).manual_seed(0)
    packed, scale = _int4h(gen, 2, 512, 192, dev)
    xs = torch.randn((300, 512), generator=gen, device=dev)
    idx = torch.randint(0, 2, (300,), generator=gen, device=dev)
    x_al, _, gid = G.align_groups(xs, idx, 2, block_m)
    xin, a_s = G.quantize_rows(x_al) if a8 else (x_al, None)
    n0 = G.gmm_int4h.launches
    got = G.gmm_int4h(xin, packed, scale, gid, a_s, block_m)
    want = G.gmm_int4h_plain(xin, packed, scale, gid, a_s, block_m)
    torch.cuda.synchronize()
    assert G.gmm_int4h.launches == n0 + 1
    if a8:
        d = (got.float() - want.float()).abs()
        assert bool((d <= want.float().abs() * 2.0 ** -7).all())
    else:
        assert float((got - want).norm() / want.norm()) < 1e-5


@pytest.mark.parametrize("b", [16, 5, 40])
@pytest.mark.parametrize("a8", [True, False])
def test_moe_decode_kernel_matches_plain(dev, b, a8):
    """Same op order on both sides; exp() may differ in its last bit and
    flip a rare act-quant / bf16 rounding by one step: rel 1e-3."""
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
    got = D.moe_ffn_decode_int4h(x, experts, idx, gate, e, a8)
    want = D.moe_ffn_decode_int4h_plain(x, experts, idx, gate, e, a8)
    torch.cuda.synchronize()
    assert got.shape == (b, h) and got.dtype == torch.bfloat16
    assert float((got.float() - want.float()).norm()
                 / want.float().norm()) < 1e-3


def test_long_prompt_attention_raises_until_flash_is_ported(dev):
    from medplib_tpu_torch.ops.attention import causal_attention
    q = torch.zeros((1, 1024, 2, 128), device=dev)
    with pytest.raises(NotImplementedError, match="flash"):
        causal_attention(q, q, q)
