"""DeepSeek-V2 as MedPLIB's language model (config.MlaConfig +
DeepseekMoeConfig, models/mla.py, models/deepseek_v2.py, ops/moe.topk_moe)
on the CPU, against the benchmark's plain float32 reference
(portbench/reference/dsv2.py, which imports nothing of the port), at a
tiny shape: hidden 128, 4 heads, latent 32, rope 16, nope 32, v 32, 8
experts top-3, 1 shared, 3 layers with layer 0 dense. The JAX package
has no MLA, so nothing here compares with it.

Float trees are compared to 1e-5 relative (f32 sums in other orders);
the served (int8 / int4h, bf16) tree through the benchmark's comparison.
"""

import dataclasses
import math
import time

import pytest
import torch

from medplib_tpu_torch import config as C
from medplib_tpu_torch.models import deepseek_v2, llama, medplib, mla
from medplib_tpu_torch.ops import attention as A
from medplib_tpu_torch.ops import moe as M
from medplib_tpu_torch.ops import rope as R
from medplib_tpu_torch.ops.cuda import moe_decode as D
from medplib_tpu_torch.utils import profiling
from portbench.reference import dsv2 as ref

torch.set_num_threads(1)

CFG = C.MlaConfig.tiny()
MOE = C.DeepseekMoeConfig.tiny()


def _params(seed=1):
    gen = torch.Generator().manual_seed(seed)
    p = deepseek_v2.init_deepseek_v2(gen, CFG, MOE, torch.float32, None,
                                     "cpu")
    # norm weights away from 1, so that each one is read
    for node in (p["layers"]["input_layernorm"],
                 p["layers"]["post_attention_layernorm"],
                 p["layers"]["attn"]["kv_a_layernorm"], p["norm"]):
        node["weight"] = 1 + 0.1 * torch.randn(node["weight"].shape,
                                               generator=gen)
    return p


def _model_dict():
    """The tiny config under the published config.json keys."""
    return {"hidden_size": CFG.hidden_size,
            "num_hidden_layers": CFG.num_layers,
            "rms_norm_eps": CFG.rms_norm_eps,
            "num_attention_heads": CFG.num_heads,
            "kv_lora_rank": CFG.kv_lora_rank,
            "qk_nope_head_dim": CFG.qk_nope_head_dim,
            "qk_rope_head_dim": CFG.qk_rope_head_dim,
            "v_head_dim": CFG.v_head_dim,
            "intermediate_size": CFG.intermediate_size,
            "n_routed_experts": MOE.num_experts,
            "num_experts_per_tok": MOE.top_k,
            "moe_intermediate_size": MOE.moe_intermediate_size,
            "n_shared_experts": MOE.num_shared_experts,
            "first_k_dense_replace": MOE.first_k_dense_replace,
            "norm_topk_prob": MOE.norm_topk_prob,
            "routed_scaling_factor": MOE.routed_scaling_factor,
            "rope_theta": CFG.rope_theta,
            "rope_scaling": dict(dataclasses.asdict(CFG.rope_scaling),
                                 type="yarn"),
            "serving": {"expert_bits": 16}}


class TreeWeights:
    """The reference's weight reader over the port's float tree (key
    paths as the benchmark draws them; MoE stacks by absolute layer)."""

    def __init__(self, params):
        self.p = params

    def __call__(self, path, shape, layer=None):
        parts = path.split("/")
        node = self.p
        for k in parts[1:]:
            node = node[k]
        if layer is not None:
            node = node[layer - MOE.first_k_dense_replace
                        if parts[1] == "moe" else layer]
        assert tuple(node.shape) == tuple(shape), path
        return node.float()


def _rel(a, b):
    return float((a - b).norm() / b.norm())


# ---------------------------------------------------------------------------
# configuration and rope
# ---------------------------------------------------------------------------

def test_config_json_round_trip():
    cfg = C.MedplibConfig.tiny(llm=CFG, moe=MOE)
    back = C.from_json(C.to_json(cfg))
    assert back == cfg
    assert type(back.llm) is C.MlaConfig and type(back.moe) is \
        C.DeepseekMoeConfig
    assert type(back.llm.rope_scaling) is C.YarnScaling
    assert C.is_mla(back.llm) and not C.is_mla(C.LlamaConfig())
    assert MOE.layer_indices(3) == (1, 2)
    assert CFG.q_head_dim == 48 and CFG.latent_dim == 48


def test_yarn_frequencies_and_scale():
    """DeepSeek-V2-Lite's YaRN (factor 40, beta 32 / 1, 4096 original
    positions, rope dim 64): the original frequencies below the low
    correction dim (10), the 1/40 ones from the high one (23), the
    reference's inv_freq bit for bit; the softmax scale 192^-0.5 x
    (0.1 x 0.707 x ln 40 + 1)^2 and a cos / sin factor of 1."""
    y = C.YarnScaling()
    inv, msc = R.yarn_freqs(64, 10000.0, y)
    orig = 1.0 / (10000.0 ** (torch.arange(0, 64, 2).float() / 64))
    assert torch.equal(inv[:10], orig[:10])
    assert torch.allclose(inv[23:], orig[23:] / 40, rtol=1e-6)
    assert bool((inv[10:23] <= orig[10:23]).all())
    want, want_msc = ref.yarn_inv_freq(64, 10000.0, dataclasses.asdict(y),
                                       "cpu")
    assert torch.equal(inv, want) and msc == want_msc == 1.0
    lite = C.MlaConfig(rope_scaling=y)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert R.mla_softmax_scale(lite) == pytest.approx(192 ** -0.5 * m * m,
                                                      rel=1e-12)
    assert R.mla_softmax_scale(dataclasses.replace(lite, rope_scaling=None)) \
        == 192 ** -0.5
    model = {"qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
             "rope_scaling": dataclasses.asdict(y)}
    assert ref.softmax_scale(model) == pytest.approx(
        R.mla_softmax_scale(lite), rel=1e-12)


def test_interleaved_rope_matches_reference():
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, 9, 3, 16), generator=gen)
    pos = torch.arange(9)
    cos, sin = R.mla_rope_cos_sin(pos[None].expand(2, 9), CFG)
    got = R.apply_rope_interleaved(x, cos, sin)
    want = ref.rope(x.transpose(1, 2), pos, _model_dict()).transpose(1, 2)
    assert _rel(got, want) < 1e-6


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def test_causal_attention_qk_ne_v_on_the_plain_route():
    """q / k heads of 48, v heads of 32, a padding mask and a scale of
    its own, against the softmax written out; counted as a plain call."""
    gen = torch.Generator().manual_seed(3)
    q, k = (torch.randn((2, 7, 4, 48), generator=gen) for _ in range(2))
    v = torch.randn((2, 7, 4, 32), generator=gen)
    mask = torch.ones((2, 7), dtype=torch.int32)
    mask[1, 5:] = 0
    n0 = A.causal_attention.plain_calls
    got = A.causal_attention(q, k, v, mask, scale=0.3)
    assert A.causal_attention.plain_calls == n0 + 1
    s = torch.einsum("bthd,bshd->bhts", q, k) * 0.3
    keep = torch.tril(torch.ones(7, 7, dtype=torch.bool))[None, None] \
        & mask.bool()[:, None, None, :]
    p = torch.softmax(s.masked_fill(~keep, -1e30), -1)
    want = torch.einsum("bhts,bshd->bthd", p, v)
    assert got.shape == (2, 7, 4, 32)
    assert _rel(got, want) < 1e-6


def test_absorbed_decode_matches_expanded():
    """Prefill of T tokens into the latent cache, then one absorbed decode
    step, equals the expanded attention of T + 1 tokens at the last
    position; the decode step wrote the token's latent at row length."""
    p = llama.layer_params(_params()["layers"]["attn"], 1)
    gen = torch.Generator().manual_seed(4)
    b, t = 3, 11
    h = torch.randn((b, t + 1, CFG.hidden_size), generator=gen)
    pos = torch.arange(t + 1)[None].expand(b, t + 1)
    cos, sin = R.mla_rope_cos_sin(pos, CFG)
    full = mla.prefill_attention(p, h, CFG, cos, sin, None)
    cache = torch.zeros((b, t + 4, CFG.latent_dim))
    mla.prefill_attention(p, h[:, :t], CFG, cos[:, :t], sin[:, :t], None,
                          cache)
    step = mla.decode_attention(p, h[:, t:], CFG, cos[:, t:], sin[:, t:],
                                cache, torch.full((b,), t,
                                                  dtype=torch.int32))
    assert _rel(step, full[:, t:]) < 1e-5
    lat = mla._compress(p, h, CFG, cos, sin)
    assert torch.allclose(cache[:, :t + 1], lat, rtol=1e-6, atol=1e-6)
    assert not cache[:, t + 1:].any()


def test_llm_prefill_and_cached_decode_match_reference():
    """deepseek_v2.forward (prefill into the latent cache) then decode
    steps through the cache, against the reference's full forward of the
    same sequence: every position's final hidden state and logits."""
    p = _params()
    gen = torch.Generator().manual_seed(5)
    b, t, new = 2, 20, 4
    x = 0.5 * torch.randn((b, t + new, CFG.hidden_size), generator=gen)
    with torch.no_grad():
        want = ref.decoder(TreeWeights(p), _model_dict(), x.clone(),
                           [t + new] * b, 16)
        cache = mla.LatentCache.init(CFG, b, t + new, torch.float32, "cpu")
        h, cache, _ = deepseek_v2.forward(p, CFG, MOE, x[:, :t], None, None,
                                          cache)
        got = [h]
        for j in range(new):
            hj, cache = deepseek_v2.forward_decode(
                p, CFG, MOE, x[:, t + j:t + j + 1], cache)
            got.append(hj)
        got = torch.cat(got, 1)
    assert _rel(got, want) < 1e-5
    head = p["lm_head"]["kernel"]
    assert _rel(got @ head, want @ head) < 1e-5
    assert cache.length.tolist() == [t + new] * b


def test_topk_moe_with_shared_experts_matches_reference():
    """deepseek_v2.moe_layer, ops/moe.topk_moe's routed experts (float
    experts: the grouped path at prefill and at decode) plus the shared
    experts, against the reference's MoE block; the route span carries k
    and E."""
    p = _params()
    gen = torch.Generator().manual_seed(6)
    y = torch.randn((2, 13, CFG.hidden_size), generator=gen)
    layer = 2
    moe_p = llama.layer_params(p["moe"], layer - 1)
    m = _model_dict()
    with profiling.recording() as rec:
        got = deepseek_v2.moe_layer(moe_p, y, MOE)
        dec = deepseek_v2.moe_layer(moe_p, y[:, :1], MOE, decode=True)
    want = ref._moe(TreeWeights(p), m, y.reshape(-1, CFG.hidden_size), layer,
                    MOE.num_experts, MOE.top_k, MOE.moe_intermediate_size,
                    m["serving"], lambda w, axis: w)
    assert _rel(got.reshape(-1, CFG.hidden_size), want) < 1e-5
    assert _rel(dec[:, 0], want.reshape(2, 13, -1)[:, 0]) < 1e-5
    routes = [s for s in rec.records if s.name == "moe.route"]
    assert routes and all(s.attrs["k"] == 3 and s.attrs["E"] == 8
                          for s in routes)
    names = {s.name for s in rec.records}
    assert {"moe.experts", "moe.shared"} <= names


def test_topk_routing_weights():
    """Greedy top-k of the f32 softmax, times routed_scaling_factor; with
    norm_topk_prob, renormalized."""
    gen = torch.Generator().manual_seed(7)
    xs = torch.randn((5, 16), generator=gen)
    router = torch.randn((16, 8), generator=gen)
    idx, w = M._route_topk(xs, router, 3, 2.5, False)
    probs = torch.softmax(xs @ router, -1)
    top = probs.topk(3, -1)
    assert torch.equal(idx, top.indices)
    assert torch.allclose(w, 2.5 * top.values)
    _, wn = M._route_topk(xs, router, 3, 1.0, True)
    assert torch.allclose(wn.sum(-1), torch.ones(5))


def test_k2_plain_takes_k_experts_a_row():
    """K2's plain version with [B, k] routes equals the sum of k top-1
    calls (f32 sums in another order), and [B] and [B, 1] routes give the
    same bits (the top-1 path unchanged)."""
    gen = torch.Generator().manual_seed(8)
    e, h, m, b = 8, 256, 256, 5
    experts = {}
    for name, (kk, nn) in (("gate_proj", (h, m)), ("up_proj", (h, m)),
                           ("down_proj", (m, h))):
        experts[name] = {
            "kernel": torch.randint(-128, 128, (e, kk // 2, nn),
                                    generator=gen, dtype=torch.int8),
            "scale4h": torch.rand((e, 2, 1, nn), generator=gen) * 0.01}
    x = torch.randn((b, h), generator=gen)
    idx = torch.stack([torch.randperm(e, generator=gen)[:3]
                       for _ in range(b)])
    w = torch.rand((b, 3), generator=gen)
    for a8 in (True, False):
        got = D.moe_ffn_decode_int4h_plain(x, experts, idx, w, e,
                                           int8_x=a8)
        parts = sum(D.moe_ffn_decode_int4h_plain(x, experts, idx[:, j],
                                                 w[:, j], e, int8_x=a8)
                    for j in range(3))
        assert _rel(got, parts) < 1e-5
        one = D.moe_ffn_decode_int4h_plain(x, experts, idx[:, 0], w[:, 0],
                                           e, int8_x=a8)
        assert torch.equal(one, D.moe_ffn_decode_int4h_plain(
            x, experts, idx[:, :1], w[:, :1], e, int8_x=a8))


# ---------------------------------------------------------------------------
# the served tree through generate, against the benchmark's comparison
# ---------------------------------------------------------------------------

def _tiny_cell(tmp_path):
    from portbench import harness
    from portbench.tests import tiny_dsv2 as tiny
    bench = tiny.write(tmp_path)
    return harness.cell_spec(tiny.CELL, bench, tmp_path)


def test_generate_matches_reference_and_controls_do_not(tmp_path,
                                                        monkeypatch):
    """medplib.generate on the served tree (int8 linears, int4h experts
    padded 200 -> 256, bf16, W8A8 / W4A8 prefill; K1's and K2's plain
    versions on the CPU) against reference/serve_dsv2.py teacher-forced
    with the served tokens: within the cell's limits; the program with the
    YaRN mscale^2 left out of its softmax scale reads further off, and K1
    and K2 both ran (top-3 rows at prefill, 3 experts a row at decode)."""
    from portbench.drivers import dsv2_generate
    from medplib_tpu_torch.ops.cuda import gmm as G
    entry, cell, model, mix = _tiny_cell(tmp_path)
    calls = {"k1": 0, "k2": 0}
    k1, k2 = G.gmm_int4h_plain, D.moe_ffn_decode_int4h_plain

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(G, "gmm_int4h_plain", count("k1", k1))
    monkeypatch.setattr(D, "moe_ffn_decode_int4h_plain", count("k2", k2))
    drv = dsv2_generate.Driver(model, mix, dict(cell, check_calls=2),
                               2 ** 31 + 101, "cpu")
    drv.setup()
    assert calls["k1"] == 2 * 3 and calls["k2"] == 2 * mix["new_tokens"]
    prog, ctrl = drv.readings_with_control()
    for name, lim in cell["limits"].items():
        assert prog[name] <= lim, (name, prog)
    assert ctrl["no_mscale"]["mask_rel_median"] > prog["mask_rel_median"]
    assert ctrl["int4_linears"]["mask_rel_median"] > \
        prog["mask_rel_median"]


def test_tiny_cell_traced_window(tmp_path):
    """The driver's traced window of the tiny cell on the CPU: the launch
    counts' keys, the latent cache's bytes a call, and the new per-layer
    metrics' readers (K4's roofline silent: no kernel runs here)."""
    from portbench import harness
    from portbench.drivers import dsv2_generate
    from portbench.tests import tiny_dsv2 as tiny
    _, cell, model, mix = _tiny_cell(tmp_path)
    drv = dsv2_generate.Driver(model, mix, cell, 2 ** 31 + 5, "cpu")
    drv.setup()
    ctx = drv.window(0.3, True)
    la = ctx["launches"]
    m = tiny.tiny_dsv2_model()
    t = 20 - 1 + 16 + 3                  # spliced prompt + new tokens
    assert la["latent_cache_bytes_per_call"] == (
        m["num_hidden_layers"] * 4 * t
        * (m["kv_lora_rank"] + m["qk_rope_head_dim"]) * 2)
    assert la["plain_attention"] == 2 * m["num_hidden_layers"]
    assert la["moe_route_k_E"] == [[m["num_experts_per_tok"],
                                     m["n_routed_experts"]]]

    def read(name):
        return harness._module(harness.HERE / "metrics"
                               / f"{name}.py").read(ctx)
    assert read("attn_ms.serve") is not None
    assert read("moe_ms.serve") is not None
    assert read("k4_roofline.serve") is None
    assert read("attn_ms.serve") == pytest.approx(
        1e3 * ctx["program"]["spans"]["attn"]["device_s"] / 2)


# ---------------------------------------------------------------------------
# paths that do not cover MLA raise
# ---------------------------------------------------------------------------

def test_uncovered_mla_paths_raise():
    cfg = C.MedplibConfig.tiny(llm=CFG, moe=MOE)
    with pytest.raises(ValueError, match="LatentCache"):
        llama.KVCache.init(CFG, 2, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="int8"):
        mla.LatentCache.init(CFG, 2, 8, device="cpu", quant=True)
    cache = mla.LatentCache.init(CFG, 2, 8, torch.float32, "cpu")
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        llama.forward_extend({}, CFG, torch.zeros((2, 4, CFG.hidden_size)),
                             cache, 0)
    with pytest.raises(NotImplementedError, match="expert parallelism"):
        medplib._llm_decode({}, cfg, None, None, ep_shard=True)
    with pytest.raises(NotImplementedError, match="remat"):
        medplib._llm_forward({}, cfg, None, None, remat=True)


@pytest.mark.parametrize("quant", [False, True])
def test_layer_bodies_take_the_config_attention(quant):
    """llama's layer bodies take their attention per config
    (attention_for): MLA for an MlaConfig, LLaMA's q / k / v otherwise,
    each writing the layer's cache view (`cache.layer(i)`) in place. A
    LLaMA prefill into a KVCache (f32, or int8 with scales) then one
    cached decode step gives the last position of a prefill over all the
    tokens: to 1e-5 relative in f32, to the int8 cache's rounding
    otherwise."""
    assert llama.attention_for(CFG) is llama.MLA_ATTENTION
    lcfg = C.LlamaConfig.tiny()
    assert llama.attention_for(lcfg) is llama.LLAMA_ATTENTION
    gen = torch.Generator().manual_seed(7)
    params = llama.init_llama(gen, lcfg, torch.float32, device="cpu")
    b, t = 2, 9
    x = torch.randn((b, t + 1, lcfg.hidden_size), generator=gen)
    want, _, _ = llama.forward(params, lcfg, x)
    cache = llama.KVCache.init(lcfg, b, t + 1, torch.float32, "cpu",
                               quant=quant)
    views = cache.layer(1)
    assert views[0].data_ptr() == cache.k[1].data_ptr()
    assert (views[2] is not None) == quant
    llama.forward(params, lcfg, x[:, :t], cache=cache)
    written = cache.k[:, :, :t].float().abs().amax(-1)  # [L, B, t, KV]
    assert bool((written > 0).all()) and not bool(cache.k[:, :, t:].any())
    got, _ = llama.forward_decode(params, lcfg, x[:, t:], cache)
    rel = float((got[:, 0] - want[:, t]).norm() / want[:, t].norm())
    assert rel < (2e-2 if quant else 1e-5)
    lat = mla.LatentCache.init(CFG, b, 4, torch.float32, "cpu")
    assert lat.layer(2).data_ptr() == lat.latent[2].data_ptr()


def test_chip_smoke_checks_k4_at_the_mla_scale():
    """chip_smoke.py checks K4 <192, 128> at DeepSeek-V2-Lite's softmax
    scale (192^-0.5 x YaRN's mscale^2) and the dsv2lite-ground-b64
    prefill's B = 64 x 687."""
    import chip_smoke as cs
    m = 0.1 * 0.707 * math.log(40) + 1
    assert cs.mla_serve_scale() == pytest.approx(192 ** -0.5 * m * m,
                                                 rel=1e-12)
    assert (64, 687) in cs.MLA_SERVE_SHAPES
    lens = cs._serve_lens(64, 687)
    assert (lens[0], lens[-1], len(lens)) == (623, 687, 64)
