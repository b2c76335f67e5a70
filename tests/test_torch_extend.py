"""The streaming and chunked-prefill serving path of medplib_tpu_torch
against the jitted JAX functions, on the CPU, with the same params (the
JAX init bridged leaf for leaf) and the same inputs (numpy seeds).

- decode past the cache: a row whose length has reached the cache's size
  writes nothing (JAX's scatter drops the update), bf16 and int8 KV;
- extend_attention(_quant), llama.forward_extend over three chunks with a
  ragged tail, moe_llama.forward_extend with int4h experts on the grouped
  matmul (B·C >= 1024, the plain K1) and on the sort path;
- stream_prefill / stream_decode_chunk, begin -> chunks -> finish (and
  equal to the port's own monolithic prefill), ground_seg_slots and
  stream_ground.

Tolerances: greedy tokens, seg_count and lengths equal; hidden states,
cache prefixes and seg_emb within 2e-5 relative (Frobenius) with an f32
cache, within atol 3e-2 with int8 KV (a rare one-step int8 rounding
flip; JAX's own bound for its chunked int8 prefill); masks within rel
2e-2 (tests/test_torch_slice.py). A bf16 cache rounds q and the
probabilities to bf16, and the grouped-matmul extend rounds x to bf16
(K1's float mode): 1e-3 there (one flipped rounding, see the tests).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import medplib_tpu.config as jc
from medplib_tpu.models import llama as jllama
from medplib_tpu.models import medplib as jm
from medplib_tpu.models import moe_llama as jmoe
from medplib_tpu.ops import attention as jatt
from medplib_tpu_torch.models import llama as tllama
from medplib_tpu_torch.models import medplib as tm
from medplib_tpu_torch.models import moe_llama as tmoe
from medplib_tpu_torch.ops import attention as tatt
from medplib_tpu_torch.ops.cuda import gmm as G
from test_torch_modules import bridge, port_cfg, snap

torch.set_num_threads(1)
RNG = np.random.default_rng(0)


def _t(a):
    return torch.from_numpy(np.array(a))


def rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def llm_cfg():
    return jc.LlamaConfig(vocab_size=128, hidden_size=64,
                          intermediate_size=96, num_layers=2, num_heads=4,
                          num_kv_heads=2, head_dim=16)


def _random_cache(cfg, b, max_len, quant, dtype=np.float32):
    """A cache filled with random K/V (and scales) -> (JAX, port)."""
    shape = (cfg.num_layers, b, max_len, cfg.num_kv_heads, cfg.head_dim)
    if quant:
        k, v = (RNG.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2))
        ks, vs = ((RNG.uniform(0.01, 0.05, shape[:-1] + (1,))
                   .astype(np.float32)) for _ in range(2))
        j = jllama.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                           length=jnp.zeros((b,), jnp.int32),
                           k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        t = tllama.KVCache(k=_t(k), v=_t(v),
                           length=torch.zeros((b,), dtype=torch.int32),
                           k_scale=_t(ks), v_scale=_t(vs))
        return j, t
    k, v = (RNG.normal(size=shape).astype(np.float32) for _ in range(2))
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    j = jllama.KVCache(k=jnp.asarray(k).astype(jd),
                       v=jnp.asarray(v).astype(jd),
                       length=jnp.zeros((b,), jnp.int32))
    t = tllama.KVCache(k=_t(k).to(td), v=_t(v).to(td),
                       length=torch.zeros((b,), dtype=torch.int32))
    return j, t


def _leaves(c):
    return [x for x in (c.k, c.v, c.k_scale, c.v_scale) if x is not None]


def _f32(x):
    """A JAX or torch cache leaf as float32 numpy (exact for int8 and
    bf16)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("kv,tol", [("f32", 2e-5), ("bf16", 1e-2),
                                    ("int8", 2e-5)])
def test_decode_drops_writes_past_the_cache(kv, tol):
    """Row 0 sits at length == MAX, row 1 below it. JAX's scatter drops
    row 0's write: its cache stays as it was on both sides, row 1's write
    lands, and the hidden states agree (row 0 attends all MAX
    positions). The bf16 cache is a bf16 model's, as the serving caches
    are (their dtype is the embeddings'): its products and sums round to
    bf16 in another order than the compiled JAX program's, about one bf16
    step (2^-8 = 3.9e-3) an element over two layers (measured 4.1e-3),
    hence 1e-2 (Frobenius) for the hidden and the written K/V; the
    dropped row is exact in every case."""
    cfg = llm_cfg()
    p = jllama.init_llama(jax.random.PRNGKey(5), cfg)
    dt = jnp.bfloat16 if kv == "bf16" else jnp.float32
    p = jax.tree_util.tree_map(lambda a: a.astype(dt), p)
    tp, tcfg = bridge(p), port_cfg(cfg)
    MAX = 6
    quant = kv == "int8"
    jc_, tc_ = _random_cache(cfg, 2, MAX, quant, kv)
    length = np.array([MAX, 3], np.int32)
    jc_ = jc_._replace(length=jnp.asarray(length))
    tc_.length = _t(length)
    before = [_f32(x) for x in _leaves(jc_)]
    x = jnp.asarray(RNG.normal(size=(2, 1, 64)), dt)
    hj, cj = jax.jit(lambda pp, e, c: jllama.forward_decode(pp, cfg, e, c))(
        p, x, jc_)
    ht, ct = tllama.forward_decode(tp, tcfg, bridge(x), tc_)
    assert rel(ht, hj) < tol
    np.testing.assert_array_equal(ct.length.numpy(), np.asarray(cj.length))
    for b0, lj, lt in zip(before, _leaves(cj), _leaves(ct)):
        lj, lt = _f32(lj), _f32(lt)
        np.testing.assert_array_equal(lj[:, 0], b0[:, 0])    # dropped
        np.testing.assert_array_equal(lt[:, 0], b0[:, 0])
        np.testing.assert_array_equal(lt[:, 1, :3], b0[:, 1, :3])
        np.testing.assert_array_equal(lt[:, 1, 4:], b0[:, 1, 4:])
        if quant:       # int8 values (a rare one-step flip) and scales
            np.testing.assert_allclose(lt[:, 1, 3], lj[:, 1, 3], rtol=2e-5,
                                       atol=1.0)
        else:
            assert rel(lt[:, 1, 3], lj[:, 1, 3]) < tol
        assert not np.array_equal(lt[:, 1, 3], b0[:, 1, 3])


@pytest.mark.parametrize("quant", [False, True])
def test_extend_attention_matches_reference(quant):
    """C = 5 queries at positions [3, 8) against a 12-position cache, GQA
    (4 query heads on 2 KV heads)."""
    b, c, h, kv, d, s, c0 = 2, 5, 4, 2, 16, 12, 3
    q = RNG.normal(size=(b, c, h, d)).astype(np.float32)
    if quant:
        kq, vq = (RNG.integers(-127, 128, (b, s, kv, d)).astype(np.int8)
                  for _ in range(2))
        ks, vs = (RNG.uniform(0.01, 0.05, (b, s, kv, 1)).astype(np.float32)
                  for _ in range(2))
        want = jax.jit(jatt.extend_attention_quant)(
            *map(jnp.asarray, (q, kq, ks, vq, vs)), jnp.int32(c0))
        got = tatt.extend_attention_quant(*map(_t, (q, kq, ks, vq, vs)), c0)
    else:
        k, v = (RNG.normal(size=(b, s, kv, d)).astype(np.float32)
                for _ in range(2))
        want = jax.jit(jatt.extend_attention)(
            *map(jnp.asarray, (q, k, v)), jnp.int32(c0))
        got = tatt.extend_attention(*map(_t, (q, k, v)), c0)
    assert got.shape == want.shape
    assert rel(got, want) < 2e-5


def _extend_chunks(cfg, jparams, tparams, jfn, tfn, b, t, c, max_len,
                   quant, dtype, tol):
    """Extend a random prompt of t tokens chunk by chunk (the last chunk
    padded) on both sides; each chunk's hidden and the final cache
    prefix must agree."""
    n = -(-t // c)
    x = np.zeros((b, n * c, cfg.hidden_size), np.float32)
    x[:, :t] = RNG.normal(size=(b, t, cfg.hidden_size))
    jc_, tc_ = _random_cache(cfg, b, max_len, quant, dtype)
    jext = jax.jit(jfn)
    for ci in range(n):
        sl = slice(ci * c, (ci + 1) * c)
        hj, jc_ = jext(jparams, jnp.asarray(x[:, sl]), jc_,
                       jnp.int32(ci * c))
        ht, tc_ = tfn(tparams, _t(x[:, sl]), tc_, ci * c)
        assert rel(ht, hj) < tol, ci
    np.testing.assert_array_equal(tc_.length.numpy(), np.asarray(jc_.length))
    for lj, lt in zip(_leaves(jc_), _leaves(tc_)):
        lj = np.asarray(lj.astype(jnp.float32))[:, :, :n * c]
        lt = lt.float().numpy()[:, :, :n * c]
        if quant:
            np.testing.assert_allclose(lt, lj, rtol=0, atol=1.0)
        else:
            assert rel(lt, lj) < tol
    if quant:
        deq = lambda cc: (cc.k.float() * cc.k_scale).numpy()  # noqa: E731
        jd = np.asarray(jc_.k, np.float32) * np.asarray(jc_.k_scale)
        np.testing.assert_allclose(deq(tc_), jd, atol=3e-2)
    return tc_


@pytest.mark.parametrize("kv,tol", [("f32", 2e-5), ("bf16", 1e-3),
                                    ("int8", 2e-5)])
def test_llama_forward_extend_three_chunks(kv, tol):
    """Dense LLaMA, 13 prompt tokens in chunks of 5 (three extends, the
    last with 2 padding queries) into a 20-position cache; length is not
    advanced. A bf16 cache rounds q and the softmax probabilities to bf16
    on both sides: an f32 last-bit difference can flip one such rounding
    (one bf16 step, 2^-8, in one element moves the chunk's hidden by ~2e-4
    in norm), so that case is held to 1e-3."""
    cfg = llm_cfg()
    p = jllama.init_llama(jax.random.PRNGKey(6), cfg)
    tc_ = _extend_chunks(
        cfg, p, bridge(p),
        lambda pp, e, ca, c0: jllama.forward_extend(pp, cfg, e, ca, c0),
        lambda pp, e, ca, c0: tllama.forward_extend(pp, port_cfg(cfg), e,
                                                    ca, c0),
        b=2, t=13, c=5, max_len=20, quant=kv == "int8", dtype=kv, tol=tol)
    assert int(tc_.length.max()) == 0


def test_extend_past_the_cache_raises():
    cfg = llm_cfg()
    tp = bridge(jllama.init_llama(jax.random.PRNGKey(6), cfg))
    cache = tllama.KVCache.init(port_cfg(cfg), 1, 8, torch.float32,
                                device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        tllama.forward_extend(tp, port_cfg(cfg), torch.zeros((1, 4, 64)),
                              cache, 6)


def _int4h_moe_llm():
    """The MoE LLM of tests/test_torch_slice.py (H=512, M=1024, 2 layers
    x 2 experts, int4h(G=2) experts, int8 attention), f32 activations."""
    from medplib_tpu.utils import quantize as jq
    cfg = jc.MedplibConfig.tiny(
        llm=jc.LlamaConfig(vocab_size=512, hidden_size=512,
                           intermediate_size=1024, num_layers=2, num_heads=8,
                           num_kv_heads=8, head_dim=64),
        projector=jc.ProjectorConfig(mm_hidden_size=64, hidden_size=512),
        moe=jc.MoeConfig(enable=True, num_experts=2, top_k=1,
                         capacity_factor=1.5, eval_capacity_factor=2.0))
    p = jm.init_medplib(jax.random.PRNGKey(0), cfg)
    p = jq.quantize_flagship_moe(p, expert_bits=4, attn_bits=8)
    llm = p["llm"]
    host = snap(llm)
    return cfg, llm, bridge(host)


@pytest.fixture(scope="module")
def moe_llm():
    return _int4h_moe_llm()


@pytest.mark.parametrize("b,c,k1", [(4, 256, True), (2, 96, False)])
def test_moe_forward_extend_int4h(moe_llm, monkeypatch, b, c, k1):
    """B·C = 1024 rows take the grouped matmul (plain K1, 3 calls per
    layer); 192 rows take the capacity-sort path (no K1). Two chunks,
    f32 cache. K1's float mode rounds x to bf16 on both sides: f32
    last-bit differences flip a few of the 0.5 M roundings a layer (one
    bf16 step, 2^-8, each), ~3e-4 over two layers, so the K1 case is
    held to 1e-3; the sort path to 2e-5."""
    cfg, jp, tp = moe_llm
    calls = []
    plain = G.gmm_int4h_plain
    monkeypatch.setattr(G, "gmm_int4h_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    tcfg = port_cfg(cfg)
    _extend_chunks(
        cfg.llm, jp, tp,
        lambda pp, e, ca, c0: jmoe.forward_extend(pp, cfg.llm, cfg.moe, e,
                                                  ca, c0),
        lambda pp, e, ca, c0: tmoe.forward_extend(pp, tcfg.llm, tcfg.moe, e,
                                                  ca, c0),
        b=b, t=2 * c - 3, c=c, max_len=2 * c + 4, quant=False,
        dtype=np.float32, tol=1e-3 if k1 else 2e-5)
    assert len(calls) == (2 * 3 * cfg.llm.num_layers if k1 else 0)


# ---------------------------------------------------------------------------
# the composite stream path
# ---------------------------------------------------------------------------

def _tiny_medplib():
    """MedplibConfig.tiny (dense, H=128), f32, embeddings scaled to unit
    size so that greedy choices are not near ties."""
    cfg = jc.MedplibConfig.tiny()
    p = jm.init_medplib(jax.random.PRNGKey(0), cfg)
    emb = p["llm"]["embed_tokens"]["embedding"]
    p["llm"]["embed_tokens"]["embedding"] = emb * 50.0
    return cfg, p, bridge(p)


@pytest.fixture(scope="module")
def tiny():
    return _tiny_medplib()


def jax_batch(cfg, b, t, seed, seg=True):
    batch = ge._make_batch(cfg, b, t, np.random.default_rng(seed))
    if not seg:
        ids = np.array(batch.input_ids)
        ids[:, t - 3] = 7
        batch = batch._replace(input_ids=jnp.asarray(ids))
    return batch


def torch_batch(batch):
    return tm.Batch(**{
        k: torch.from_numpy(np.array(getattr(batch, k)))
        for k in ("input_ids", "input_mask", "labels", "images_clip",
                  "images_sam", "image_token_lengths")})


def _check_state(got, want, quant, length):
    np.testing.assert_array_equal(got.tok.numpy(), np.asarray(want.tok))
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))
    np.testing.assert_array_equal(got.seg_count.numpy(),
                                  np.asarray(want.seg_count))
    np.testing.assert_array_equal(got.cache.length.numpy(),
                                  np.asarray(want.cache.length))
    if quant:
        assert np.abs(got.seg_emb.numpy() - np.asarray(want.seg_emb)).max() \
            < 3e-2
        deq = (got.cache.k.float() * got.cache.k_scale)[:, :, :length]
        jd = (np.asarray(want.cache.k, np.float32)
              * np.asarray(want.cache.k_scale))[:, :, :length]
        np.testing.assert_allclose(deq.numpy(), jd, atol=3e-2)
    else:
        assert rel(got.seg_emb, want.seg_emb) < 2e-5
        assert rel(got.last_cap, want.last_cap) < 2e-5
        for a, b in ((got.cache.k, want.cache.k), (got.cache.v,
                                                   want.cache.v)):
            assert rel(a[:, :, :length], np.asarray(b)[:, :, :length]) < 2e-5


@pytest.mark.parametrize("quant", [False, True])
def test_stream_prefill_and_decode_chunk(tiny, quant):
    """B=2 with <SEG> in the prompt: the prefill state, then two decode
    chunks of 3 (tokens, done flags, SEG slots, cache)."""
    cfg, jp, tp = tiny
    batch = jax_batch(cfg, 2, 24, 1)
    new = 6
    jst = jax.jit(lambda p, bb: jm.stream_prefill(
        p, cfg, bb, max_new_tokens=new, kv_quant=quant))(jp, batch)
    tst = tm.stream_prefill(tp, port_cfg(cfg), torch_batch(batch),
                            max_new_tokens=new, kv_quant=quant)
    length = int(np.asarray(jst.cache.length).max())
    _check_state(tst, jst, quant, length)
    assert int(tst.seg_count.min()) >= 1          # the prompt's SEG
    jdec = jax.jit(lambda p, s: jm.stream_decode_chunk(p, cfg, s, chunk=3))
    for _ in range(2):
        jst, jt, jd = jdec(jp, jst)
        tst, tt, td = tm.stream_decode_chunk(tp, port_cfg(cfg), tst, 3)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    _check_state(tst, jst, quant, length + 6)


def _chunked(params, cfg, batch, new, c, quant, mod, jit):
    """begin -> n x chunk -> finish through module `mod` (jitted for
    JAX)."""
    wrap = jax.jit if jit else (lambda f, **_: f)
    begin = wrap(lambda p, bb: mod.stream_prefill_begin(
        p, cfg, bb, max_new_tokens=new, chunk_tokens=c, kv_quant=quant))
    ext = wrap(lambda p, ca, e, a, s, c0: mod.stream_prefill_chunk(
        p, cfg, ca, e, a, s, c0, chunk_tokens=c))
    fin = wrap(lambda p, ca, a: mod.stream_prefill_finish(p, cfg, ca, a))
    embeds, am, sm, carry = begin(params, batch)
    n = embeds.shape[1] // c
    assert embeds.shape[1] % c == 0 and n >= 3
    for ci in range(n):
        c0 = jnp.int32(ci * c) if jit else ci * c
        carry = ext(params, carry, embeds, am, sm, c0)
    return fin(params, carry, am)


@pytest.mark.parametrize("quant", [False, True])
def test_chunked_prefill_matches_reference(tiny, quant):
    """begin -> chunks of 7 (the 39 spliced tokens padded to 42: six
    extends) -> finish against JAX's, with a second <SEG> in an earlier
    chunk (two prompt SEG slots, appended in sequence order); then a
    decode chunk."""
    cfg, jp, tp = tiny
    batch = jax_batch(cfg, 2, 24, 2)
    ids = np.array(batch.input_ids)
    ids[0, 8] = cfg.seg_token_idx
    batch = batch._replace(input_ids=jnp.asarray(ids))
    new, c = 5, 7
    pcfg = port_cfg(cfg)
    jst = _chunked(jp, cfg, batch, new, c, quant, jm, True)
    tst = _chunked(tp, pcfg, torch_batch(batch), new, c, quant, tm, False)
    length = int(np.asarray(jst.cache.length).max())
    _check_state(tst, jst, quant, length)
    jst2, jt, _ = jax.jit(lambda p, s: jm.stream_decode_chunk(
        p, cfg, s, chunk=new))(jp, jst)
    tst2, tt, _ = tm.stream_decode_chunk(tp, pcfg, tst, new)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    _check_state(tst2, jst2, quant, length + new)


def test_two_seg_slots_fill_in_order(tiny):
    """max_segs = 2: a row with two prompt SEGs in different chunks fills
    both slots in sequence order, as the monolithic prefill does."""
    cfg, _, tp = tiny
    pcfg = port_cfg(cfg)
    batch = jax_batch(cfg, 2, 24, 2)
    ids = np.array(batch.input_ids)
    ids[0, 8] = cfg.seg_token_idx
    tb = torch_batch(batch._replace(input_ids=jnp.asarray(ids)))
    mono = tm.stream_prefill(tp, pcfg, tb, 4, max_segs=2)
    embeds, am, sm, carry = tm.stream_prefill_begin(
        tp, pcfg, tb, 4, chunk_tokens=7, max_segs=2)
    for ci in range(embeds.shape[1] // 7):
        carry = tm.stream_prefill_chunk(tp, pcfg, carry, embeds, am, sm,
                                        ci * 7, 7)
    st = tm.stream_prefill_finish(tp, pcfg, carry, am)
    assert st.seg_count.tolist() == mono.seg_count.tolist() == [2, 1]
    assert rel(st.seg_emb, mono.seg_emb.numpy()) < 2e-5


@pytest.mark.parametrize("quant", [False, True])
def test_chunked_prefill_matches_monolithic(tiny, quant):
    """The port's chunked path (chunks of 5, ragged tail) equals its own
    monolithic stream_prefill: first token, SEG slots, cache prefix, and
    8 decoded tokens."""
    cfg, _, tp = tiny
    pcfg = port_cfg(cfg)
    tb = torch_batch(jax_batch(cfg, 2, 24, 3))
    new = 8
    mono = tm.stream_prefill(tp, pcfg, tb, new, kv_quant=quant)
    st = _chunked(tp, pcfg, tb, new, 5, quant, tm, False)
    length = int(mono.cache.length.max())
    np.testing.assert_array_equal(st.tok.numpy(), mono.tok.numpy())
    np.testing.assert_array_equal(st.seg_count.numpy(),
                                  mono.seg_count.numpy())
    np.testing.assert_array_equal(st.cache.length.numpy(),
                                  mono.cache.length.numpy())
    if quant:
        assert float((st.seg_emb - mono.seg_emb).abs().max()) < 3e-2
    else:
        assert rel(st.seg_emb, mono.seg_emb.numpy()) < 2e-5
        assert rel(st.cache.k[:, :, :length],
                   mono.cache.k[:, :, :length].numpy()) < 2e-5
    _, t_chunked, _ = tm.stream_decode_chunk(tp, pcfg, st, new)
    _, t_mono, _ = tm.stream_decode_chunk(tp, pcfg, mono, new)
    assert torch.equal(t_chunked, t_mono)


def test_ground_seg_slots_and_stream_ground(tiny):
    """Grounding of a finished stream: one row with a prompt SEG, one
    without (its slot 0 takes the last projected hidden); masks within
    rel 2e-2, seg_valid equal; seg_emb is not modified."""
    cfg, jp, tp = tiny
    pcfg = port_cfg(cfg)
    b1, b0 = jax_batch(cfg, 1, 24, 4), jax_batch(cfg, 1, 24, 5, seg=False)
    batch = jax.tree_util.tree_map(lambda a, b: jnp.concatenate([a, b]),
                                   b1, b0)
    jst = jax.jit(lambda p, bb: jm.stream_prefill(
        p, cfg, bb, max_new_tokens=3))(jp, batch)
    jst, _, _ = jax.jit(lambda p, s: jm.stream_decode_chunk(
        p, cfg, s, chunk=3))(jp, jst)
    tb = torch_batch(batch)
    tst = tm.stream_prefill(tp, pcfg, tb, 3)
    tst, _, _ = tm.stream_decode_chunk(tp, pcfg, tst, 3)
    np.testing.assert_array_equal(tst.seg_count.numpy(),
                                  np.asarray(jst.seg_count))
    jmask, jvalid = jax.jit(lambda p, bb, s: jm.stream_ground(
        p, cfg, bb, s))(jp, batch, jst)
    seg_before = tst.seg_emb.clone()
    tmask, tvalid = tm.stream_ground(tp, pcfg, tb, tst)
    assert torch.equal(tst.seg_emb, seg_before)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert tmask.shape == jmask.shape
    assert rel(tmask, jmask) < 2e-2
    got, valid = tm.ground_seg_slots(tp, pcfg, tb.images_sam, tst.seg_emb,
                                     tst.seg_count, tst.last_cap, 32)
    want, _ = jax.jit(lambda p, i, se, sc, lc: jm.ground_seg_slots(
        p, cfg, i, se, sc, lc, 32))(jp, batch.images_sam, jst.seg_emb,
                                    jst.seg_count, jst.last_cap)
    assert got.shape == (2, 1, 32, 32)
    assert rel(got, want) < 2e-2
    np.testing.assert_array_equal(valid.numpy(), [[True], [False]])


def test_generate_equals_the_stream_path(tiny):
    """generate (now on the shared decode step) = stream_prefill +
    stream_decode_chunk + stream_ground, token for token and mask for
    mask."""
    cfg, _, tp = tiny
    pcfg = port_cfg(cfg)
    tb = torch_batch(jax_batch(cfg, 2, 24, 6))
    r = tm.generate(tp, pcfg, tb, max_new_tokens=5)
    st = tm.stream_prefill(tp, pcfg, tb, 5)
    st, toks, dones = tm.stream_decode_chunk(tp, pcfg, st, 5)
    masks, valid = tm.stream_ground(tp, pcfg, tb, st)
    assert torch.equal(r.output_ids, toks)
    assert torch.equal(r.num_generated, (~dones).sum(1))
    assert torch.equal(r.seg_valid, valid)
    assert torch.equal(r.pred_masks, masks)


def test_sampled_stream_matches_generate(tiny):
    """Sampled decode through the stream path draws from the same per-row
    streams as generate (same seed -> same tokens)."""
    cfg, _, tp = tiny
    pcfg = port_cfg(cfg)
    tb = torch_batch(jax_batch(cfg, 2, 24, 7))
    kw = dict(do_sample=True, temperature=0.9, top_p=0.9)
    r = tm.generate(tp, pcfg, tb, max_new_tokens=6, rng=11, ground=False,
                    **kw)
    st = tm.stream_prefill(tp, pcfg, tb, 6, rng=11, **kw)
    toks = []
    for _ in range(2):
        st, t, _ = tm.stream_decode_chunk(tp, pcfg, st, 3, **kw)
        toks.append(t)
    assert torch.equal(r.output_ids, torch.cat(toks, 1))

