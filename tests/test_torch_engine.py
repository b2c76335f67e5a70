"""The port's continuous-batching engine (medplib_tpu_torch/serve/engine.py)
on the CPU: the cases of tests/test_engine.py on the port.

Greedy requests must reproduce the single-request stream path token for
token (the port's stream_prefill + stream_decode_chunk, itself held to
JAX's in tests/test_torch_extend.py; one case holds the engine directly
to JAX's jitted stream path). Every wait on a request has a deadline and
every engine is shut down in `finally`, so a hung engine thread fails a
test instead of stalling the suite.

Model: MedplibConfig.tiny (dense, H=128, f32), embeddings scaled to unit
size (greedy choices are not near ties); the MoE case adds 2 experts.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import medplib_tpu.config as jc
from medplib_tpu.models import medplib as jm
from medplib_tpu_torch.models import medplib as tm
from medplib_tpu_torch.serve.engine import BatchedEngine
from test_torch_modules import bridge, port_cfg

torch.set_num_threads(1)
T_IN = 24
DEADLINE = 60.0


def _model(moe=False, seed=0):
    cfg = jc.MedplibConfig.tiny()
    if moe:
        cfg = dataclasses.replace(
            cfg, moe=jc.MoeConfig(enable=True, num_experts=2, top_k=1,
                                  capacity_factor=1.5,
                                  eval_capacity_factor=2.0))
    p = jm.init_medplib(jax.random.PRNGKey(seed), cfg)
    emb = p["llm"]["embed_tokens"]["embedding"]
    p["llm"]["embed_tokens"]["embedding"] = emb * 50.0
    return cfg, p, port_cfg(cfg), bridge(p)


@pytest.fixture(scope="module")
def tiny():
    return _model()


def jax_req(cfg, i, t=T_IN, seg=False):
    """A B=1 request: the bench batch with a distinct token at 5 and,
    unless `seg`, no <SEG> in the prompt."""
    b = ge._make_batch(cfg, 1, t, np.random.default_rng(i))
    ids = np.array(b.input_ids)
    ids[0, 5] = 100 + i
    if not seg:
        ids[0, t - 3] = 7
    return b._replace(input_ids=jnp.asarray(ids))


def to_torch(batch):
    return tm.Batch(**{
        k: torch.from_numpy(np.array(getattr(batch, k)))
        for k in ("input_ids", "input_mask", "labels", "images_clip",
                  "images_sam", "image_token_lengths")})


def req(cfg, i, **kw):
    return to_torch(jax_req(cfg, i, **kw))


def chunks(r, timeout=DEADLINE):
    """The request's token chunks, each read with a deadline."""
    out = []
    while True:
        item = r.chunks.get(timeout=timeout)
        if item is None:
            if r.error is not None:
                raise r.error
            return out
        out.append(item)


def tokens(r):
    return [t for c in chunks(r) for t in c]


def reference_tokens(pcfg, tp, batch, budget, chunk, kv_quant=False,
                     eos=2):
    """The single-request stream path -> (tokens, final state)."""
    state = tm.stream_prefill(tp, pcfg, batch, max_new_tokens=budget,
                              kv_quant=kv_quant)
    toks, steps = [], 0
    while steps < budget:
        state, ct, cd = tm.stream_decode_chunk(tp, pcfg, state, chunk=chunk,
                                               eos_id=eos)
        for t, d in zip(ct[0].tolist(), cd[0].tolist()):
            if not d and t > 0 and len(toks) < budget:
                toks.append(t)
        steps += chunk
        if bool(cd[0, -1]) or bool(state.done[0]):
            break
    return toks, state


def jax_reference_tokens(cfg, params, batch, budget, chunk, eos=2):
    """tests/test_engine.py's _reference_tokens on the jitted JAX stream
    functions."""
    prefill = jax.jit(lambda p, b: jm.stream_prefill(
        p, cfg, b, max_new_tokens=budget))
    dec = jax.jit(lambda p, s: jm.stream_decode_chunk(p, cfg, s, chunk=chunk,
                                                      eos_id=eos))
    state = prefill(params, batch)
    toks, steps = [], 0
    while steps < budget:
        state, ct, cd = dec(params, state)
        for t, d in zip(np.asarray(ct)[0], np.asarray(cd)[0]):
            if not d and int(t) > 0 and len(toks) < budget:
                toks.append(int(t))
        steps += chunk
        if bool(np.asarray(cd)[0][-1]) or bool(np.asarray(state.done)[0]):
            break
    return toks


def test_engine_quick_equivalence(tiny):
    """Two greedy requests through a 2-slot engine equal the stream path,
    the port's and JAX's."""
    cfg, jp, pcfg, tp = tiny
    budget, chunk = 4, 2
    jbatches = [jax_req(cfg, i) for i in range(2)]
    want = [reference_tokens(pcfg, tp, to_torch(b), budget, chunk)[0]
            for b in jbatches]
    assert want == [jax_reference_tokens(cfg, jp, b, budget, chunk)
                    for b in jbatches]
    eng = BatchedEngine(pcfg, tp, slots=2, max_new_tokens=budget,
                        chunk=chunk)
    try:
        reqs = [eng.submit(to_torch(b), temperature=0.0) for b in jbatches]
        assert [tokens(r) for r in reqs] == want
        assert all(r.error is None for r in reqs)
    finally:
        eng.shutdown()


@pytest.mark.parametrize("group", [False, True])
def test_engine_matches_single_stream_and_reuses_slots(tiny, group):
    """5 greedy requests through 2 slots (slot reuse), both admission
    modes."""
    cfg, _, pcfg, tp = tiny
    budget, chunk = 8, 4
    batches = [req(cfg, i, seg=i == 1) for i in range(5)]
    want = [reference_tokens(pcfg, tp, b, budget, chunk)[0]
            for b in batches]
    eng = BatchedEngine(pcfg, tp, slots=2, max_new_tokens=budget,
                        chunk=chunk, group_admission=group)
    try:
        reqs = [eng.submit(b, temperature=0.0) for b in batches]
        assert [tokens(r) for r in reqs] == want
        assert all(r.error is None for r in reqs)
        assert eng.active_requests == 0
    finally:
        eng.shutdown()


def test_engine_mixed_greedy_and_sampled(tiny):
    """A greedy request batched with sampled ones keeps its exact argmax
    tokens (grouped prefill with per-row temperatures, decode of the mix);
    a seeded sampled request gives the same tokens alone and under
    traffic."""
    cfg, _, pcfg, tp = tiny
    budget, chunk = 8, 4
    b_greedy, b_sample, b_seeded = req(cfg, 0), req(cfg, 2), req(cfg, 3)
    want, _ = reference_tokens(pcfg, tp, b_greedy, budget, chunk)

    def run(traffic):
        eng = BatchedEngine(pcfg, tp, slots=3, max_new_tokens=budget,
                            chunk=chunk, group_admission=True)
        try:
            rs = rg = None
            if traffic:
                rg = eng.submit(b_greedy, temperature=0.0)
                rs = eng.submit(b_sample, temperature=0.9, top_p=0.9)
            seeded = eng.submit(b_seeded, temperature=0.8, top_p=0.95,
                                seed=1234)
            out = tokens(seeded)
            if traffic:
                assert tokens(rg) == want
                assert all(t > 0 for t in tokens(rs))
            return out
        finally:
            eng.shutdown()

    alone = run(False)
    assert len(alone) > 0
    assert run(True) == alone


def test_engine_grounding_matches_stream_ground(tiny):
    """A prompt with <SEG> grounds per request, equal to stream_ground on
    the single-stream state; a request with no SEG grounds to None."""
    cfg, _, pcfg, tp = tiny
    budget, chunk = 4, 4
    batch = req(cfg, 1, seg=True)
    _, ref_state = reference_tokens(pcfg, tp, batch, budget, chunk)
    ref_masks, ref_valid = tm.stream_ground(tp, pcfg, batch, ref_state)
    eng = BatchedEngine(pcfg, tp, slots=2, max_new_tokens=budget,
                        chunk=chunk)
    try:
        r = eng.submit(batch, temperature=0.0)
        tokens(r)
        masks, valid = r.ground()
        assert torch.equal(valid, ref_valid)
        assert masks.shape == ref_masks.shape == (1, 1, 64, 64)
        torch.testing.assert_close(masks, ref_masks, rtol=2e-2, atol=2e-2)
        r2 = eng.submit(req(cfg, 0), temperature=0.0)
        tokens(r2)
        assert r2.ground() is None
    finally:
        eng.shutdown()


def test_engine_shape_isolation_and_idle_healing(tiny):
    """A request of another prompt width fails alone while traffic is
    live (or is admitted once the engine is idle); an idle engine rebuilds
    its state around the next shape, and switching back heals again."""
    cfg, _, pcfg, tp = tiny
    eng = BatchedEngine(pcfg, tp, slots=2, max_new_tokens=8, chunk=2)
    try:
        good = req(cfg, 0)
        with pytest.raises(ValueError):
            eng.submit(tm.Batch(*[torch.cat([a, a]) for a in good[:6]]))
        want = reference_tokens(pcfg, tp, good, 8, 2)[0]
        other = req(cfg, 0, t=40)
        rg = eng.submit(good, temperature=0.0)
        deadline = time.time() + DEADLINE
        while not any(r is rg for r in eng._slot_req):
            assert time.time() < deadline
            time.sleep(0.01)
        rb = eng.submit(other, temperature=0.0)
        assert tokens(rg) == want
        if rb.error is not None:
            with pytest.raises(ValueError, match="does not fit"):
                tokens(rb)
        else:
            assert isinstance(tokens(rb), list)
        r2 = eng.submit(other, temperature=0.0)
        tokens(r2)
        assert r2.error is None
        assert tokens(eng.submit(good, temperature=0.0)) == want
    finally:
        eng.shutdown()


def test_engine_prompt_buckets_and_cancel(tiny):
    """max_prompt_len: a prompt collated at a narrower width is padded to
    the slot shape at insert and decodes what the full width does; an
    over-wide prompt is refused; cancel() retires a request early."""
    cfg, _, pcfg, tp = tiny
    full, small = 40, 24
    b_small = req(cfg, 0, t=small)
    pad = full - small
    b_full = b_small._replace(
        input_ids=torch.nn.functional.pad(b_small.input_ids, (0, pad)),
        input_mask=torch.nn.functional.pad(b_small.input_mask, (0, pad)),
        labels=torch.nn.functional.pad(b_small.labels, (0, pad),
                                       value=-100))
    eng = BatchedEngine(pcfg, tp, slots=2, max_new_tokens=8, chunk=4,
                        max_prompt_len=full)
    try:
        toks_small = tokens(eng.submit(b_small, temperature=0.0))
        toks_full = tokens(eng.submit(b_full, temperature=0.0))
        assert toks_small == toks_full and len(toks_small) > 0
        with pytest.raises(ValueError, match="max_prompt_len"):
            eng.submit(req(cfg, 1, t=full + 8))
    finally:
        eng.shutdown()
    eng2 = BatchedEngine(pcfg, tp, slots=2, max_new_tokens=64, chunk=4,
                         max_prompt_len=full)
    try:
        r = eng2.submit(b_small, temperature=0.0)
        r.cancel()
        assert len(tokens(r)) <= 32
        assert r.error is None
    finally:
        eng2.shutdown()


def test_engine_kv_quant_matches_quantized_stream(tiny):
    """int8 KV cache in the engine: the requests reproduce the single
    stream on the same quantized cache."""
    cfg, _, pcfg, tp = tiny
    budget, chunk = 8, 4
    batches = [req(cfg, i) for i in range(3)]
    want = [reference_tokens(pcfg, tp, b, budget, chunk, kv_quant=True)[0]
            for b in batches]
    eng = BatchedEngine(pcfg, tp, slots=2, max_new_tokens=budget,
                        chunk=chunk, kv_quant=True)
    try:
        got = [tokens(r) for r in [eng.submit(b, temperature=0.0)
                                   for b in batches]]
        assert got == want
        assert eng._state.cache.quantized
    finally:
        eng.shutdown()


def test_engine_serves_moe_model():
    """The MoE composite (2 experts, the flagship's structure): decode
    through the sort dispatch, equal to the stream path, which equals
    JAX's."""
    cfg, jp, pcfg, tp = _model(moe=True, seed=3)
    budget, chunk = 6, 3
    batches = [jax_req(cfg, i) for i in range(3)]
    want = [reference_tokens(pcfg, tp, to_torch(b), budget, chunk)[0]
            for b in batches]
    assert want[0] == jax_reference_tokens(cfg, jp, batches[0], budget,
                                           chunk)
    eng = BatchedEngine(pcfg, tp, slots=2, max_new_tokens=budget,
                        chunk=chunk)
    try:
        got = [tokens(r) for r in [eng.submit(to_torch(b), temperature=0.0)
                                   for b in batches]]
        assert got == want
    finally:
        eng.shutdown()


def test_engine_first_token_fast_path(tiny):
    """The prefill's token arrives at admission as a 1-token chunk, and
    the whole stream still equals the stream path."""
    cfg, _, pcfg, tp = tiny
    budget, chunk = 8, 4
    b = req(cfg, 0)
    want, _ = reference_tokens(pcfg, tp, b, budget, chunk)
    eng = BatchedEngine(pcfg, tp, slots=2, max_new_tokens=budget,
                        chunk=chunk)
    try:
        got = chunks(eng.submit(b, temperature=0.0))
        assert got and got[0] == want[:1]
        assert [t for c in got for t in c] == want
    finally:
        eng.shutdown()


@pytest.mark.parametrize("pc", [4, 16])
def test_engine_chunked_prefill_interleaving(tiny, pc):
    """prefill_chunk = pc (39 spliced tokens: 10 or 3 extends, with short
    decode chunks between them): token-exact against the stream path with
    slot reuse underneath."""
    cfg, _, pcfg, tp = tiny
    budget, chunk = 8, 4
    batches = [req(cfg, i, seg=i == 1) for i in range(3)]
    want = [reference_tokens(pcfg, tp, b, budget, chunk)[0]
            for b in batches]
    eng = BatchedEngine(pcfg, tp, slots=2, max_new_tokens=budget,
                        chunk=chunk, prefill_chunk=pc)
    try:
        reqs = [eng.submit(b, temperature=0.0) for b in batches]
        assert [tokens(r) for r in reqs] == want
        assert all(r.error is None for r in reqs)
        assert eng.active_requests == 0
    finally:
        eng.shutdown()


@pytest.mark.parametrize("kv_quant", [False, True])
def test_engine_idle_slot_decodes_past_its_cache(tiny, kv_quant):
    """A slot retired at the end of its cache keeps decoding with the
    others (its length walks past the cache's size): the dropped writes
    raise nothing, and the live request still equals the stream path."""
    cfg, _, pcfg, tp = tiny
    budget, chunk = 8, 4
    first, late = req(cfg, 0), req(cfg, 1)
    want = reference_tokens(pcfg, tp, late, budget, chunk,
                            kv_quant=kv_quant, eos=-1)[0]
    eng = BatchedEngine(pcfg, tp, slots=2, max_new_tokens=budget,
                        chunk=chunk, kv_quant=kv_quant, eos_id=-1)
    try:
        r0 = eng.submit(first, temperature=0.0)
        r0.chunks.get(timeout=DEADLINE)     # admitted and decoding
        r1 = eng.submit(late, temperature=0.0)
        tokens(r0)
        assert tokens(r1) == want
        assert r0.error is None and r1.error is None
        size = eng._state.cache.k.shape[2]
        assert int(eng._state.cache.length.max()) > size
    finally:
        eng.shutdown()


def test_engine_shutdown_ends_pending_and_slotted(tiny):
    """shutdown() ends every slotted and pending request with an error,
    and submit() refuses work afterwards."""
    cfg, _, pcfg, tp = tiny
    eng = BatchedEngine(pcfg, tp, slots=1, max_new_tokens=64, chunk=2)
    try:
        rs = [eng.submit(req(cfg, i), temperature=0.0) for i in range(3)]
        rs[0].chunks.get(timeout=DEADLINE)
    finally:
        eng.shutdown()
    for r in rs:
        with pytest.raises(RuntimeError, match="shut down"):
            chunks(r, timeout=DEADLINE)
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit(req(cfg, 0))
