"""Continuous-batching serving engine: fixed decode slots over ONE shared
stream state (medplib_tpu/serve/engine.py).

Requests are admitted into free slots of a fixed-size batch as they arrive
and retired on EOS or budget, so every decode step runs all the slots.

- admit: one request at a time, or with group_admission the pending
  requests of one prompt shape together (medplib.stream_prefill over the
  concatenated batches, padded to a power-of-2 bucket by repeating the
  last request; per-row temperature / top_p). The admitted rows are
  copied into their slots of the shared state in place (index_copy_ on
  the batch axis), so the multi-GB KV cache is allocated once and never
  rebuilt. Sampling streams are per row (ops/sampling.row_keys), so a
  seeded request's draws depend on its own seed alone; a seeded sampled
  request also prefills solo, so its first token is seed-exact too.
- prefill_chunk: the prompt is prefilled in extends of that many tokens
  (medplib.stream_prefill_chunk) with a short decode chunk of the other
  slots between consecutive extends, so in-flight streams wait about one
  extend instead of a whole prefill.
- decode: medplib.stream_decode_chunk over all slots, greedy or with
  per-row temperature / top_p (rows below 1e-4 take an exact argmax).
  One host fetch a chunk brings back its tokens, done flags and the
  state's done row together.
- retire: the slot's SEG capture is copied out before the slot is reused;
  Request.ground() runs SAM on the caller's thread, off the decode loop.

The loop runs on its own thread, which enters torch.no_grad() itself.
W8A8 (utils/quantize.dynamic_act_quant) is thread-local and off there,
as it is in the JAX engine's programs, which are traced on its thread.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from medplib_tpu_torch.config import MedplibConfig
from medplib_tpu_torch.models import llama, medplib


class Request:
    """Handle returned by BatchedEngine.submit. Iterate to receive token-id
    chunks; after iteration ends, ground() returns (mask logits,
    seg_valid) for the captured SEG slots (or None when the answer had no
    <SEG>)."""

    def __init__(self, batch: medplib.Batch, region: bool,
                 temperature: float, top_p: float, seed: Optional[int],
                 max_new_tokens: int):
        self.batch = batch
        self.region = region
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.seed = seed
        self.max_new_tokens = max_new_tokens
        self.do_sample = self.temperature >= 1e-4
        self.chunks: "queue.Queue[Optional[List[int]]]" = queue.Queue()
        self.emitted = 0   # delivered tokens
        self.steps = 0     # decode steps consumed (KV-cache budget)
        self.error: Optional[BaseException] = None
        self.cancelled = False
        self._skip = 0     # already-delivered tokens to drop from a chunk
        self._seg = None   # (seg_emb [1, S, D], seg_count [1], last_cap)
        self._engine: Optional["BatchedEngine"] = None

    def cancel(self):
        """Retire this request at the next chunk boundary (safe from any
        thread); the stream still ends with the usual terminator."""
        self.cancelled = True

    def __iter__(self):
        while True:
            item = self.chunks.get()
            if item is None:
                if self.error is not None:
                    raise self.error
                return
            yield item

    def tokens(self) -> List[int]:
        """Drain the stream and return all generated token ids."""
        out: List[int] = []
        for chunk in self:
            out.extend(chunk)
        return out

    def ground(self, out_size: Optional[int] = None):
        """SAM grounding of the finished request -> (mask logits
        [1, S, out, out], seg_valid [1, S]); None if no SEG was
        captured."""
        if self._seg is None:
            raise RuntimeError("ground() before the stream finished")
        seg_emb, seg_count, last_cap = self._seg
        if int(seg_count[0]) == 0:
            return None
        return medplib.ground_seg_slots(
            self._engine.params, self._engine.cfg,
            self.batch.images_sam.to(seg_emb.device), seg_emb, seg_count,
            last_cap, out_size)


def _concat(batches: List[medplib.Batch], device) -> medplib.Batch:
    """Request batches -> one batch on `device` (fields left None stay
    None)."""
    return medplib.Batch(*[
        None if xs[0] is None else torch.cat([x.to(device) for x in xs])
        for xs in zip(*batches)])


def _check_rows(big: torch.Tensor, small: torch.Tensor, axis: int):
    if (big.shape[:axis] + big.shape[axis + 1:]
            != small.shape[:axis] + small.shape[axis + 1:]):
        raise ValueError(f"admitted state {tuple(small.shape)} does not fit "
                         f"the slots' state {tuple(big.shape)}")


def _state_leaves(s: medplib.StreamState):
    """(tensor, batch axis) pairs of a stream state, optional int8-KV
    scales included when present."""
    c = s.cache
    leaves = [(c.k, 1), (c.v, 1), (c.length, 0)]
    if c.quantized:
        leaves += [(c.k_scale, 1), (c.v_scale, 1)]
    return leaves + [(s.tok, 0), (s.done, 0), (s.seg_emb, 0),
                     (s.seg_count, 0), (s.last_cap, 0), (s.rng, 0)]


class BatchedEngine:
    def __init__(self, cfg: MedplibConfig, params, *, slots: int = 4,
                 max_new_tokens: int = 256, chunk: int = 8, eos_id: int = 2,
                 group_admission: bool = False,
                 max_prompt_len: Optional[int] = None,
                 kv_quant: bool = False,
                 prefill_chunk: Optional[int] = None,
                 interleave_steps: Optional[int] = None):
        """group_admission: prefill the pending requests of one prompt
        shape together, padded to a power-of-2 batch.

        max_prompt_len: prompt-shape buckets; requests may arrive collated
        at any width <= max_prompt_len, and their KV caches are padded to
        the shared slot shape at insert. None: the first request's shape
        is the only one the state accepts (until the engine is idle).

        prefill_chunk (tokens): chunked-prefill interleaving, with a decode
        chunk of `interleave_steps` tokens (default chunk // 4) between
        consecutive extends. Token streams equal the unchunked path's
        with a float cache; with kv_quant later chunks attend the
        quantized K/V of earlier ones, so rounding-level divergence is
        possible."""
        self.group_admission = group_admission
        self.cfg, self.params = cfg, params
        self.device = params["llm"]["embed_tokens"]["embedding"].device
        self.slots = slots
        self.chunk = chunk
        self.eos_id = eos_id
        self.max_prompt_len = max_prompt_len
        self.kv_quant = kv_quant
        # the shared cache must cover whole chunks for the longest request
        self.decode_budget = -(-max_new_tokens // chunk) * chunk
        self.max_new_tokens = max_new_tokens
        if prefill_chunk and max_prompt_len and \
                prefill_chunk > self.decode_budget:
            # bucket caches must agree on the shared time size: a bucket's
            # chunk-padded prompt may overrun the slot shape only if one
            # prefill chunk exceeds the decode budget (see _slot_cache_len)
            raise ValueError("prefill_chunk must be <= the decode budget "
                             "when prompt buckets are enabled")
        self.prefill_chunk = prefill_chunk
        self.interleave_steps = min(interleave_steps or max(1, chunk // 4),
                                    chunk)
        # short and full decode chunks mix, and retire is checked after
        # each: every step count is a multiple of gcd(chunk, interleave),
        # so a slot can overrun its budget by chunk - gcd at most
        self._cache_budget = self.decode_budget + (
            chunk - math.gcd(chunk, self.interleave_steps)
            if prefill_chunk else 0)

        self._pending: "queue.Queue[Request]" = queue.Queue()
        self._slot_req: List[Optional[Request]] = [None] * slots
        self._state: Optional[medplib.StreamState] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ---- state ----

    def _insert(self, small: medplib.StreamState, slots: List[int]):
        """Copy the first len(slots) rows of an admitted (possibly padded)
        state into the given slots of the shared state, in place. Every
        shape is checked before the first copy."""
        big, adm = _state_leaves(self._state), _state_leaves(small)
        if len(big) != len(adm):
            raise ValueError("admitted state and slots' state differ in "
                             "their KV cache type")
        for (b, axis), (s, _) in zip(big, adm):
            _check_rows(b, s, axis)
        idx = torch.tensor(slots, dtype=torch.long, device=self.device)
        for (b, axis), (s, _) in zip(big, adm):
            b.index_copy_(axis, idx, s.narrow(axis, 0, len(slots)).to(
                b.dtype))

    @staticmethod
    def _pad_time(small: medplib.StreamState,
                  target: int) -> medplib.StreamState:
        """Zero-pad a bucketed admission's KV cache to the slots' time
        size (prompts are left-aligned and decode masks by
        cache.length)."""
        def pad(a):
            if a is None or a.shape[2] == target:
                return a
            return torch.nn.functional.pad(
                a, (0, 0, 0, 0, 0, target - a.shape[2]))

        c = small.cache
        return small._replace(cache=llama.KVCache(
            k=pad(c.k), v=pad(c.v), length=c.length,
            k_scale=pad(c.k_scale), v_scale=pad(c.v_scale)))

    def _slot_cache_len(self, batch: medplib.Batch) -> Optional[int]:
        """The shared KV time size with prompt buckets: the spliced length
        of a max_prompt_len prompt plus the decode budget."""
        if self.max_prompt_len is None:
            return None
        per = medplib.image_tokens_per_image(self.cfg)
        if self.cfg.projector.mask_encoder:
            per = max(per, self.cfg.projector.mask_encoder_tokens)
        n_img = batch.image_token_lengths.shape[1]
        return (self.max_prompt_len + n_img * (per - 1) +
                self._cache_budget)

    def _make_empty(self, small: medplib.StreamState) -> medplib.StreamState:
        """Zeros of the admitted state's shapes with `slots` rows; free
        slots are done (they never emit)."""
        def z(a, axis):
            if a is None:
                return None
            sh = list(a.shape)
            sh[axis] = self.slots
            return torch.zeros(sh, dtype=a.dtype, device=a.device)

        c = small.cache
        cache = llama.KVCache(k=z(c.k, 1), v=z(c.v, 1),
                              length=z(c.length, 0),
                              k_scale=z(c.k_scale, 1),
                              v_scale=z(c.v_scale, 1))
        return medplib.StreamState(
            cache=cache, tok=z(small.tok, 0),
            done=torch.ones((self.slots,), dtype=torch.bool,
                            device=small.done.device),
            seg_emb=z(small.seg_emb, 0), seg_count=z(small.seg_count, 0),
            last_cap=z(small.last_cap, 0), rng=z(small.rng, 0))

    def _extract(self, slot: int):
        s = self._state
        return tuple(a[slot:slot + 1].clone()
                     for a in (s.seg_emb, s.seg_count, s.last_cap))

    # ---- public API ----

    def submit(self, batch: medplib.Batch, *, region: bool = False,
               temperature: float = 0.0, top_p: float = 1.0,
               seed: Optional[int] = None,
               max_new_tokens: Optional[int] = None) -> Request:
        """batch must be a B=1 collated Batch. With max_prompt_len set, any
        prompt width <= max_prompt_len is accepted (bucketed admission);
        otherwise the engine's one prompt shape."""
        if batch.input_ids.shape[0] != 1:
            raise ValueError("engine requests are single-sample batches")
        if (self.max_prompt_len is not None
                and batch.input_ids.shape[1] > self.max_prompt_len):
            raise ValueError(
                f"prompt width {batch.input_ids.shape[1]} exceeds the "
                f"engine's max_prompt_len {self.max_prompt_len}")
        if self._stop.is_set():
            raise RuntimeError("engine shut down")
        r = Request(batch, region, temperature, top_p, seed,
                    min(max_new_tokens or self.max_new_tokens,
                        self.decode_budget))
        r._engine = self
        self._pending.put(r)
        # a shutdown may have drained _pending between the check above and
        # the put: check again so this request cannot be stranded
        if self._stop.is_set():
            self._fail_pending(RuntimeError("engine shut down"))
        return r

    def _fail_pending(self, err: BaseException):
        while True:
            try:
                r = self._pending.get_nowait()
            except queue.Empty:
                return
            r.error = err
            r.chunks.put(None)

    def shutdown(self):
        """Stop the loop; every slotted or pending request ends with an
        error, so no client blocks forever."""
        self._stop.set()
        self._thread.join(timeout=10)
        self._fail_pending(RuntimeError("engine shut down"))

    @property
    def active_requests(self) -> int:
        return sum(r is not None for r in self._slot_req) + \
            self._pending.qsize()

    # ---- engine loop ----

    def _admit(self, group: List[Request]):
        """Admit a group of same-shape requests with ONE prefill: batches
        concatenated, sampling parameters per row, the group padded to a
        power-of-2 batch by repeating its last request (padding rows are
        never inserted)."""
        k = len(group)
        bucket = 1
        while bucket < k:
            bucket *= 2
        rows = group + [group[-1]] * (bucket - k)
        temps = torch.tensor([[r.temperature] for r in rows])
        tops = torch.tensor([[r.top_p] for r in rows])
        seed = group[0].seed
        seed = int(seed) if seed is not None else time.time_ns() & 0x7FFFFFFF
        ds = any(r.do_sample for r in group)
        region = group[0].region
        batch = _concat([r.batch for r in rows], self.device)
        target = self._slot_cache_len(group[0].batch)
        if self.prefill_chunk:
            pc = self.prefill_chunk
            embeds, am, sm, carry = medplib.stream_prefill_begin(
                self.params, self.cfg, batch,
                max_new_tokens=self._cache_budget, chunk_tokens=pc,
                rp_flag=region, kv_quant=self.kv_quant, cache_len=target)
            n = embeds.shape[1] // pc
            for ci in range(n):
                carry = medplib.stream_prefill_chunk(
                    self.params, self.cfg, carry, embeds, am, sm, ci * pc,
                    pc)
                if ci < n - 1:
                    self._decode_once(short=True)
            small = medplib.stream_prefill_finish(
                self.params, self.cfg, carry, am, do_sample=ds,
                temperature=temps, top_p=tops, rng=seed)
        else:
            small = medplib.stream_prefill(
                self.params, self.cfg, batch,
                max_new_tokens=self._cache_budget, rp_flag=region,
                do_sample=ds, temperature=temps, top_p=tops, rng=seed,
                kv_quant=self.kv_quant)
            if target is not None and small.cache.k.shape[2] < target:
                small = self._pad_time(small, target)
        if self._state is None:
            self._state = self._make_empty(small)
        slots = []
        for r in group:
            slot = self._slot_req.index(None)
            self._slot_req[slot] = r
            slots.append(slot)
        try:
            self._insert(small, slots)
        except BaseException:
            for slot in slots:
                self._slot_req[slot] = None
            raise
        # first-token fast path: the prefill already chose the first token;
        # deliver it now (one host fetch) instead of after the next decode
        # chunk, which re-emits it first (r._skip drops it there)
        first = small.tok[:k].tolist()
        for r, t in zip(group, first):
            if t > 0 and not r.cancelled:     # the chunk's own filter
                r.chunks.put([t])
                r.emitted += 1
                r._skip = 1

    def _try_admit(self, group: List[Request], retried: bool = False):
        """Admit with failure isolation: a failed group falls back to solo
        admissions, so only the request at fault errors; a failure while
        the engine is idle drops the shared state, so the next admission
        rebuilds it from its own shapes (idle healing)."""
        try:
            self._admit(group)
            return
        except BaseException as e:  # noqa: BLE001 - engine boundary
            for i, s in enumerate(self._slot_req):
                if s in group:
                    self._slot_req[i] = None
            idle = all(r is None for r in self._slot_req)
            if idle:
                self._state = None
            if len(group) > 1:
                for r in group:
                    self._try_admit([r])
                return
            if idle and not retried:
                self._try_admit(group, retried=True)
                return
            group[0].error = e
            group[0].chunks.put(None)

    def _retire(self, slot: int):
        r = self._slot_req[slot]
        r._seg = self._extract(slot)
        self._slot_req[slot] = None
        r.chunks.put(None)

    def _loop(self):
        with torch.no_grad():
            while not self._stop.is_set():
                try:
                    self._loop_once()
                except BaseException as e:  # noqa: BLE001 - engine boundary
                    # fail every in-flight request, drop the state, go on
                    for i, r in enumerate(self._slot_req):
                        if r is not None:
                            r.error = e
                            r._seg = None
                            self._slot_req[i] = None
                            r.chunks.put(None)
                    self._state = None
        # stopping: end whatever is still slotted or pending
        err = RuntimeError("engine shut down")
        for i, r in enumerate(self._slot_req):
            if r is not None:
                self._slot_req[i] = None
                r.error = err
                r.chunks.put(None)
        self._fail_pending(err)

    def _loop_once(self):
        # take pending requests up to the free-slot count...
        incoming: List[Request] = []
        while sum(r is None for r in self._slot_req) > len(incoming):
            try:
                block = (not incoming
                         and all(r is None for r in self._slot_req))
                incoming.append(self._pending.get(block=block, timeout=0.2))
            except queue.Empty:
                break
        # ...and admit them in prefill groups of one region flag and one
        # prompt width; a SEEDED sampled request prefills solo
        groups: List[List[Request]] = []
        by_key: dict = {}
        for r in incoming:
            if not self.group_admission or (r.do_sample
                                            and r.seed is not None):
                groups.append([r])
            else:
                key = (r.region, r.batch.input_ids.shape[1])
                by_key.setdefault(key, []).append(r)
        groups.extend(by_key.values())
        for g in groups:
            self._try_admit(g)
        self._decode_once()

    def _decode_once(self, short: bool = False):
        """One decode chunk of all slots, then delivery and retire. Called
        from the loop, and between chunked-prefill extends with short=True
        (interleave_steps tokens)."""
        active = [i for i, r in enumerate(self._slot_req) if r is not None]
        if not active:
            return
        n = self.interleave_steps if short else self.chunk
        kw = {}
        if any(self._slot_req[i].do_sample for i in active):
            temps = np.zeros((self.slots, 1), np.float32)
            tops = np.ones((self.slots, 1), np.float32)
            for i in active:
                temps[i, 0] = self._slot_req[i].temperature
                tops[i, 0] = self._slot_req[i].top_p
            kw = dict(do_sample=True, temperature=torch.from_numpy(temps),
                      top_p=torch.from_numpy(tops))
        self._state, toks, dones = medplib.stream_decode_chunk(
            self.params, self.cfg, self._state, chunk=n, eos_id=self.eos_id,
            **kw)
        # one host fetch for the chunk's tokens, done flags and done row
        host = torch.cat([toks, dones.to(toks.dtype),
                          self._state.done[:, None].to(toks.dtype)],
                         dim=1).cpu().numpy()
        toks, dones, done_now = host[:, :n], host[:, n:2 * n], host[:, -1]
        for slot in active:
            r = self._slot_req[slot]
            passing = [int(t) for t, d in zip(toks[slot], dones[slot])
                       if not d and t > 0]
            # the first chunk after admission re-emits the prefill's token
            # that the fast path already delivered (see _admit)
            drop = min(r._skip, len(passing))
            r._skip -= drop
            fresh = passing[drop:][: r.max_new_tokens - r.emitted]
            # emitted counts delivered tokens; steps bounds the decode work
            # so a stream of filtered ids cannot outrun the KV cache
            r.emitted += len(fresh)
            r.steps += n
            if fresh:
                r.chunks.put(fresh)
            if done_now[slot] or r.emitted >= r.max_new_tokens \
                    or r.steps >= self.decode_budget or r.cancelled:
                self._retire(slot)
