"""Model worker (medplib_tpu/serve/worker.py): registers with the
controller, heartbeats, serves /worker_generate_stream.

A request is a base64 image, a conversation prompt, sampling parameters,
a stop string and an optional sparse region mask. The worker runs the
dual SAM / CLIP preprocess and the region-mask prep on the host, prefills,
decodes in stream_interval-sized chunks and streams the text between
them; on completion a <SEG> answer is grounded (text_hidden_fcs -> SAM
decode) and its mask goes back as sparse coordinates in the original
image frame in the final chunk. Chunks are NUL-delimited JSON; a
semaphore caps concurrency.

With batched_slots == 0 a request runs alone through
models/medplib.stream_prefill / stream_decode_chunk / stream_ground; with
batched_slots > 0 every request goes through serve/engine.BatchedEngine,
which decodes the in-flight requests as one batch. The worker runs on the
device its params live on. It imports the standard library, numpy and
torch only: no Pillow (serve/png.py reads the wire's PNG), no requests
(urllib.request calls the controller).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np
import torch

from medplib_tpu_torch.config import MedplibConfig
from medplib_tpu_torch.data import preprocess as pp
from medplib_tpu_torch.data import tokenize as tk
from medplib_tpu_torch.data.conversation import conv_templates
from medplib_tpu_torch.data.dataset import (CollatorConfig, collate,
                                            to_model_batch)
from medplib_tpu_torch.eval.seg_metrics import binarize_logits
from medplib_tpu_torch.models import medplib
from medplib_tpu_torch.serve import protocol


class _IncrementalDetok:
    """O(n) streaming detokenization with overlap-anchored commits: only
    tokens past `committed` are re-decoded each chunk; a small uncommitted
    tail is held back because tokenizers can merge text across token
    boundaries (sentencepiece leading-space markers)."""

    HOLDBACK = 8

    def __init__(self, tok):
        self.tok = tok
        self.toks: list = []
        self.committed = 0
        self.committed_text = ""

    def _tail_text(self, upto: int) -> str:
        ws = max(0, self.committed - self.HOLDBACK)
        prev = self.tok.decode(self.toks[ws:self.committed],
                               skip_special_tokens=False)
        cur = self.tok.decode(self.toks[ws:upto], skip_special_tokens=False)
        if not cur.startswith(prev):
            # a tokenizer whose rendering changed across the commit boundary
            # beyond the holdback window breaks the prefix assumption; fall
            # back to a full re-decode (resets the committed anchor)
            self.committed = 0
            self.committed_text = ""
            return self.tok.decode(self.toks[:upto],
                                   skip_special_tokens=False)
        return cur[len(prev):]

    def extend(self, new_toks) -> str:
        """Append tokens, return the full text so far."""
        self.toks.extend(int(t) for t in new_toks)
        if len(self.toks) - self.committed > 2 * self.HOLDBACK:
            commit_to = len(self.toks) - self.HOLDBACK
            tail = self._tail_text(commit_to)
            if self.committed == 0 and not self.committed_text:
                # prefix fallback fired inside _tail_text: `tail` is the
                # full decode from 0
                self.committed_text = tail
            else:
                self.committed_text += tail
            self.committed = commit_to
        return (self.committed_text + self._tail_text(len(self.toks))
                ).replace("</s>", "")

    def final(self) -> str:
        return (self.committed_text + self._tail_text(len(self.toks))
                ).replace("</s>", "").strip()


def _chunk(text: str, mask=(), h: int = 0, w: int = 0,
           code: int = protocol.ERROR_CODE_OK) -> bytes:
    return json.dumps({"text": text, "mask": list(mask), "height": str(h),
                       "width": str(w), "error_code": code}
                      ).encode() + protocol.STREAM_DELIMITER


class ModelWorker:
    def __init__(self, cfg: MedplibConfig, params, tokenizer,
                 model_name: str = "medplib-tpu",
                 controller_url: Optional[str] = None,
                 worker_url: str = "http://localhost:21002",
                 limit_concurrency: int = 2,
                 max_seq_len: int = 512, max_new_tokens: int = 256,
                 stream_interval: int = 2,
                 conv_template: str = "v1",
                 batched_slots: int = 0,
                 kv_quant: bool = False,
                 device_preprocess: Optional[bool] = None,
                 prefill_chunk: Optional[int] = None):
        # device preprocess (ops/device_preprocess.py) is opt-in, as in the
        # JAX package (default off): resize, pad and normalize as two
        # matmuls per image on the params' device
        self.device_preprocess = bool(device_preprocess)
        self.cfg, self.params, self.tok = cfg, params, tokenizer
        self.device = params["llm"]["embed_tokens"]["embedding"].device
        self.kv_quant = kv_quant
        self.model_name = model_name
        self.controller_url = controller_url
        self.worker_url = worker_url
        self.semaphore = threading.Semaphore(limit_concurrency)
        self.queue_length = 0
        self._queue_lock = threading.Lock()
        self.stream_interval = stream_interval
        self.conv = conv_templates[conv_template]
        # prompt-shape buckets: short prompts collate at the smallest bucket
        # >= their length instead of always paying a max_seq_len prefill
        self.buckets = tuple(sorted(
            {b for b in (128, 256) if b < max_seq_len} | {max_seq_len}))
        self._ccs = {
            t: CollatorConfig(
                max_seq_len=t,
                image_tokens=medplib.image_tokens_per_image(cfg),
                sam_image_size=cfg.sam.image_size,
                clip_image_size=cfg.vision.image_size)
            for t in self.buckets}
        self.cc = self._ccs[max_seq_len]
        self.eos = getattr(tokenizer, "eos_token_id", 2) or 2
        self.max_new_tokens = max_new_tokens
        # the KV cache covers a WHOLE number of decode chunks: the loop
        # always runs full stream_interval-sized chunks, so the cache is
        # sized for the rounded-up budget and emitted text is truncated
        chunks = -(-max_new_tokens // stream_interval)
        self._decode_budget = chunks * stream_interval
        self.engine = None
        if batched_slots > 0:
            from medplib_tpu_torch.serve.engine import BatchedEngine
            self.engine = BatchedEngine(
                cfg, params, slots=batched_slots,
                max_new_tokens=max_new_tokens, chunk=stream_interval,
                eos_id=self.eos, max_prompt_len=max_seq_len,
                kv_quant=kv_quant, prefill_chunk=prefill_chunk)
            self.semaphore = threading.Semaphore(batched_slots * 4)
        self._stop = threading.Event()
        if controller_url:
            self.register()
            threading.Thread(target=self._heartbeat_loop,
                             daemon=True).start()

    def close(self):
        """Stop the heartbeat and the batching engine, if any; safe to call
        with requests in flight: they error out instead of hanging."""
        self._stop.set()
        if self.engine is not None:
            self.engine.shutdown()

    # ---- controller RPC ----
    def _post(self, path: str, payload: dict) -> dict:
        req = urllib.request.Request(
            self.controller_url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=5) as r:
            return json.loads(r.read())

    def status(self) -> dict:
        return {"model_names": [self.model_name], "speed": 1.0,
                "queue_length": self.queue_length}

    def register(self):
        self._post("/register_worker", {
            "worker_name": self.worker_url, "check_heart_beat": True,
            "worker_status": self.status()})

    def _heartbeat_loop(self):
        while not self._stop.wait(protocol.HEARTBEAT_WORKER_INTERVAL):
            try:
                res = self._post("/receive_heart_beat", {
                    "worker_name": self.worker_url,
                    "queue_length": self.queue_length})
                if not res.get("exist"):
                    self.register()
            except (OSError, ValueError):
                pass   # controller unreachable: try at the next beat

    # ---- generation ----
    def build_sample(self, prompt: str, image_rgb: np.ndarray,
                     region_mask: Optional[np.ndarray]) -> Dict:
        if self.device_preprocess:
            from medplib_tpu_torch.ops.device_preprocess import \
                dual_preprocess
            sam_t, clip_t, resize_hw = dual_preprocess(
                image_rgb, self.cfg.sam.image_size,
                self.cfg.vision.image_size, self.device)
            image_sam, image_clip = sam_t.cpu().numpy(), clip_t.cpu().numpy()
        else:
            image_sam, resize_hw = pp.preprocess_sam(image_rgb,
                                                     self.cfg.sam.image_size)
            image_clip = pp.preprocess_clip(image_rgb,
                                            self.cfg.vision.image_size)
        ids = tk.tokenizer_image_token(prompt, self.tok)
        sample = {
            "input_ids": np.asarray(ids, np.int64),
            "labels": np.full(len(ids), -100, np.int64),
            "image_clip": image_clip, "image_sam": image_sam,
            "resize_hw": resize_hw, "original_hw": image_rgb.shape[:2],
            "gt_masks": [], "gt_masks_original": [], "question": [prompt],
            "gt": [""], "image_path": None, "answer_type": None,
        }
        if region_mask is not None:
            sample["region_masks"] = [pp.preprocess_region_mask(
                region_mask, self.cfg.vision.image_size,
                self.cfg.vision.patch_size)]
        return sample

    def _queued(self, step: int):
        with self._queue_lock:
            self.queue_length += step

    def generate_stream(self, payload: dict):
        """Yields NUL-delimited JSON chunk bytes."""
        self._queued(1)
        try:
            with self.semaphore:
                yield from self._generate_stream_inner(payload)
        except Exception as e:  # noqa: BLE001 - serving boundary
            yield _chunk(f"server error: {e}",
                         code=protocol.ERROR_CODE_ERROR)
        finally:
            self._queued(-1)

    def _pick_bucket(self, n_tokens: int) -> CollatorConfig:
        """Smallest collator bucket that fits the prompt."""
        for t in self.buckets:
            if n_tokens <= t:
                return self._ccs[t]
        return self.cc

    def _stop_token_id(self, stop_str: Optional[str]) -> Optional[int]:
        """A stop string of one token ends decode at that token."""
        if not stop_str:
            return None
        try:
            ids = self.tok(stop_str).input_ids
        except Exception:  # noqa: BLE001 - tokenizer-specific surface
            return None
        return int(ids[0]) if len(ids) == 1 else None

    def _generate_stream_inner(self, payload: dict):
        prompt = payload["prompt"]
        # per-request sampling params: temperature < 1e-4 is greedy
        temperature = float(payload.get("temperature", 1.0))
        top_p = float(payload.get("top_p", 1.0))
        do_sample = temperature >= 1e-4
        # per-request token budget, clamped to the worker's budget
        mnt = min(int(payload.get("max_new_tokens", self.max_new_tokens)),
                  self.max_new_tokens)
        # stop string: a single-token stop ends decode exactly; any stop
        # truncates the emitted text at rfind(stop)
        stop_str = payload.get("stop") or None
        stop_id = self._stop_token_id(stop_str)
        image = protocol.decode_image_b64(payload["images"][0])
        region = None
        if payload.get("region_masks"):
            region = protocol.decode_sparse_mask(
                payload["region_masks"][0],
                *payload.get("region_hw", image.shape[:2]))
        sample = self.build_sample(prompt, image, region)
        # context-length clamp: keep the prompt TAIL so prompt + answer
        # fits the model's positional budget
        max_src_len = min(self.cc.max_seq_len,
                          self.cfg.llm.max_position_embeddings - mnt - 8)
        if len(sample["input_ids"]) > max_src_len:
            sample["input_ids"] = sample["input_ids"][-max_src_len:]
            sample["labels"] = sample["labels"][-max_src_len:]
        cc = self._pick_bucket(len(sample["input_ids"]))
        arrays, _ = collate([sample], cc)
        batch = to_model_batch(arrays, self.device)
        seed = payload.get("seed")
        detok = _IncrementalDetok(self.tok)
        stopped_text: Optional[str] = None

        def apply_stop(text: str):
            """-> (text, hit): rfind truncation."""
            if stop_str:
                pos = text.rfind(stop_str)
                if pos != -1:
                    return text[:pos], True
            return text, False

        if self.engine is not None:
            # continuous batching: the engine decodes this request with
            # every other in-flight one as a single batch
            req = self.engine.submit(
                batch, region=region is not None,
                temperature=temperature if do_sample else 0.0, top_p=top_p,
                seed=seed, max_new_tokens=mnt)
            for chunk_toks in req:
                if stopped_text is not None:
                    continue  # drain remaining chunks (cancel is async)
                if stop_id is not None and stop_id in chunk_toks:
                    chunk_toks = chunk_toks[:chunk_toks.index(stop_id)]
                    stopped_text, _ = apply_stop(detok.extend(chunk_toks))
                    req.cancel()
                    yield _chunk(stopped_text)
                    continue
                text, hit = apply_stop(detok.extend(chunk_toks))
                if hit:
                    stopped_text = text
                    req.cancel()
                yield _chunk(text)
            grounded = req.ground()
            masks0 = (grounded[0][0, 0].float().cpu().numpy()
                      if grounded is not None else None)
        else:
            rng = int(seed) if seed is not None else \
                time.time_ns() & 0x7FFFFFFF
            sampling = dict(do_sample=True, temperature=temperature,
                            top_p=top_p) if do_sample else {}
            state = medplib.stream_prefill(
                self.params, self.cfg, batch,
                max_new_tokens=self._decode_budget,
                rp_flag=region is not None, rng=rng, kv_quant=self.kv_quant,
                **sampling)
            steps = 0
            while steps < mnt:
                state, chunk_toks, chunk_done = medplib.stream_decode_chunk(
                    self.params, self.cfg, state, chunk=self.stream_interval,
                    eos_id=self.eos, **sampling)
                k = chunk_toks.shape[1]
                # one host fetch: the chunk's tokens, done flags, done row
                host = torch.cat([chunk_toks[0], chunk_done[0].long(),
                                  state.done[:1].long()]).tolist()
                fresh = [t for t, was_done in zip(host[:k], host[k:2 * k])
                         if not was_done and t > 0][: mnt - len(detok.toks)]
                steps += k
                if stop_id is not None and stop_id in fresh:
                    fresh = fresh[:fresh.index(stop_id)]
                    stopped_text, _ = apply_stop(detok.extend(fresh))
                    yield _chunk(stopped_text)
                    break
                text, hit = apply_stop(detok.extend(fresh))
                if hit:
                    stopped_text = text
                    yield _chunk(text)
                    break
                yield _chunk(text)
                if host[2 * k - 1] or host[-1]:
                    break
            masks0 = None
            # skip the SAM forward for non-segmentation requests
            if int(state.seg_count[0]) > 0:
                masks, _ = medplib.stream_ground(self.params, self.cfg,
                                                 batch, state)
                masks0 = masks[0, 0].float().cpu().numpy()

        text = detok.final()
        if stopped_text is not None:
            text = stopped_text.strip()
        else:
            text, _ = apply_stop(text)
        encoded_mask, h, w = [], 0, 0
        if masks0 is not None:
            pred = pp.unpad_and_resize_mask(
                masks0, sample["resize_hw"], sample["original_hw"])
            encoded_mask, h, w = protocol.encode_sparse_mask(
                binarize_logits(pred))
        yield _chunk(text, encoded_mask, h, w)


def make_handler(worker: ModelWorker):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _read_body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_POST(self):
            if self.path == "/worker_generate_stream":
                payload = self._read_body()
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                for chunk in worker.generate_stream(payload):
                    self.wfile.write(chunk)
                    self.wfile.flush()
            elif self.path == "/worker_get_status":
                body = json.dumps(worker.status()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_response(404)
                self.end_headers()

    return Handler


def serve(worker: ModelWorker, host: str = "0.0.0.0",
          port: int = 21002) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), make_handler(worker))
