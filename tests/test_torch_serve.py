"""The port's serving front end (medplib_tpu_torch/serve: protocol, png,
controller, worker, web; chat.py) on the CPU: the cases of
tests/test_serve.py and test_cli.py's chat turn, with the port's worker
held to the JAX package's worker on the same tiny tree.

Model: MedplibConfig.tiny (f32), embeddings scaled to unit size (greedy
choices are not near ties), the same tree in both packages
(test_torch_modules.bridge). Every HTTP call has a timeout, every wait on
a thread a deadline, and every server, worker and engine is shut down in
`finally`.
"""

import base64
import io
import json
import os
import socket
import struct
import sys
import threading
import urllib.error
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import medplib_tpu.config as jc
from medplib_tpu.models import medplib as jm
from medplib_tpu.serve import protocol as jproto
from medplib_tpu.serve import worker as jwk
from medplib_tpu_torch.serve import controller as tctl
from medplib_tpu_torch.serve import png
from medplib_tpu_torch.serve import protocol as tproto
from medplib_tpu_torch.serve import web as tweb
from medplib_tpu_torch.serve import worker as twk
from test_cli import fake_tokenizer, tiny_dataset  # noqa: F401
from test_torch_modules import bridge, port_cfg

torch.set_num_threads(1)
TIMEOUT = 120


class Tok:
    """test_serve.FakeTok with <SEG> mapped to the tiny model's SEG id and
    crc32 in place of hash (the same ids in every process)."""

    bos_token_id = 1
    pad_token_id = 0
    eos_token_id = 2
    model_max_length = 512

    def __call__(self, text, add_special_tokens=True):
        ids = ([1] if add_special_tokens else []) + [
            500 if w == "<SEG>" else 3 + zlib.crc32(w.encode()) % 300
            for w in text.split()]

        class R:
            pass
        r = R()
        r.input_ids = ids
        return r

    def decode(self, ids, skip_special_tokens=False):
        return " ".join(f"tok{t}" for t in ids)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _post(url, payload=None, data=None, timeout=TIMEOUT):
    body = data if data is not None else json.dumps(payload or {}).encode()
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _serve_in_thread(httpd):
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return t


# ---------------------------------------------------------------------------
# the tiny model and its two workers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = jc.MedplibConfig.tiny()
    p = jm.init_medplib(jax.random.PRNGKey(0), cfg)
    emb = p["llm"]["embed_tokens"]["embedding"]
    p["llm"]["embed_tokens"]["embedding"] = emb * 50.0
    return cfg, p, port_cfg(cfg), bridge(p)


@pytest.fixture(scope="module")
def workers(tiny):
    """(JAX worker, port worker), both sequential, 8 new tokens, chunks
    of 2, prompts up to 48 tokens."""
    cfg, jp, pcfg, tp = tiny
    kw = dict(max_seq_len=48, max_new_tokens=8)
    return (jwk.ModelWorker(cfg, jp, Tok(), **kw),
            twk.ModelWorker(pcfg, tp, Tok(), **kw))


def _image(seed=0, hw=(64, 80)):
    return np.random.default_rng(seed).integers(
        0, 256, size=hw + (3,)).astype(np.uint8)


def _payload(kind="vqa", **kw):
    img = _image()
    p = {"prompt": "USER: <image>\nWhat is this? ASSISTANT:",
         "images": [tproto.encode_image_b64(img)], "temperature": 0.0}
    if kind == "seg":
        p["prompt"] = "USER: <image>\nSegment the <SEG> lesion ASSISTANT:"
    elif kind == "region":
        m = np.zeros(img.shape[:2], np.uint8)
        m[10:40, 20:60] = 1
        p["prompt"] = ("USER: <image>\nWhat is in <region> </region> ? "
                       "ASSISTANT:")
        p["region_masks"] = [tproto.encode_sparse_mask(m)[0]]
        p["region_hw"] = list(img.shape[:2])
    p.update(kw)
    return p


def _drain(worker, payload):
    return [json.loads(raw.rstrip(b"\0"))
            for raw in worker.generate_stream(payload)]


@pytest.mark.parametrize("kind", ["vqa", "seg", "region"])
def test_worker_greedy_matches_jax(workers, kind):
    """Every streamed chunk equal, the final text and the mask's sparse
    coordinates in the original frame included."""
    jw, tw = workers
    want = _drain(jw, _payload(kind))
    got = _drain(tw, _payload(kind))
    assert want[-1]["error_code"] == 0 and want[-1]["text"]
    assert got == want
    if kind == "seg":
        assert (got[-1]["height"], got[-1]["width"]) == ("64", "80")
    assert tw.queue_length == 0


def test_worker_max_new_tokens_matches_jax(workers):
    jw, tw = workers
    full = _drain(tw, _payload())[-1]["text"]
    short = _drain(tw, _payload(max_new_tokens=2))[-1]["text"]
    assert short == _drain(jw, _payload(max_new_tokens=2))[-1]["text"]
    assert len(short.split()) <= 2 < len(full.split())
    # over-budget requests clamp to the worker budget instead of erroring
    capped = _drain(tw, _payload(max_new_tokens=10_000))[-1]
    assert capped["error_code"] == 0 and capped["text"] == full


def test_worker_stop_string_matches_jax(workers):
    jw, tw = workers
    full = _drain(tw, _payload())[-1]["text"]
    stop = full.split()[1]
    got = _drain(tw, _payload(stop=stop))
    assert got == _drain(jw, _payload(stop=stop))
    assert len(got[-1]["text"].split()) < len(full.split())


def test_worker_single_token_stop(tiny):
    class OneTok(Tok):
        def __call__(self, text, add_special_tokens=True):
            r = super().__call__(text, add_special_tokens)
            if text == "%":
                r.input_ids = [42]
            return r

    _, _, pcfg, tp = tiny
    w = twk.ModelWorker(pcfg, tp, OneTok(), max_seq_len=48)
    assert w._stop_token_id("%") == 42
    assert w._stop_token_id("longer stop") is None
    assert w._stop_token_id(None) is None


def test_worker_single_token_stop_ends_decode(tiny, workers):
    """A stop id among the generated tokens cuts the text before it, in
    the sequential and the batched worker, as in JAX."""
    cfg, jp, pcfg, tp = tiny
    _, tw = workers
    toks = _drain(tw, _payload())[-1]["text"].split()
    stop_tok = int(toks[2][3:])

    class StopTok(Tok):
        def __call__(self, text, add_special_tokens=True):
            r = super().__call__(text, add_special_tokens)
            if text == "STOP":
                r.input_ids = [stop_tok]
            return r

    kw = dict(max_seq_len=48, max_new_tokens=8)
    want = _drain(jwk.ModelWorker(cfg, jp, StopTok(), **kw),
                  _payload(stop="STOP"))[-1]["text"]
    assert want == " ".join(toks[:2])
    assert _drain(twk.ModelWorker(pcfg, tp, StopTok(), **kw),
                  _payload(stop="STOP"))[-1]["text"] == want
    bw = twk.ModelWorker(pcfg, tp, StopTok(), batched_slots=2, **kw)
    try:
        assert _drain(bw, _payload(stop="STOP"))[-1]["text"] == want
    finally:
        bw.close()


def test_worker_context_clamp_matches_jax(tiny):
    """The prompt is clipped to context - max_new - 8 tokens, keeping the
    TAIL; the clipped request still serves, as in JAX."""
    cfg, jp, pcfg, tp = tiny
    kw = dict(max_seq_len=24, max_new_tokens=4)
    long_prompt = ("USER: <image>\n" +
                   " ".join(f"word{i}" for i in range(80)) + " ASSISTANT:")
    want = _drain(jwk.ModelWorker(cfg, jp, Tok(), **kw),
                  _payload(prompt=long_prompt))
    got = _drain(twk.ModelWorker(pcfg, tp, Tok(), **kw),
                 _payload(prompt=long_prompt))
    assert got[-1]["error_code"] == 0
    assert got == want


def test_worker_prompt_buckets_pick_smallest(tiny):
    _, _, pcfg, tp = tiny
    w = twk.ModelWorker(pcfg, tp, Tok(), max_seq_len=512)
    assert w.buckets == (128, 256, 512)
    assert [w._pick_bucket(n).max_seq_len for n in (40, 128, 200, 400)] == \
        [128, 128, 256, 512]
    assert twk.ModelWorker(pcfg, tp, Tok(), max_seq_len=48).buckets == (48,)


def test_incremental_detok_prefix_fallback():
    """A tokenizer whose rendering changes across the commit boundary
    falls back to a full re-decode, as in JAX."""

    class WeirdTok(Tok):
        def decode(self, ids, skip_special_tokens=False):
            joined = " ".join(f"t{t}" for t in ids)
            return ("LONG " + joined) if len(ids) > 20 else joined

    got, want = twk._IncrementalDetok(WeirdTok()), \
        jwk._IncrementalDetok(WeirdTok())
    outs = [(got.extend([i]), want.extend([i])) for i in range(30)]
    assert all(a == b for a, b in outs)
    assert outs[-1][0] == WeirdTok().decode(list(range(30)))
    assert got.final() == want.final()


def test_worker_error_chunk_matches_jax(workers):
    jw, tw = workers
    bad = {"prompt": "x", "images": ["bm90IGFuIGltYWdl"]}
    got, want = _drain(tw, bad), _drain(jw, bad)
    assert len(got) == len(want) == 1
    assert got[0]["error_code"] == want[0]["error_code"] == \
        tproto.ERROR_CODE_ERROR
    assert got[0]["text"].startswith("server error:")
    assert tw.queue_length == 0


def test_device_preprocess_is_not_ported(tiny):
    """(Named for the raise it replaced: ops/device_preprocess.py is ported
    now.) device_preprocess=True: the sample's image fields within 2 grey
    levels of the host path's, and the stream equal to the JAX worker's
    with device_preprocess=True, chunk for chunk."""
    from medplib_tpu_torch.data import preprocess as tpp
    cfg, jp, pcfg, tp = tiny
    kw = dict(max_seq_len=48, max_new_tokens=8)
    tw = twk.ModelWorker(pcfg, tp, Tok(), device_preprocess=True, **kw)
    host = twk.ModelWorker(pcfg, tp, Tok(), **kw)
    img = _image(3, (70, 90))
    got = tw.build_sample("<image>\nhi", img, None)
    want = host.build_sample("<image>\nhi", img, None)
    assert tuple(got["resize_hw"]) == tuple(want["resize_hw"])
    for k, std in (("image_sam", tpp.SAM_PIXEL_STD),
                   ("image_clip", tpp.CLIP_STD * 255)):
        assert got[k].shape == want[k].shape
        assert (np.abs(got[k] - want[k]) * std).max() <= 2.0
    jw = jwk.ModelWorker(cfg, jp, Tok(), device_preprocess=True, **kw)
    for kind in ("vqa", "seg"):
        assert _drain(tw, _payload(kind)) == _drain(jw, _payload(kind))


def test_sampled_request_reproduces_and_seed_moves_it(tiny):
    """A seeded sampled request repeats exactly, another seed moves it;
    the batched worker (engine streams per row) gives the sequential
    worker's text for the same seed."""
    _, _, pcfg, tp = tiny
    kw = dict(max_seq_len=48, max_new_tokens=8)
    seq = twk.ModelWorker(pcfg, tp, Tok(), **kw)
    samp = _payload(temperature=5.0, top_p=0.95)
    texts = {s: _drain(seq, dict(samp, seed=s))[-1]["text"]
             for s in (11, 12, 13)}
    assert _drain(seq, dict(samp, seed=11))[-1]["text"] == texts[11]
    assert len(set(texts.values())) > 1
    bw = twk.ModelWorker(pcfg, tp, Tok(), batched_slots=2, **kw)
    try:
        assert _drain(bw, dict(samp, seed=11))[-1]["text"] == texts[11]
    finally:
        bw.close()


def test_batched_worker_over_http_matches_sequential(tiny, workers):
    """batched_slots routes requests through BatchedEngine: concurrent
    greedy requests over HTTP return what the sequential worker returns
    for the same payloads, masks included."""
    _, _, pcfg, tp = tiny
    _, seq = workers
    payloads = [_payload(kind, prompt=f"USER: <image>\nquestion {i} "
                         f"{'<SEG>' if kind == 'seg' else ''} ASSISTANT:")
                for i, kind in enumerate(["vqa", "seg", "vqa"])]
    want = [_drain(seq, p)[-1] for p in payloads]
    bw = twk.ModelWorker(pcfg, tp, Tok(), max_seq_len=48, max_new_tokens=8,
                         batched_slots=2)
    port = _free_port()
    httpd = twk.serve(bw, "127.0.0.1", port)
    _serve_in_thread(httpd)
    url = f"http://127.0.0.1:{port}"
    try:
        with ThreadPoolExecutor(3) as ex:
            got = list(ex.map(lambda p: list(tproto.stream_chunks(_post(
                url + "/worker_generate_stream", p)))[-1], payloads))
        assert got == want
        assert want[1]["mask"] is not None and want[1]["height"] == "64"
        status = json.loads(_post(url + "/worker_get_status"))
        assert status == {"model_names": ["medplib-tpu"], "speed": 1.0,
                          "queue_length": 0}
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + "/nope")
        assert e.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        bw.close()


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------

@pytest.fixture()
def controller_server():
    port = _free_port()
    httpd = tctl.serve("127.0.0.1", port)
    _serve_in_thread(httpd)
    try:
        yield f"http://127.0.0.1:{port}", httpd
    finally:
        httpd.controller.shutdown()
        httpd.shutdown()
        httpd.server_close()


def test_register_dispatch_and_expiry(controller_server):
    url, httpd = controller_server
    for name, q in (("http://w1", 5), ("http://w2", 1)):
        assert json.loads(_post(url + "/register_worker", {
            "worker_name": name, "check_heart_beat": True,
            "worker_status": {"model_names": ["m"], "speed": 1.0,
                              "queue_length": q}}))["ok"]
    assert json.loads(_post(url + "/list_models"))["models"] == ["m"]
    # shortest queue picks w2
    assert json.loads(_post(url + "/get_worker_address",
                            {"model": "m"}))["address"] == "http://w2"
    # heartbeat for unknown worker -> exist False
    assert json.loads(_post(url + "/receive_heart_beat",
                            {"worker_name": "http://nope"}))["exist"] is False
    # force expiry
    httpd.controller.workers["http://w1"].last_heart_beat = 0
    httpd.controller.remove_stale_workers_by_expiration()
    assert "http://w1" not in httpd.controller.workers
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + "/register_worker", {"worker_name": "x"})
    assert e.value.code == 400


def test_lottery_dispatch():
    c = tctl.Controller("lottery")
    try:
        c.register_worker("a", False, {"model_names": ["m"], "speed": 1.0,
                                       "queue_length": 0})
        c.register_worker("b", False, {"model_names": ["m"], "speed": 0.0,
                                       "queue_length": 0})
        np.random.seed(0)
        assert {c.get_worker_address("m") for _ in range(20)} == {"a"}
        assert c.get_worker_address("other") == ""
    finally:
        c.shutdown()


def test_worker_registers_and_heartbeats(tiny, controller_server,
                                         monkeypatch):
    """A worker given a controller registers itself; a heartbeat the
    controller does not know makes it register again."""
    url, httpd = controller_server
    _, _, pcfg, tp = tiny
    monkeypatch.setattr(tproto, "HEARTBEAT_WORKER_INTERVAL", 0.05)
    w = twk.ModelWorker(pcfg, tp, Tok(), controller_url=url,
                        worker_url="http://127.0.0.1:1")
    try:
        assert list(httpd.controller.workers) == ["http://127.0.0.1:1"]
        del httpd.controller.workers["http://127.0.0.1:1"]
        ev = threading.Event()
        for _ in range(100):
            if "http://127.0.0.1:1" in httpd.controller.workers:
                ev.set()
                break
            ev.wait(0.05)
        assert ev.is_set()
    finally:
        w.close()


# ---------------------------------------------------------------------------
# web
# ---------------------------------------------------------------------------

def test_web_post_routing_is_robust():
    """Unknown POST paths 404 without touching the body; malformed JSON on
    a known path 400s instead of a handler traceback."""
    srv = tweb.serve("http://127.0.0.1:9", "dummy-model", "127.0.0.1", 0,
                     log_dir=None)
    _serve_in_thread(srv)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        for path, data, code in (("/nope", b"not json", 404),
                                 ("/vote", b"not json", 400),
                                 ("/vote", b'{"type": "bogus"}', 400)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base + path, data=data, timeout=10)
            assert e.value.code == code
    finally:
        srv.shutdown()
        srv.server_close()


def test_web_serves_page_proxies_and_logs(tmp_path):
    """GET / returns the sketch page; POST /generate proxies through the
    controller to a (fake) worker; chat rounds and votes are logged as
    in JAX."""
    import http.server

    class FakeWorker(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            body = json.dumps({"text": "a lesion", "mask": []}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    wsrv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), FakeWorker)
    ctrl = tctl.Controller()
    csrv = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                           tctl.make_handler(ctrl))
    log_dir = str(tmp_path / "conv_logs")
    ui = tweb.serve(f"http://127.0.0.1:{csrv.server_address[1]}",
                    host="127.0.0.1", port=0, log_dir=log_dir)
    for s in (wsrv, csrv, ui):
        _serve_in_thread(s)
    try:
        ctrl.register_worker(f"http://127.0.0.1:{wsrv.server_address[1]}",
                             False, {"model_names": ["medplib-tpu"],
                                     "speed": 1, "queue_length": 0})
        uurl = f"http://127.0.0.1:{ui.server_address[1]}"
        with urllib.request.urlopen(uurl + "/", timeout=10) as r:
            page = r.read().decode()
        assert page == tweb.PAGE
        from medplib_tpu.serve import web as jweb
        assert tweb.PAGE == jweb.PAGE
        assert b"lesion" in _post(uurl + "/generate", {
            "prompt": "hi", "model": "medplib-tpu"}, timeout=10)
        assert json.loads(_post(uurl + "/vote", {
            "type": "upvote",
            "state": {"prompt": "hi", "text": "a lesion"}}))["ok"]
        rows = [json.loads(line)
                for line in open(tweb.conv_log_filename(log_dir))]
        assert [r["type"] for r in rows] == ["chat", "upvote"]
        assert rows[0]["state"] == {"prompt": "hi", "text": "a lesion",
                                    "has_mask": False}
        assert rows[1]["state"]["prompt"] == "hi"
        assert all(r["model"] == "medplib-tpu" and "tstamp" in r
                   for r in rows)
    finally:
        for s in (ui, csrv, wsrv):
            s.shutdown()
            s.server_close()
        ctrl.shutdown()


# ---------------------------------------------------------------------------
# protocol and the PNG codec
# ---------------------------------------------------------------------------

def test_protocol_constants_and_sparse_mask():
    for k in ("HEARTBEAT_WORKER_INTERVAL", "HEARTBEAT_EXPIRATION",
              "STREAM_DELIMITER", "ERROR_CODE_OK", "ERROR_CODE_OVERLOAD",
              "ERROR_CODE_ERROR"):
        assert getattr(tproto, k) == getattr(jproto, k), k
    m = (np.random.default_rng(2).uniform(size=(13, 17)) > 0.7).astype(
        np.uint8)
    assert tproto.encode_sparse_mask(m) == jproto.encode_sparse_mask(m)
    coords, h, w = tproto.encode_sparse_mask(m)
    np.testing.assert_array_equal(tproto.decode_sparse_mask(coords, h, w),
                                  jproto.decode_sparse_mask(coords, h, w))
    raw = b'{"a": 1}\0{"b": [2]}\0'
    assert list(tproto.stream_chunks(raw)) == list(jproto.stream_chunks(raw))


def _pil_png(im, **kw):
    buf = io.BytesIO()
    im.save(buf, "PNG", **kw)
    return buf.getvalue()


MODES = {"L": (37, 53), "RGB": (37, 53, 3), "RGBA": (37, 53, 4)}


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "P"])
@pytest.mark.parametrize("smooth", [False, True])
def test_png_matches_pillow_both_ways(mode, smooth):
    """Pillow's PNG of an L / RGB / RGBA / P image decodes to Pillow's
    convert("RGB"); the port's PNG of an L / RGB / RGBA array decodes in
    Pillow to that array; the wire functions agree with JAX's. Smooth
    images make Pillow choose Paeth rows, noise None / Sub / Up."""
    rng = np.random.default_rng(len(mode))
    shape = MODES.get(mode, (37, 53))
    if smooth:
        yy, xx = np.mgrid[:shape[0], :shape[1]]
        a = ((yy * 5 + xx * 3) % 256).astype(np.uint8)
        if len(shape) == 3:
            a = np.repeat(a[..., None], shape[2], 2) + \
                np.arange(shape[2], dtype=np.uint8) * 40
    else:
        a = rng.integers(0, 256, size=shape).astype(np.uint8)
    im = Image.fromarray(a)
    if mode == "P":
        im = im.convert("P")
        im.putpalette(rng.integers(0, 256, size=768).astype(np.uint8)
                      .tolist())
    raw = _pil_png(im)
    want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(png.decode_rgb(raw), want)
    b64 = base64.b64encode(raw).decode()
    np.testing.assert_array_equal(tproto.decode_image_b64(b64),
                                  jproto.decode_image_b64(b64))
    if mode != "P":
        back = Image.open(io.BytesIO(png.encode(a)))
        assert back.mode == mode
        np.testing.assert_array_equal(np.asarray(back), a)
        np.testing.assert_array_equal(
            jproto.decode_image_b64(tproto.encode_image_b64(a)),
            jproto.decode_image_b64(jproto.encode_image_b64(a)))


def _png_with_filters(a, ctype, filters):
    """An 8-bit PNG of `a` whose row r uses filters[r % len(filters)]
    (None, Sub, Up, Average, Paeth), written by a loop over bytes."""
    h, w = a.shape[:2]
    bpp = 1 if a.ndim == 2 else a.shape[2]
    rows = a.reshape(h, -1).astype(np.int64)
    out = bytearray()
    for r in range(h):
        f = filters[r % len(filters)]
        out.append(f)
        for i in range(rows.shape[1]):
            x = rows[r, i]
            left = rows[r, i - bpp] if i >= bpp else 0
            up = rows[r - 1, i] if r else 0
            ul = rows[r - 1, i - bpp] if r and i >= bpp else 0
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            paeth = left if pa <= pb and pa <= pc else (up if pb <= pc
                                                        else ul)
            pred = [0, left, up, (left + up) // 2, paeth][f]
            out.append((x - pred) % 256)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body +
                struct.pack(">I", zlib.crc32(kind + body)))
    return (png.SIGNATURE +
            chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4), (4, 3, 2, 1)])
def test_png_row_filters(filters):
    a = np.random.default_rng(sum(filters)).integers(
        0, 256, size=(11, 13, 3)).astype(np.uint8)
    raw = _png_with_filters(a, 2, filters)
    np.testing.assert_array_equal(png.decode_rgb(raw), a)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(raw)).convert("RGB")), a)


@pytest.mark.parametrize("colors", [2, 4, 16])
def test_png_low_bit_depths(colors):
    """Pillow writes small palettes at 1 / 2 / 4 bits; 1-bit gray too."""
    rng = np.random.default_rng(colors)
    im = Image.fromarray(rng.integers(0, colors, size=(19, 23)).astype(
        np.uint8)).convert("P")
    im.putpalette(rng.integers(0, 256, size=3 * colors).astype(np.uint8)
                  .tolist())
    raw = _pil_png(im)
    assert struct.unpack(">IIBBBBB", raw[16:29])[2] < 8
    np.testing.assert_array_equal(png.decode_rgb(raw),
                                  np.asarray(im.convert("RGB")))
    im1 = Image.fromarray(rng.integers(0, 2, size=(9, 21)).astype(bool))
    raw = _pil_png(im1)
    np.testing.assert_array_equal(png.decode_rgb(raw),
                                  np.asarray(im1.convert("RGB")))


def test_non_png_needs_pillow(monkeypatch):
    """A JPEG goes to Pillow (equal to JAX's decode); without Pillow the
    worker's decode raises, naming it."""
    buf = io.BytesIO()
    Image.fromarray(_image(3)).save(buf, "JPEG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    np.testing.assert_array_equal(tproto.decode_image_b64(b64),
                                  jproto.decode_image_b64(b64))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="Pillow"):
        tproto.decode_image_b64(b64)
    # PNG needs no Pillow
    a = _image(4, (5, 7))
    np.testing.assert_array_equal(
        tproto.decode_image_b64(tproto.encode_image_b64(a)), a)


# ---------------------------------------------------------------------------
# chat CLI
# ---------------------------------------------------------------------------

def test_chat_cli_one_turn_matches_jax(fake_tokenizer, tiny_dataset,  # noqa: F811
                                       tmp_path, monkeypatch, capsys):
    """One REPL turn of the port's chat.main on the JAX chat's tree (JAX
    params from PRNGKey(0), saved with the port's save_params): the same
    ASSISTANT text and the same mask JPEG bytes."""
    from medplib_tpu import chat as jchat
    from medplib_tpu.config import MoeConfig, tiny_cli_config
    from medplib_tpu_torch import chat as tchat
    from medplib_tpu_torch.utils.checkpoint import save_params
    from medplib_tpu_torch.utils.convert import tree_from_numpy
    from test_torch_modules import snap

    _, folder = tiny_dataset
    img = os.path.join(folder, "im0.jpg")
    seg = fake_tokenizer.convert_tokens_to_ids("<SEG>")
    cfg = tiny_cli_config(MoeConfig(enable=False, num_experts=2, top_k=1,
                                    capacity_factor=1.5,
                                    eval_capacity_factor=2.0,
                                    moe_mode="dense"),
                          seg, len(fake_tokenizer))
    ckpt = str(tmp_path / "params.pt")
    save_params(ckpt, tree_from_numpy(snap(jm.init_medplib(
        jax.random.PRNGKey(0), cfg)), device="cpu"))

    def turn(main, vis, checkpoint, extra=()):
        answers = iter(["Segment the <SEG> lesion please", img])

        def fake_input(_prompt=""):
            try:
                return next(answers)
            except StopIteration:
                raise EOFError

        monkeypatch.setattr("builtins.input", fake_input)
        capsys.readouterr()
        main(["--checkpoint", checkpoint, "--tokenizer", "fake", "--tiny",
              "--max-new-tokens", "4", "--precision", "fp32",
              "--vis-save-path", vis, *extra])
        out = capsys.readouterr().out
        return [line for line in out.splitlines()
                if line.startswith("ASSISTANT:")], sorted(os.listdir(vis))

    jvis, tvis = str(tmp_path / "jvis"), str(tmp_path / "tvis")
    want = turn(jchat.main, jvis, "random")
    got = turn(tchat.main, tvis, ckpt, ("--device", "cpu"))
    assert got == want
    assert len(want[0]) == 1 and want[1] == ["im0_0_mask.jpg",
                                             "im0_0_masked.jpg"]
    for name in want[1]:
        with open(os.path.join(jvis, name), "rb") as a, \
                open(os.path.join(tvis, name), "rb") as b:
            assert a.read() == b.read(), name
