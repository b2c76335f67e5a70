"""Serving controller (medplib_tpu/serve/controller.py): worker registry,
heartbeat expiry, dispatch.

Workers POST /register_worker with their status and heartbeat every 15 s
(/receive_heart_beat); silent workers expire after 30 s (an expiry
thread); clients resolve a worker through /get_worker_address by LOTTERY
(speed-weighted random) or SHORTEST_QUEUE dispatch. stdlib
ThreadingHTTPServer, the same routes and payloads as the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from enum import Enum
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

from medplib_tpu_torch.serve.protocol import HEARTBEAT_EXPIRATION


class DispatchMethod(Enum):
    LOTTERY = "lottery"
    SHORTEST_QUEUE = "shortest_queue"


@dataclasses.dataclass
class WorkerInfo:
    model_names: List[str]
    speed: float
    queue_length: int
    check_heart_beat: bool
    last_heart_beat: float


class Controller:
    def __init__(self, dispatch_method: str = "shortest_queue"):
        self.workers: Dict[str, WorkerInfo] = {}
        self.dispatch_method = DispatchMethod(dispatch_method)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._expire_thread = threading.Thread(
            target=self._expiration_loop, daemon=True)
        self._expire_thread.start()

    # ---- registry ----
    def register_worker(self, worker_name: str, check_heart_beat: bool,
                        worker_status: Optional[dict]) -> bool:
        if worker_status is None:
            return False
        with self._lock:
            self.workers[worker_name] = WorkerInfo(
                model_names=worker_status["model_names"],
                speed=worker_status.get("speed", 1.0),
                queue_length=worker_status.get("queue_length", 0),
                check_heart_beat=check_heart_beat,
                last_heart_beat=time.time())
        return True

    def receive_heart_beat(self, worker_name: str, queue_length: int) -> bool:
        with self._lock:
            if worker_name not in self.workers:
                return False  # the worker must register again
            w = self.workers[worker_name]
            w.queue_length = queue_length
            w.last_heart_beat = time.time()
            return True

    def _expiration_loop(self):
        while not self._stop.wait(HEARTBEAT_EXPIRATION):
            self.remove_stale_workers_by_expiration()

    def remove_stale_workers_by_expiration(self):
        deadline = time.time() - HEARTBEAT_EXPIRATION
        with self._lock:
            stale = [n for n, w in self.workers.items()
                     if w.check_heart_beat and w.last_heart_beat < deadline]
            for n in stale:
                del self.workers[n]

    def list_models(self) -> List[str]:
        with self._lock:
            names = set()
            for w in self.workers.values():
                names.update(w.model_names)
            return sorted(names)

    # ---- dispatch ----
    def get_worker_address(self, model_name: str) -> str:
        with self._lock:
            candidates = [(n, w) for n, w in self.workers.items()
                          if model_name in w.model_names]
            if not candidates:
                return ""
            if self.dispatch_method == DispatchMethod.LOTTERY:
                speeds = np.asarray([w.speed for _, w in candidates],
                                    np.float32)
                total = float(speeds.sum())
                if total <= 0:
                    return ""
                pt = np.random.uniform(0, total)
                idx = int(np.searchsorted(np.cumsum(speeds), pt))
                return candidates[min(idx, len(candidates) - 1)][0]
            # shortest queue, normalized by speed
            norm_queues = [w.queue_length / max(w.speed, 1e-6)
                           for _, w in candidates]
            idx = int(np.argmin(norm_queues))
            name, w = candidates[idx]
            w.queue_length += 1
            return name

    def shutdown(self):
        self._stop.set()


def make_handler(controller: Controller):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_POST(self):
            data = self._read_body()
            if self.path == "/register_worker":
                ok = controller.register_worker(
                    data["worker_name"], data.get("check_heart_beat", True),
                    data.get("worker_status"))
                self._json(200 if ok else 400, {"ok": ok})
            elif self.path == "/receive_heart_beat":
                exists = controller.receive_heart_beat(
                    data["worker_name"], data.get("queue_length", 0))
                self._json(200, {"exist": exists})
            elif self.path == "/get_worker_address":
                addr = controller.get_worker_address(data["model"])
                self._json(200, {"address": addr})
            elif self.path == "/list_models":
                self._json(200, {"models": controller.list_models()})
            elif self.path == "/refresh_all_workers":
                self._json(200, {"ok": True})
            else:
                self._json(404, {"error": "unknown route"})

    return Handler


def serve(host: str = "0.0.0.0", port: int = 21001,
          dispatch_method: str = "shortest_queue") -> ThreadingHTTPServer:
    controller = Controller(dispatch_method)
    httpd = ThreadingHTTPServer((host, port), make_handler(controller))
    httpd.controller = controller
    return httpd


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=21001)
    ap.add_argument("--dispatch-method", default="shortest_queue",
                    choices=["lottery", "shortest_queue"])
    args = ap.parse_args()
    httpd = serve(args.host, args.port, args.dispatch_method)
    print(f"controller listening on {args.host}:{args.port}")
    httpd.serve_forever()
