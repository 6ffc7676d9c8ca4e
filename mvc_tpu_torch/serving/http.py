"""Stdlib HTTP front end for :class:`CaptionService` or :class:`CaptionRouter`
(``mvc_tpu/serving/http.py``).

Endpoints (JSON in/out):

- ``POST /caption`` — body ``{"visual": [[...], ...], "audio": [[...], ...]?,
  "model": "name"?, "priority": 0?, "deadline_ms": N?}``; replies
  ``{"caption": "...", "latency_ms": N}``.  ``model`` picks a router's route
  (absent: its default; unknown: 404); a single service refuses it (400).
  Shed requests answer 503, expired deadlines 504.
- ``POST /caption_batch`` — body ``{"items": [<same as /caption>, ...]}``;
  every item is submitted before any result is awaited, so a client batch
  rides one (or few) device batches.  Replies ``{"captions": [...]}``.
- ``GET /stats`` — the service counters/percentiles.
- ``GET /healthz`` — 200 ``{"ok": true}`` once the service is up.
"""

from __future__ import annotations

import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from mvc_tpu_torch.serving.router import CaptionRouter
from mvc_tpu_torch.serving.service import DeadlineExceeded, ServiceOverloaded


def _parse_item(item: dict) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    if not isinstance(item, dict) or "visual" not in item:
        raise ValueError("body must be a JSON object with a 'visual' field")
    visual = np.asarray(item["visual"], dtype=np.float32)
    audio = item.get("audio")
    if audio is not None:
        audio = np.asarray(audio, dtype=np.float32)
    return visual, audio


def _submit_kwargs(body: dict, routed: bool) -> dict:
    kw = {}
    if routed:
        kw["model"] = body.get("model")
    elif body.get("model") not in (None, ""):
        raise ValueError("this server hosts a single model; no 'model' routing")
    if body.get("priority") is not None:
        kw["priority"] = int(body["priority"])
    if body.get("deadline_ms") is not None:
        kw["deadline_ms"] = float(body["deadline_ms"])
    return kw


def make_http_server(service, host: str = "127.0.0.1", port: int = 8000) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server; ``.serve_forever()`` to run.
    ``service`` is a CaptionService or a CaptionRouter (request bodies pick
    the model with ``"model"``).  Port 0 binds an ephemeral port
    (``server.server_address[1]`` has it)."""
    routed = isinstance(service, CaptionRouter)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # per-request stderr lines are noise at qps
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_json(self) -> dict:
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"{}")

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._reply(200, {"ok": True})
            elif self.path == "/stats":
                self._reply(200, service.stats())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            try:
                body = self._read_json()
            except ValueError as e:        # json.JSONDecodeError is a ValueError
                return self._reply(400, {"error": f"bad JSON: {e}"})
            try:
                if self.path == "/caption":
                    t0 = time.perf_counter()
                    visual, audio = _parse_item(body)
                    caption = service.submit(visual, audio,
                                             **_submit_kwargs(body, routed)).result()
                    self._reply(200, {"caption": caption,
                                      "latency_ms": 1e3 * (time.perf_counter() - t0)})
                elif self.path == "/caption_batch":
                    items = body.get("items")
                    if not isinstance(items, list) or not items:
                        raise ValueError("'items' must be a non-empty list")
                    parsed = [_parse_item(it) for it in items]
                    kw = _submit_kwargs(body, routed)
                    futures = [service.submit(v, a, **kw) for v, a in parsed]
                    self._reply(200, {"captions": [f.result() for f in futures]})
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except ServiceOverloaded as e:
                self._reply(503, {"error": str(e)})
            except KeyError as e:           # a router's unknown model
                self._reply(404, {"error": str(e)})
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except DeadlineExceeded as e:
                self._reply(504, {"error": str(e)})
            except Exception as e:  # model/device failure -> 500, keep serving
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)
