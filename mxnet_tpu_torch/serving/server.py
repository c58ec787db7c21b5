"""ServingServer: in-process serving API + stdlib HTTP JSON endpoint
(the decode half of ``mxnet_tpu/serving/server.py``).

- ``generate()`` in process, and ``POST /generate`` body
  ``{"prompt": [ids...], "max_new_tokens"?: n, "eos"?: id,
  "timeout_ms"?: ms}`` → ``{"tokens": [ids...]}``, served by the
  attached ``DecodeScheduler`` (constructor ``decoder=`` or
  ``attach_decoder()``); 503 until one is attached.
- ``warmup(prefill_lengths)`` materialises the decoder's executables
  ahead of traffic (on a GPU, one CUDA graph per exec key).
- ``GET /healthz`` → drain state, queue depth and slot occupancy.
- ``POST /predict`` → 503: the batch ``InferenceEngine`` is ported with
  a later slice.

Error mapping: admission reject → 400, queue full → 429, request
deadline → 504, draining/closed or nothing attached → 503.  ``stop()``
is drain-aware: admission closes first, every admitted response is
delivered, then the HTTP listener shuts down.
"""
from __future__ import annotations

import json
import threading
from typing import Optional

from ..base import MXNetError
from .engine import (BadRequestError, QueueFullError, RequestTimeoutError,
                     ServingClosedError)

__all__ = ["ServingServer"]


class ServingServer:
    """Serve autoregressive generation through a ``DecodeScheduler``."""

    def __init__(self, decoder=None):
        self.decoder = decoder        # DecodeScheduler (or None)
        self._httpd = None
        self._http_thread = None

    def attach_decoder(self, scheduler) -> "ServingServer":
        """Attach a ``DecodeScheduler`` so ``generate()`` and
        ``POST /generate`` serve requests."""
        self.decoder = scheduler
        return self

    # -- in-process API ------------------------------------------------------

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 eos: Optional[int] = None,
                 timeout_ms: Optional[float] = None):
        """Submit one generation request and block for the generated
        token list.  Raises :class:`ServingClosedError` when no decoder
        is attached."""
        if self.decoder is None:
            raise ServingClosedError(
                "no decode scheduler attached to this server")
        fut = self.decoder.submit(prompt, max_new_tokens=max_new_tokens,
                                  eos=eos, timeout_ms=timeout_ms)
        wait = timeout_ms / 1e3 + 30.0 if timeout_ms is not None else None
        return fut.result(wait)

    def warmup(self, prefill_lengths=(1,)):
        """Materialise the attached decoder's executables ahead of
        traffic (``DecodeEngine.warmup``: on a GPU, one CUDA graph per
        exec key); returns the exec keys."""
        if self.decoder is None:
            raise ServingClosedError(
                "no decode scheduler attached to this server")
        return self.decoder.warmup(prefill_lengths)

    def healthz(self) -> dict:
        d = self.decoder
        if d is None:
            return {"status": "no_decoder", "ready": False}
        st = d.stats()
        return {"status": "draining" if d.closed else "serving",
                "queue_depth": st["queue_depth"],
                "queue_depth_limit": d.queue_depth,
                "slots_active": st["slots_active"],
                "max_slots": st["max_slots"],
                "pages_used": st["pages_used"],
                "ready": not d.closed and st["queue_depth"] < d.queue_depth}

    def stop(self, drain: bool = True):
        """Drain-aware shutdown: close admission (delivering admitted
        responses when ``drain``), then stop the HTTP listener."""
        if self.decoder is not None and not self.decoder.closed:
            self.decoder.close(drain=drain)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            if self._http_thread is not None:
                self._http_thread.join(10.0)
            self._httpd = self._http_thread = None

    # -- HTTP shim -----------------------------------------------------------

    def start_http(self, host: str = "127.0.0.1", port: int = 0):
        """Start the JSON endpoint on a daemon thread; returns
        ``(host, port)`` with the OS-assigned port when ``port=0``."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        server = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):   # quiet by default
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, server.healthz())
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path == "/generate":
                    self._generate()
                elif self.path == "/predict":
                    self._reply(503, {"error": "batch predict is not "
                                               "served by this port yet"})
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def _generate(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    prompt = [int(t) for t in req["prompt"]]
                    max_new = req.get("max_new_tokens")
                    eos = req.get("eos")
                except (KeyError, TypeError, ValueError) as e:
                    self._reply(400, {"error": f"bad request body: {e}"})
                    return
                try:
                    toks = server.generate(
                        prompt, max_new_tokens=max_new, eos=eos,
                        timeout_ms=req.get("timeout_ms"))
                except BadRequestError as e:
                    self._reply(400, {"error": str(e)})
                except QueueFullError as e:
                    self._reply(429, {"error": str(e)})
                except RequestTimeoutError as e:
                    self._reply(504, {"error": str(e)})
                except ServingClosedError as e:
                    self._reply(503, {"error": str(e)})
                except MXNetError as e:
                    self._reply(500, {"error": str(e)})
                else:
                    self._reply(200, {"tokens": [int(t) for t in toks]})

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="mxnet-serving-http",
            daemon=True)
        self._http_thread.start()
        return self._httpd.server_address

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop(drain=True)
        return False
