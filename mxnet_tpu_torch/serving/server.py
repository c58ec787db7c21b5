"""ServingServer: in-process serving API + stdlib HTTP JSON endpoint
(counterpart of ``mxnet_tpu/serving/server.py``).

The in-process surface is primary: ``predict()`` submits to the batcher
and blocks on the future, so the tests (and co-located Python callers)
drive the whole queue → batcher → bucketed-engine path without
sockets.  The HTTP endpoint is a thin stdlib ``http.server`` shim over
the same calls:

- ``POST /predict``  body ``{"data": <nested list>, "dtype"?: str,
  "timeout_ms"?: number}`` → ``{"output": <nested list>}`` (or
  ``{"outputs": [...]}`` for multi-output blocks).
- ``POST /generate`` body ``{"prompt": [ids...], "max_new_tokens"?: n,
  "eos"?: id, "timeout_ms"?: ms}`` → ``{"tokens": [ids...]}``: the
  autoregressive decode plane (``serving/decode/``); 503 until a
  ``DecodeScheduler`` is attached (constructor ``decoder=`` or
  ``attach_decoder()``).
- ``GET /healthz`` → queue depth, captured buckets, drain state.
- ``GET /varz`` → the live telemetry registry (``telemetry.snapshot()``).
- ``GET /tracez?limit=`` → the flight recorder's recent completed spans
  and the open ones (empty lists while tracing is off).
- ``GET /metrics`` → the registry in Prometheus text exposition format
  (``clustermon.prometheus_text``: ``# TYPE`` lines, a ``rank`` label
  on every sample), the same numbers as ``/varz``.
- ``GET /incidents`` → the incident history (``clustermon.
  incident_view``): open and recent closed straggler and serving
  incidents with per-cause counts.
- ``GET /slo`` → the serving SLO view (``slo.slo_view()``): declared
  objectives, window percentiles, burn rates, saturation attribution
  and the burning incident, if any.
- ``GET /requestz?limit=`` → the ring of the N slowest requests served.

Error mapping: admission reject → 400, queue full (load shed) → 429,
request deadline → 504, draining/closed → 503, another error of the
framework → 500.  ``stop()`` is drain-aware: the batcher's admission
closes and its admitted responses are delivered, then the decoder's,
then the HTTP listener shuts down.
"""
from __future__ import annotations

import json
import threading
from typing import Any, Optional

import numpy as onp

from .. import telemetry, tracing
from ..base import MXNetError
from .batcher import DynamicBatcher
from .engine import (BadRequestError, InferenceEngine, QueueFullError,
                     RequestTimeoutError, ServingClosedError)

__all__ = ["ServingServer"]


class ServingServer:
    """Serve a Block (or a prebuilt :class:`InferenceEngine`) behind a
    :class:`DynamicBatcher`.  ``engine_args`` / ``batcher_args`` pass
    through to the respective constructors."""

    def __init__(self, block_or_engine, engine_args: Optional[dict] = None,
                 batcher_args: Optional[dict] = None,
                 decoder=None, start: bool = True):
        if isinstance(block_or_engine, InferenceEngine):
            self.engine = block_or_engine
        else:
            self.engine = InferenceEngine(block_or_engine,
                                          **(engine_args or {}))
        self.batcher = DynamicBatcher(self.engine, start=start,
                                      **(batcher_args or {}))
        self.decoder = decoder        # DecodeScheduler (or None)
        self._httpd = None
        self._http_thread = None

    def attach_decoder(self, scheduler) -> "ServingServer":
        """Attach a ``DecodeScheduler`` so ``generate()`` and
        ``POST /generate`` serve autoregressive requests alongside
        ``predict()``."""
        self.decoder = scheduler
        return self

    # -- in-process API ------------------------------------------------------

    def predict(self, x, timeout_ms: Optional[float] = None):
        """Submit one example and block for its result (host numpy).
        ``timeout_ms`` bounds queue wait AND response wait."""
        fut = self.batcher.submit(x, timeout_ms=timeout_ms)
        # the dispatch itself runs after the deadline check, so give the
        # future a grace window beyond the request deadline
        wait = timeout_ms / 1e3 + 30.0 if timeout_ms is not None else None
        return fut.result(wait)

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 eos: Optional[int] = None,
                 timeout_ms: Optional[float] = None):
        """Submit one generation request to the attached
        ``DecodeScheduler`` and block for the generated token list.
        Raises :class:`ServingClosedError` when no decoder is
        attached."""
        if self.decoder is None:
            raise ServingClosedError(
                "no decode scheduler attached to this server")
        fut = self.decoder.submit(prompt, max_new_tokens=max_new_tokens,
                                  eos=eos, timeout_ms=timeout_ms)
        wait = timeout_ms / 1e3 + 30.0 if timeout_ms is not None else None
        return fut.result(wait)

    def warmup(self, specs):
        """Capture the engine's buckets ahead of traffic
        (``InferenceEngine.warmup``); the attached decoder's exec keys
        are captured by ``server.decoder.warmup(prefill_lengths)``."""
        return self.engine.warmup(specs)

    def healthz(self) -> dict:
        """Liveness + readiness: beyond drain state, load balancers get
        warmed-bucket count, queue saturation (depth / capacity) and
        open serving-incident count, so live-but-saturated is
        distinguishable from healthy."""
        from . import slo
        depth = self.batcher.pending()
        limit = self.batcher.queue_depth
        buckets = self.engine.buckets()
        open_serving = 0
        burning = None
        s = slo.get()
        if s is not None:
            open_serving = len(s.snapshot(1)["open"])
            burning = slo.burning_cause()
        h = {
            "status": "draining" if self.batcher.closed else "serving",
            "queue_depth": depth,
            "buckets": buckets,
            "max_batch_size": self.batcher.max_batch_size,
            "max_delay_ms": self.batcher.max_delay_ms,
            "queue_depth_limit": limit,
            "warmed_buckets": len(buckets),
            "queue_saturation": round(depth / limit, 4) if limit else 0.0,
            "open_serving_incidents": open_serving,
            "ready": (not self.batcher.closed and depth < limit
                      and open_serving == 0),
        }
        if burning:
            h["slo_burning"] = burning
        return h

    def varz(self) -> dict:
        """Live telemetry registry snapshot (what ``GET /varz``
        serves): ``telemetry.snapshot()``."""
        return telemetry.snapshot()

    def tracez(self, limit: int = 100) -> dict:
        """Flight-recorder view (what ``GET /tracez`` serves): recent
        completed spans + currently-open spans."""
        return {"enabled": tracing.enabled(),
                "spans": tracing.span_count(),
                "dropped": tracing.dropped_count(),
                "recent": tracing.recent(limit),
                "open": tracing.open_spans()}

    def metricz(self) -> str:
        """The registry as Prometheus text (what ``GET /metrics``
        serves): the numbers of ``/varz``, scrapeable."""
        from .. import clustermon
        return clustermon.prometheus_text()

    def incidentz(self) -> dict:
        """The incident history (what ``GET /incidents`` serves): open
        and recent closed incidents and per-cause counts from the rank-0
        aggregator's store and the serving objectives' store; the empty
        shape when neither runs in this process."""
        from .. import clustermon
        return clustermon.incident_view()

    def sloz(self) -> dict:
        """Serving SLO view (what ``GET /slo`` serves): declared
        objectives, window percentiles, burn rates, saturation
        attribution and any burning incident; the ``{"declared":
        false}`` shape when none is declared.  Evaluates afresh, so that
        a burn clears after traffic stops."""
        from . import slo
        return slo.slo_view()

    def requestz(self, limit: Optional[int] = None) -> dict:
        """Slowest-request ring (what ``GET /requestz`` serves): the N
        slowest requests served with their per-request latency
        decomposition, slowest first."""
        from . import slo
        return slo.requestz(limit)

    def stop(self, drain: bool = True):
        """Drain-aware shutdown: close the batcher's admission
        (delivering admitted responses when ``drain``), then the
        decoder's, then stop the HTTP listener."""
        self.batcher.close(drain=drain)
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

            def _reply_text(self, code: int, text: str, ctype: str):
                body = text.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, server.healthz())
                elif self.path.split("?", 1)[0] == "/metrics":
                    self._reply_text(
                        200, server.metricz(),
                        "text/plain; version=0.0.4; charset=utf-8")
                elif self.path == "/varz":
                    self._reply(200, server.varz())
                elif self.path.split("?", 1)[0] == "/incidents":
                    self._reply(200, server.incidentz())
                elif self.path.split("?", 1)[0] == "/slo":
                    self._reply(200, server.sloz())
                elif self.path.split("?", 1)[0] == "/requestz":
                    limit = None
                    if "?" in self.path:
                        from urllib.parse import parse_qs
                        q = parse_qs(self.path.split("?", 1)[1])
                        try:
                            limit = int(q.get("limit", [None])[0])
                        except (TypeError, ValueError):
                            pass
                    self._reply(200, server.requestz(limit))
                elif self.path.split("?", 1)[0] == "/tracez":
                    limit = 100
                    if "?" in self.path:
                        from urllib.parse import parse_qs
                        q = parse_qs(self.path.split("?", 1)[1])
                        try:
                            limit = int(q.get("limit", ["100"])[0])
                        except ValueError:
                            pass
                    self._reply(200, server.tracez(limit))
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path == "/generate":
                    self._generate()
                    return
                if self.path != "/predict":
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    dtype = req.get("dtype") or server.engine.dtype \
                        or "float32"
                    x = onp.asarray(req["data"], dtype=dtype)
                except (KeyError, TypeError, ValueError) as e:
                    self._reply(400, {"error": f"bad request body: {e}"})
                    return
                try:
                    out = server.predict(x, timeout_ms=req.get("timeout_ms"))
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
                    if isinstance(out, (list, tuple)):
                        self._reply(200, {"outputs":
                                          [onp.asarray(o).tolist()
                                           for o in out]})
                    else:
                        self._reply(200, {"output":
                                          onp.asarray(out).tolist()})

            def _generate(self):
                """POST /generate body ``{"prompt": [ids...],
                "max_new_tokens"?: n, "eos"?: id, "timeout_ms"?: ms}``
                → ``{"tokens": [ids...]}`` (same error mapping as
                /predict; 503 when no decoder is attached)."""
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
