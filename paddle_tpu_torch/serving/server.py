"""Stdlib HTTP frontend for the generation engines — the port's copy of
``paddle_tpu/serving/server.py``.

``http.server.ThreadingHTTPServer`` is enough because the engines own
queueing, batching and admission: each handler thread parks on its
request's future or relays its token stream, and never touches the card.
Endpoints:

    POST /v1/generate JSON  {"prompt_ids": [...], "max_new_tokens": n,
                      "do_sample": bool, "temperature": t, "top_k": k,
                      "top_p": p, "seed": s, "eos_token_id": id,
                      "deadline_ms": ms, "stream": bool} against a
                      GenerationEngine.  ``stream=false`` answers one
                      JSON object {"tokens": [...]} when generation
                      finishes; ``stream=true`` answers
                      ``text/event-stream`` over chunked transfer — one
                      ``data:`` event per sampled token as the continuous
                      batcher emits it ({"token": id, "index": n}), then
                      a final {"done": true, "tokens": [...]} event.
                      Errors after streaming began arrive as a terminal
                      {"error": ...} event (the status line already went
                      out); a client that disconnects mid-stream cancels
                      its request at the next token boundary.
    GET  /healthz     liveness + queue snapshot (JSON).  ``ready`` is
                      false while warmup steps are still being captured
                      (and after close); the paged engine adds its block
                      pool's occupancy and prefix-cache hit rate, every
                      engine its memory breakdown
    GET  /metrics     Prometheus text of the whole metrics registry
    POST /v1/infer    the reference's batching InferenceEngine endpoint;
                      that engine is not ported yet (``ROADMAP.md`` §A
                      item 10), so it answers 404 as the reference does
                      with no inference engine bound
    POST /admin/swap  answered only when a fleet admin object is bound
                      (the reference's ``fleet.FleetReplica``, §A item
                      7c); 404 otherwise

Status mapping: 200 ok, 400 malformed payload, 413 body over the cap
(before it is buffered), 429 admission rejection, 503 engine closed, 504
deadline exceeded.  429 and 503 carry a ``Retry-After`` header derived
from the observed queue drain rate (clamped to [1, 30] s).

``X-Request-Id`` is honoured (generated when absent) and echoed on every
response, in error bodies and in the SSE terminal event; a W3C
``traceparent`` starts the request's trace context (echoed with the
server's root span when ``FLAGS_request_trace`` is on, untouched when it
is off).  ``X-Tenant`` charges the request to that tenant's token bucket
and labels its ``<name>.tenant.*`` series; ``X-Priority`` is one of
``interactive`` / ``standard`` / ``batch`` (payload keys ``tenant`` /
``priority`` work too; the headers win).  ``X-Deadline-Ms`` sets the
request's deadline.
"""
from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..profiler import rtrace as _rtrace
from ..profiler import tracer as _tracer
from ..utils import concurrency as _conc
from .admission import DeadlineExceeded, EngineClosed, RequestRejected

__all__ = ["ServingServer", "serve"]


def _json_default(o):
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.generic,)):
        return o.item()
    raise TypeError(f"not JSON serializable: {type(o).__name__}")


class _Handler(BaseHTTPRequestHandler):
    # the engine is attached to the server object by ServingServer
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default
        if getattr(self.server, "verbose", False):  # pragma: no cover
            super().log_message(fmt, *args)

    # -- request observability -----------------------------------------
    def _begin_request(self):
        """Per-request identity: honor ``X-Request-Id`` (generate one
        when absent) and build the rtrace TraceContext from the W3C
        ``traceparent`` header.  Both are echoed on every response —
        including SSE terminal events and error payloads — so a client
        can always join its logs to the server's trace.  Also counts
        the request into the server's in-flight tally, which the
        graceful-drain path (``ServingServer.stop``) waits on."""
        srv = self.server
        with srv._drain_cond:
            srv._active_requests += 1
        rid = self.headers.get("X-Request-Id") or uuid.uuid4().hex
        self._request_id = rid
        self._obs_headers = {"X-Request-Id": rid}
        tp = self.headers.get("traceparent")
        self._ctx = _rtrace.TraceContext.from_headers(tp,
                                                      request_id=rid)
        self._traced = _rtrace.active
        if self._traced:
            self._obs_headers["traceparent"] = self._ctx.traceparent()
            self._t_ingress = _tracer.now_ns()
        elif tp:
            # tracing off: echo the caller's context untouched so the
            # distributed trace is not silently broken mid-chain
            self._obs_headers["traceparent"] = tp
        self._t_first_write = None
        self._last_status = None

    def _end_request(self):
        """Close the request's server-side spans: ``egress`` (first
        response byte -> done) and the ``ingress`` root (header parse
        -> done, parented to the client's traceparent span) — and
        release the in-flight drain tally."""
        srv = self.server
        with srv._drain_cond:
            srv._active_requests -= 1
            srv._drain_cond.notify_all()
        if not getattr(self, "_traced", False):
            return
        t1 = _tracer.now_ns()
        path = self.path
        self._ctx.record("egress", self._t_first_write or t1, t1,
                         status=self._last_status)
        self._ctx.record("ingress", self._t_ingress, t1, parent=None,
                         span_id=self._ctx.root, path=path,
                         status=self._last_status)

    # -- helpers -------------------------------------------------------
    def _send(self, code: int, body: bytes, ctype: str,
              retry_after=None):
        if self._t_first_write is None:
            self._t_first_write = _tracer.now_ns() \
                if getattr(self, "_traced", False) else 0
        self._last_status = code
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if retry_after is not None:
            self.send_header("Retry-After", str(int(retry_after)))
        for k, v in getattr(self, "_obs_headers", {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj, retry_after=None):
        if code >= 400 and isinstance(obj, dict) \
                and "request_id" not in obj \
                and getattr(self, "_request_id", None):
            # error payloads carry the id in-band too: a client that
            # only logs bodies can still quote it at the operator
            obj = dict(obj, request_id=self._request_id)
        self._send(code, json.dumps(obj, default=_json_default)
                   .encode(), "application/json",
                   retry_after=retry_after)

    # -- GET -----------------------------------------------------------
    def do_GET(self):  # noqa: N802 - stdlib handler naming
        self._begin_request()
        try:
            self._do_get()
        finally:
            self._end_request()

    def _do_get(self):
        engine = self.server.generation_engine
        if self.path == "/healthz":
            from ..profiler import metrics as _metrics
            depth = _metrics.get(
                getattr(engine, "metrics_prefix", "serving")
                + ".queue_depth")
            # alive != dispatchable: ``ready`` stays false while the
            # engine is still capturing its warmup steps (or closing)
            ready = getattr(engine, "ready", True)
            body = {"status": "ok", "ready": ready,
                    "queue_depth": depth.value if depth else 0}
            g = engine
            if g is not None:
                body.update(decode_slots=g.slots,
                            max_length=g.max_length,
                            decode_warmed_buckets=getattr(
                                g, "warmed_buckets", 0),
                            requests_parked=getattr(g, "parked", 0))
                pool = getattr(g, "pool", None)
                if pool is not None:
                    # paged engine: block-pool occupancy + prefix-cache
                    # effectiveness are THE capacity signals a router /
                    # autoscaler dispatches on
                    p = g.metrics_prefix

                    def _val(name):
                        m = _metrics.get(f"{p}.{name}")
                        return m.value if m is not None else 0
                    hits = _val("prefix_cache.hit")
                    misses = _val("prefix_cache.miss")
                    body.update(
                        kv_blocks_total=pool.num_blocks,
                        kv_blocks_in_flight=pool.used,
                        kv_blocks_free=pool.available,
                        kv_block_size=pool.block_size,
                        prefix_cache_hit_rate=round(
                            hits / (hits + misses), 6)
                        if (hits + misses) else 0.0)
            # memory breakdown: where device memory went — params / kv
            # arena / prefix cache / step peak
            mb = getattr(g, "memory_breakdown", None)
            if mb is not None:
                try:
                    body.update(mb())
                except Exception:   # noqa: BLE001 — health never 500s
                    pass
            self._send_json(200, body)
        elif self.path == "/metrics":
            from ..profiler import metrics as _metrics
            self._send(200, _metrics.prometheus_text().encode(),
                       "text/plain; version=0.0.4")
        else:
            self._send_json(404, {"error": f"no route {self.path}; "
                                  "try /v1/infer, /healthz, /metrics"})

    # -- POST ----------------------------------------------------------
    def do_POST(self):  # noqa: N802
        self._begin_request()
        try:
            self._do_post()
        finally:
            self._end_request()

    def _do_post(self):
        if self.path in ("/v1/generate", "/generate"):
            self._do_generate()
            return
        if self.path.startswith("/admin/"):
            self._do_admin()
            return
        if self.path not in ("/v1/infer", "/infer"):
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        # the reference's batching InferenceEngine is not ported yet
        # (ROADMAP.md §A item 10): its answer with none bound
        self._send_json(404, {"error": "no inference engine bound; "
                              "this server only serves /v1/generate"})

    def _do_admin(self):
        """The fleet control plane (``/admin/swap``) is bound only by the
        reference's ``fleet.FleetReplica`` (``ROADMAP.md`` §A item 7c);
        a bare server answers as the reference's does."""
        self._send_json(404, {"error": "no fleet admin bound "
                              "(serve via fleet.FleetReplica)"})

    def _read_body(self):
        """Read the request body under the server byte cap.  Returns
        the bytes, or None after answering 413 — shed, don't OOM: the
        admission contract applies to payload bytes too, BEFORE
        buffering."""
        length = int(self.headers.get("Content-Length") or 0)
        cap = getattr(self.server, "max_body_bytes", 0)
        if cap and length > cap:
            # the body stays unread by design; close the keep-alive
            # connection so the leftover bytes can't be misparsed as
            # the next pipelined request
            self.close_connection = True
            self._send_json(413, {
                "error": f"request body {length} bytes exceeds the "
                         f"server cap {cap}",
                "reason": "body_too_large"})
            return None
        return self.rfile.read(length)

    # -- generation (streaming) ----------------------------------------
    def _do_generate(self):
        gen = self.server.generation_engine
        if gen is None:
            self._send_json(404, {"error": "no generation engine bound "
                                  "(serve a model via GenerationEngine)"})
            return
        try:
            body = self._read_body()
            if body is None:
                return
            payload = json.loads(body.decode() or "{}")
            prompt = payload.get("prompt_ids", payload.get("prompt"))
            if prompt is None:
                raise ValueError("missing 'prompt_ids'")
            prompt = np.asarray(prompt, np.int32).reshape(-1)
            kw = {}
            for k in ("max_new_tokens", "top_k", "seed",
                      "eos_token_id"):
                if payload.get(k) is not None:
                    kw[k] = int(payload[k])
            for k in ("temperature", "top_p", "deadline_ms"):
                if payload.get(k) is not None:
                    kw[k] = float(payload[k])
            if self.headers.get("X-Deadline-Ms") is not None:
                kw["deadline_ms"] = float(self.headers["X-Deadline-Ms"])
            kw["do_sample"] = bool(payload.get("do_sample", False))
            # multi-tenant SLO identity: headers win over payload keys
            # (a gateway stamping X-Tenant must not be overridable by
            # the request body)
            tenant = self.headers.get("X-Tenant") \
                or payload.get("tenant")
            if tenant is not None:
                kw["tenant"] = str(tenant)
            prio = self.headers.get("X-Priority") \
                or payload.get("priority")
            if prio is not None:
                kw["priority"] = str(prio)
            stream = bool(payload.get("stream", False))
        except Exception as e:
            self._send_json(400, {"error": f"malformed payload: {e}"})
            return
        try:
            handle = gen.submit(prompt, trace_ctx=self._ctx, **kw)
        except EngineClosed as e:
            self._send_json(503, {"error": str(e), "reason": e.reason},
                            retry_after=getattr(e, "retry_after", None))
            return
        except RequestRejected as e:
            self._send_json(429, {"error": str(e), "reason": e.reason},
                            retry_after=getattr(e, "retry_after", None))
            return
        except ValueError as e:
            self._send_json(400, {"error": str(e)})
            return
        except Exception as e:   # chaos injection / model-side failure
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        if not stream:
            try:
                toks = handle.result()
            except DeadlineExceeded as e:
                self._send_json(504, {"error": str(e),
                                      "reason": getattr(e, "reason",
                                                        "deadline")})
                return
            except Exception as e:
                self._send_json(500,
                                {"error": f"{type(e).__name__}: {e}"})
                return
            self._send_json(200, {"tokens": toks.tolist()})
            return
        # SSE over chunked transfer: the status goes out before the
        # request finishes, so late errors become a terminal event
        if self._t_first_write is None:
            self._t_first_write = _tracer.now_ns() if self._traced \
                else 0
        self._last_status = 200
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        for k, v in self._obs_headers.items():
            self.send_header(k, v)
        self.end_headers()
        rid = self._request_id
        try:
            i = 0
            for tok in handle:
                self._chunk(f"data: {json.dumps({'token': int(tok), 'index': i})}\n\n")
                i += 1
            # terminal event carries the request id: SSE consumers
            # often never see response headers through proxies/polyfills
            self._chunk("data: " + json.dumps(
                {"done": True, "request_id": rid,
                 "tokens": handle.result().tolist()}) + "\n\n")
        except OSError:
            # client went away mid-stream: free the decode slot and the
            # token-budget reservation at the next token boundary
            # instead of generating the rest for nobody
            handle.cancel()
            return
        except Exception as e:
            try:
                self._chunk("data: " + json.dumps(
                    {"error": f"{type(e).__name__}: {e}",
                     "request_id": rid}) + "\n\n")
            except OSError:
                handle.cancel()
                return
        try:
            self.wfile.write(b"0\r\n\r\n")   # chunked terminator
        except OSError:
            pass

    def _chunk(self, text: str):
        data = text.encode()
        self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
        self.wfile.flush()



class _HTTPServer(ThreadingHTTPServer):
    # socketserver listens with a backlog of 5; a burst of more
    # connections than the accept loop takes in time loses SYNs, which
    # the client's kernel resends only after 1 s (the reference keeps 5:
    # 3 of 16 simultaneous clients waited ~1 s for their headers on the
    # card, chip_smoke.py phase 18a)
    request_queue_size = 128


class ServingServer:
    """Owns a ThreadingHTTPServer bound to a generation engine.

    ``start()`` serves on a daemon thread and returns; ``stop()`` shuts
    the listener down *gracefully* — stop accepting, drain in-flight
    requests (active SSE streams included) — but does NOT close the
    engine (callers own its lifecycle, so one engine can outlive server
    restarts).  Once ``stop`` returns, closing the engine cannot race a
    streaming handler.  The reference's fleet hooks (a replica lease to
    deregister, the ``/admin`` object, a prefill role, a KV prefetch)
    come with ``serving/fleet.py`` (``ROADMAP.md`` §A item 7c)."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 verbose: bool = False, max_body_bytes: int = 64 << 20):
        from .engine import GenerationEngine
        if not isinstance(engine, GenerationEngine):
            raise NotImplementedError(
                "the batching InferenceEngine is not ported yet "
                "(ROADMAP.md §A item 10); bind a GenerationEngine")
        self.generation_engine = engine
        self._httpd = _HTTPServer((host, port), _Handler)
        self._httpd.generation_engine = engine
        self._httpd.verbose = verbose
        self._httpd.max_body_bytes = int(max_body_bytes)
        self._httpd.daemon_threads = True
        self._httpd._active_requests = 0
        self._httpd._drain_cond = _conc.Condition(name="serving.http.drain")
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ServingServer":
        self._thread = _conc.spawn(self._httpd.serve_forever,
                                   name="serving-http")
        return self

    @property
    def active_requests(self) -> int:
        return self._httpd._active_requests

    def stop(self, drain_s: float = 30.0):
        """Graceful shutdown: (1) stop accepting new connections,
        (2) let every in-flight handler — including mid-stream SSE
        responses — run to completion, bounded by ``drain_s`` seconds,
        (3) release the socket.  Only then is it safe for the owner to
        close the engine.  ``drain_s=0`` does not drain."""
        self._httpd.shutdown()
        if drain_s and drain_s > 0:
            deadline = time.monotonic() + drain_s
            with self._httpd._drain_cond:
                while self._httpd._active_requests > 0:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        import warnings
                        warnings.warn(
                            f"ServingServer.stop: "
                            f"{self._httpd._active_requests} request(s)"
                            f" still in flight after the {drain_s}s "
                            "drain window; shutting down anyway",
                            RuntimeWarning)
                        break
                    self._httpd._drain_cond.wait(timeout=remaining)
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def serve(model, host: str = "127.0.0.1", port: int = 8975,
          config=None, block: bool = True):
    """One-call endpoint over a :class:`GenerationEngine` (or a
    :class:`PagedGenerationEngine`): serve it over HTTP.  ``block=False``
    returns the started :class:`ServingServer`.  The reference also takes
    a model path or predictor and builds its batching InferenceEngine
    over it; that engine is not ported yet (``ROADMAP.md`` §A item 10),
    so anything but a generation engine raises."""
    from .engine import GenerationEngine
    if not isinstance(model, GenerationEngine):
        raise NotImplementedError(
            "serve() builds the batching InferenceEngine for a model, "
            "which is not ported yet (ROADMAP.md §A item 10); pass a "
            "GenerationEngine")
    server = ServingServer(model, host=host, port=port).start()
    if not block:
        return server
    try:  # pragma: no cover - interactive path
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()   # a caller-provided engine outlives the server
    return server
