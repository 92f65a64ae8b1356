"""Embedded admin/telemetry HTTP plane: ``/metrics`` · ``/healthz`` ·
``/statusz`` · ``/debug/*`` on a live process (docs/OBSERVABILITY.md
"Live telemetry plane"). A copy of ``paddle_tpu/monitor/server.py``:
``/debug/profile`` drives the port's profiler and the program table
reads the port's ``monitor.memory``.

Everything this repo's observability built so far — registry, traces,
SLO burn, flight recorder, program tables — was *post-hoc*: JSONL/JSON
dumps read by ``tools/monitor_report.py`` after the run ends. A serving
process in front of real traffic needs the pull-while-running half: a
scrape endpoint an operator points Prometheus at, health/readiness
wired to the engine's actual state machine, and the ability to grab a
profile or the trace ring from the LIVE process without restarting it.

:class:`AdminServer` is a stdlib ``http.server.ThreadingHTTPServer``
(no dependencies, one daemon accept thread + per-request handler
threads) started by the serving engine — and opt-in by ``TrainStep`` /
bench runs — when ``FLAGS_monitor_port`` is set:

==================  =======================================================
endpoint            payload
==================  =======================================================
``/metrics``        text exposition of the active registry. Content-
                    negotiated: an ``Accept: application/openmetrics-
                    text`` scrape gets the OpenMetrics page with
                    histogram exemplars rendered in the
                    ``# {trace_id="..."}`` suffix syntax (+ ``# EOF``);
                    plain scrapes get classic 0.0.4 text without
                    exemplars (whose parser would reject the suffix).
                    Each scrape also snapshots the registry into the
                    in-memory :class:`~.timeseries.TimeseriesRing`
``/healthz``        liveness: 200 while the process answers at all
``/readyz``         readiness: 200 only when EVERY registered readiness
                    provider reports ready; 503 with a structured JSON
                    reason body otherwise (each serving engine
                    registers one provider)
``/statusz``        one JSON page: environment fingerprint, full flags
                    snapshot, per-program FLOPs/memory table, registered
                    status sections (engine occupancy, SLO burn, …) and
                    windowed per-second rates from the timeseries ring
``/debug/flight``   the flight-recorder document — byte-for-byte the
                    JSON a crash would dump (ring of step records,
                    events, fingerprint, attached trace section)
``/debug/trace``    retained + in-flight structured-trace span trees;
                    ``?format=perfetto`` returns the merged
                    chrome-trace/Perfetto timeline instead
``/debug/profile``  ``?seconds=N`` arms a profiler window on the live
                    process (host RecordEvent timeline + a
                    ``torch.profiler`` session's operators and kernels),
                    sleeps N seconds on the request thread, and returns
                    the chrome-trace JSON; 409 while another capture
                    (or a user profiler session) is active
==================  =======================================================

Zero-overhead contract: ``FLAGS_monitor_port`` unset (0, the default)
means :func:`maybe_start_from_flags` returns None after ONE flag read —
no thread, no socket, no registry series — pinned by test. When the
server IS on, each request increments ``monitor_http_requests_total``
(by endpoint) in the active registry.

Security: binds ``FLAGS_monitor_host`` = 127.0.0.1 by default. The
plane exposes flags, program tables and live profiles — widening the
bind address is an explicit operator decision (see the security note in
docs/OBSERVABILITY.md).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

from .flight_recorder import _json_safe_tree, get_flight_recorder
from .timeseries import TimeseriesRing

__all__ = ["AdminServer", "maybe_start_from_flags", "get_server",
           "stop_server", "PROFILE_MAX_SECONDS"]

#: upper clamp for /debug/profile?seconds=N — a scrape must never pin
#: the handler thread for minutes because of a typo'd query param
PROFILE_MAX_SECONDS = 60.0

#: default trailing window for the /statusz rates section (seconds)
STATUS_RATE_WINDOW_S = 60.0

#: thread-name prefix of every admin-plane thread — the zero-thread pin
#: in tests greps live thread names for this
THREAD_PREFIX = "ptpu-admin"

_profile_lock = threading.Lock()

#: sentinel a provider returns when its weakref'd subject was garbage
#: collected: the registration is PRUNED on the next read. Readiness
#: providers must use this (never None) for a dead subject — None
#: means "ready", and a collected engine silently reading as ready is
#: exactly the fail-open a load balancer must not see.
STALE = object()


class _Handler(BaseHTTPRequestHandler):
    # per-request handler; self.server is the _HTTPServer below, whose
    # .admin is the AdminServer

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):     # stdlib default logs to
        pass                               # stderr per request — no

    def do_GET(self):                      # noqa: N802 (stdlib name)
        admin: "AdminServer" = self.server.admin
        parsed = urlparse(self.path)
        query = {k: v[-1] for k, v in parse_qs(parsed.query).items()}
        try:
            admin._count_request(parsed.path)
            admin._dispatch(self, parsed.path, query)
        except BrokenPipeError:
            pass                           # client went away mid-write
        except Exception as e:             # a handler bug must answer
            try:                           # 500, never kill the thread
                self._send(500, "application/json",
                           json.dumps({"error": repr(e)}).encode())
            except Exception:
                pass

    def _send(self, code: int, ctype: str, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    admin: "AdminServer"

    def process_request(self, request, client_address):
        # stamp the per-request worker threads with the admin prefix so
        # the zero-thread overhead pin can account for every thread the
        # plane ever creates (ThreadingHTTPServer names them Thread-N)
        t = threading.Thread(
            target=self.process_request_thread,
            args=(request, client_address),
            name=f"{THREAD_PREFIX}-req",
            daemon=True)
        t.start()


class AdminServer:
    """One embedded admin plane. ``start()`` binds + spawns the accept
    thread; ``close()`` tears both down. ``registry=None`` resolves the
    ACTIVE registry per request (so ``scoped_registry`` tests and the
    process-global default both work)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry=None, ring: Optional[TimeseriesRing] = None,
                 clock=time.time):
        self._requested_port = int(port)
        self.host = host
        self._registry = registry
        self.ring = ring if ring is not None else TimeseriesRing()
        self.clock = clock
        self._httpd: Optional[_HTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        #: name -> callable() -> None (ready) | dict (not-ready reason)
        self._readiness: Dict[str, Callable[[], Optional[dict]]] = {}
        #: name -> callable() -> JSON-safe section (None = provider gone)
        self._status: Dict[str, Callable[[], Any]] = {}
        self._lock = threading.Lock()

    # -- lifecycle ----------------------------------------------------------
    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    @property
    def url(self) -> Optional[str]:
        return (f"http://{self.host}:{self.port}"
                if self._httpd else None)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "AdminServer":
        if self._httpd is not None:
            return self
        self._httpd = _HTTPServer((self.host, self._requested_port),
                                  _Handler)
        self._httpd.admin = self
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            name=f"{THREAD_PREFIX}-http", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        httpd, thread = self._httpd, self._thread
        self._httpd = self._thread = None
        if httpd is not None:
            try:
                httpd.shutdown()
                httpd.server_close()
            except Exception:
                pass
        if thread is not None:
            thread.join(timeout=2.0)

    # -- provider registration ----------------------------------------------
    def register_readiness(self, name: str,
                           fn: Callable[[], Optional[dict]]) -> None:
        """``fn()`` returns None while ready, a JSON-safe dict
        explaining why not (it becomes the 503 body's reason), or
        :data:`STALE` when its subject no longer exists (the
        registration is then pruned — a weakref'd provider must never
        let a collected subject read as ready)."""
        with self._lock:
            self._readiness[name] = fn

    def unregister_readiness(self, name: str) -> None:
        with self._lock:
            self._readiness.pop(name, None)

    def register_status(self, name: str, fn: Callable[[], Any]) -> None:
        """``fn()`` returns a JSON-safe section for ``/statusz`` (None
        = the provider's subject is gone; the entry is dropped)."""
        with self._lock:
            self._status[name] = fn

    def unregister_status(self, name: str) -> None:
        with self._lock:
            self._status.pop(name, None)

    # -- request plumbing ---------------------------------------------------
    def registry(self):
        if self._registry is not None:
            return self._registry
        from .metrics import get_registry
        return get_registry()

    #: the label vocabulary of monitor_http_requests_total — anything
    #: else (scanners, misdirected probes, typos) folds into "other" so
    #: junk paths can never grow registry cardinality without bound
    _KNOWN_PATHS = frozenset((
        "/", "", "/metrics", "/healthz", "/readyz", "/statusz",
        "/debug/flight", "/debug/trace", "/debug/profile"))

    def _count_request(self, path: str) -> None:
        try:
            self.registry().counter(
                "monitor_http_requests_total",
                "admin-plane HTTP requests by endpoint").inc(
                path=path if path in self._KNOWN_PATHS else "other")
        except Exception:
            pass                   # telemetry about telemetry is
                                   # best-effort, never a 500

    def _dispatch(self, h: _Handler, path: str,
                  query: Dict[str, str]) -> None:
        if path == "/metrics":
            return self._metrics(h)
        if path == "/healthz":
            return h._send(200, "text/plain; charset=utf-8", b"ok\n")
        if path == "/readyz":
            return self._readyz(h)
        if path == "/statusz":
            return self._statusz(h, query)
        if path == "/debug/flight":
            return self._json(h, get_flight_recorder().doc(
                reason="admin_endpoint"))
        if path == "/debug/trace":
            return self._debug_trace(h, query)
        if path == "/debug/profile":
            return self._debug_profile(h, query)
        if path in ("/", ""):
            return self._json(h, {
                "endpoints": ["/metrics", "/healthz", "/readyz",
                              "/statusz", "/debug/flight",
                              "/debug/trace", "/debug/profile"]})
        h._send(404, "application/json",
                json.dumps({"error": f"no such endpoint {path!r}"}
                           ).encode())

    @staticmethod
    def _json(h: _Handler, doc: Any, code: int = 200) -> None:
        body = json.dumps(_json_safe_tree(doc), indent=1).encode()
        h._send(code, "application/json", body)

    # -- endpoints ----------------------------------------------------------
    def _metrics(self, h: _Handler) -> None:
        reg = self.registry()
        try:
            self.ring.snapshot(reg)    # scrapes ARE the rate clock
        except Exception:
            pass
        # content negotiation: exemplar suffixes are only legal in the
        # OpenMetrics format (which also requires the # EOF trailer) —
        # the classic text/plain 0.0.4 parser real Prometheus selects
        # from the Content-Type would reject them and fail the WHOLE
        # scrape, so the plain page ships without exemplars
        accept = h.headers.get("Accept", "")
        if "application/openmetrics-text" in accept:
            text = reg.to_prometheus(exemplars=True) + "# EOF\n"
            ctype = ("application/openmetrics-text; version=1.0.0; "
                     "charset=utf-8")
        else:
            text = reg.to_prometheus(exemplars=False)
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        h._send(200, ctype, text.encode())

    def _readyz(self, h: _Handler) -> None:
        with self._lock:
            providers = dict(self._readiness)
        reasons: Dict[str, dict] = {}
        stale = []
        for name, fn in providers.items():
            try:
                r = fn()
            except Exception as e:
                r = {"state": "provider-error", "error": repr(e)}
            if r is STALE:                 # subject collected: prune,
                stale.append(name)         # never read as "ready"
                continue
            if r is not None:
                reasons[name] = r
        for name in stale:
            self.unregister_readiness(name)
        if reasons:
            self._json(h, {"ready": False, "reasons": reasons},
                       code=503)
        else:
            self._json(h, {"ready": True,
                           "checks": sorted(set(providers) - set(stale))})

    def _statusz(self, h: _Handler, query: Dict[str, str]) -> None:
        reg = self.registry()
        try:
            self.ring.snapshot(reg)
        except Exception:
            pass
        try:
            window = float(query.get("window", STATUS_RATE_WINDOW_S))
        except ValueError:
            window = STATUS_RATE_WINDOW_S
        from ..core import flags as F
        from . import memory as monitor_memory
        doc: Dict[str, Any] = {
            "now": self.clock(),
            "fingerprint": get_flight_recorder().fingerprint(),
            "flags": {name: F.get_flag(name)
                      for name in sorted(F._REGISTRY)},
            "programs": {kind: pm.as_dict() for kind, pm in
                         monitor_memory.programs().items()},
            "rates": {"window_s": window,
                      "per_second": self.ring.rates(window_s=window)},
        }
        with self._lock:
            providers = dict(self._status)
        sections: Dict[str, Any] = {}
        stale = []
        for name, fn in providers.items():
            try:
                section = fn()
            except Exception as e:
                sections[name] = {"error": repr(e)}
                continue
            if section is None or section is STALE:
                stale.append(name)     # weakref'd subject collected
                continue
            sections[name] = section
        for name in stale:
            self.unregister_status(name)
        doc["sections"] = sections
        self._json(h, doc)

    def _debug_trace(self, h: _Handler, query: Dict[str, str]) -> None:
        from . import trace as trace_mod
        tracer = trace_mod.get_tracer()
        if query.get("format") == "perfetto":
            return self._json(h, trace_mod.perfetto_doc(
                tracer.snapshot(include_live=True)))
        self._json(h, {"format": 1, "dumped_at": self.clock(),
                       "traces": tracer.snapshot(include_live=True)})

    def _debug_profile(self, h: _Handler,
                       query: Dict[str, str]) -> None:
        try:
            seconds = float(query.get("seconds", 1.0))
        except ValueError:
            return self._json(h, {"error": "seconds must be a number"},
                              code=400)
        seconds = min(max(seconds, 0.01), PROFILE_MAX_SECONDS)
        from .. import profiler as prof
        if not _profile_lock.acquire(blocking=False):
            return self._json(
                h, {"error": "a profile capture is already running"},
                code=409)
        try:
            if prof._active[0]:
                return self._json(
                    h, {"error": "a profiler session is already "
                                 "active in this process"}, code=409)
            # one torch.profiler window (RecordEvent spans, operators
            # and, on the card, every kernel): it returns as one JSON
            # body once the session has stopped
            prof.start_profiler()
            try:
                time.sleep(seconds)
            finally:
                prof.stop_profiler()
            doc = prof.chrome_trace_doc()
        finally:
            _profile_lock.release()
        doc["captureSeconds"] = seconds
        self._json(h, doc)


# ---------------------------------------------------------------------------
# Flag-gated process-global server
# ---------------------------------------------------------------------------

_server: Optional[AdminServer] = None
_server_lock = threading.Lock()


def maybe_start_from_flags() -> Optional[AdminServer]:
    """Start (or return) the process-global admin server when
    ``FLAGS_monitor_port`` is set; None — after ONE flag read, zero
    allocations — when it is 0 (the default). ``-1`` binds an
    ephemeral OS-assigned port (tests / several processes per host;
    read it back from ``get_server().port``)."""
    from ..core.flags import get_flag
    port = int(get_flag("monitor_port") or 0)
    if port == 0:
        return None
    global _server
    with _server_lock:
        if _server is None or not _server.running:
            host = str(get_flag("monitor_host") or "127.0.0.1")
            srv = AdminServer(port=(0 if port < 0 else port), host=host)
            try:
                srv.start()
            except OSError as e:
                import warnings
                warnings.warn(
                    f"admin server failed to bind {host}:{port} "
                    f"({e}); telemetry plane disabled for this "
                    "process", RuntimeWarning)
                return None
            _server = srv
        return _server


def get_server() -> Optional[AdminServer]:
    """The process-global admin server, if one is running."""
    return _server


def stop_server() -> None:
    """Tear down the process-global server (tests / clean shutdown)."""
    global _server
    with _server_lock:
        if _server is not None:
            _server.close()
            _server = None
