"""Live metrics exposition: an opt-in background HTTP scrape endpoint.

Counterpart of tpustream/obs/serve.py (the port's own copy).

``ObsConfig.serve_port`` (None = off, 0 = ephemeral) starts one
``ThreadingHTTPServer`` daemon thread per job, bound to
``ObsConfig.serve_host`` (loopback by default), serving:

* ``GET /metrics``       — Prometheus text 0.0.4 (the registry renderer)
* ``GET /healthz``       — HealthEngine levels as JSON; HTTP 503 while
  any rule is CRIT, so a liveness probe needs no body parsing
* ``GET /snapshot.json`` — the full job snapshot (series + trace + health
  + the continuous profiler's ``profile`` section)
* ``GET /profile.json``  — just the profiler's windowed stage
  attribution (binding stage, shares, occupancy), cheap to poll
* ``GET /trace.json``    — the unified Chrome-trace/Perfetto timeline
  (StepTracer spans, lane spans, flight instants, sampled record
  flight paths; obs/tracing_export.py); load it at ui.perfetto.dev
* ``GET /tenants.json``  — per-tenant fleet view (admission/emit/error
  rates, SLO levels, budget burn) when a JobServer is attached; 404 on
  single-job runs
* ``GET /env.json``      — the environment fingerprint (usable cores,
  cgroup quota, NUMA nodes, the job's device, hostname hash;
  obs/resources.py); 404 when collection failed
* ``GET /ledger.json``   — the conservation ledger's live edge table
  (per-edge terms + residuals, violation latches, per-sink digest
  anchors; obs/ledger.py); 404 when the ledger is off

Everything else is 404; non-GET methods are 405. The server is pure
stdlib (no deps), started/stopped by ``execute_job`` alongside the
Snapshotter, and rendering is read-only over the registry — the executor
thread is never blocked by a scrape, and a torn read of one in-flight
sample is the same tolerance the snapshot path already has. A handler
exception returns 500 and leaves one flight-recorder breadcrumb, never
a crashed serve thread.
"""

from __future__ import annotations

import http.server
import json
import threading
from typing import Optional

HEALTH_BAD_STATUS = 503


class MetricsServer:
    """Background scrape endpoint over one job's observability root.

    ``provider`` is duck-typed (a :class:`JobObs`, or any object with
    ``to_prometheus_text()``, ``snapshot()`` and an optional ``health``
    engine) so the dump CLI selftest can round-trip a canned registry
    without a live job.
    """

    def __init__(self, provider, port: int = 0, host: str = "127.0.0.1",
                 flight=None):
        self._provider = provider
        self._flight = flight
        self._error_logged = False
        self.closed = False
        server = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            server_version = "tpustream-obs"

            def log_message(self, *args):  # no stderr chatter per scrape
                pass

            def do_GET(self):
                code, ctype, body = server._render(self.path)
                self._reply(code, ctype, body)

            def _method_not_allowed(self):
                body = b'{"error": "method not allowed"}'
                self.send_response(405)
                self.send_header("Allow", "GET")
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            do_POST = _method_not_allowed
            do_PUT = _method_not_allowed
            do_DELETE = _method_not_allowed
            do_PATCH = _method_not_allowed

            def _reply(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = http.server.ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="tpustream-obs-serve",
            daemon=True,
        )
        self._started = False

    # -- rendering (called from handler threads) ----------------------------

    def _render(self, path: str):
        try:
            if path == "/metrics":
                body = self._provider.to_prometheus_text().encode("utf-8")
                return 200, "text/plain; version=0.0.4; charset=utf-8", body
            if path == "/healthz":
                return self._render_health()
            if path == "/snapshot.json":
                body = json.dumps(
                    self._provider.snapshot(), default=str
                ).encode("utf-8")
                return 200, "application/json", body
            if path == "/tenants.json":
                tenants = getattr(self._provider, "tenants_snapshot", None)
                view = tenants() if tenants is not None else None
                if view is None:
                    return (
                        404,
                        "application/json",
                        b'{"error": "no tenancy attached (single-job run)"}',
                    )
                body = json.dumps(view, default=str).encode("utf-8")
                return 200, "application/json", body
            if path == "/ledger.json":
                ledger = getattr(self._provider, "ledger_snapshot", None)
                view = ledger() if ledger is not None else None
                if view is None:
                    return (
                        404,
                        "application/json",
                        b'{"error": "no ledger (ledger disabled)"}',
                    )
                body = json.dumps(view, default=str).encode("utf-8")
                return 200, "application/json", body
            if path == "/env.json":
                env = getattr(self._provider, "env_snapshot", None)
                view = env() if env is not None else None
                if view is None:
                    return (
                        404,
                        "application/json",
                        b'{"error": "no environment fingerprint"}',
                    )
                body = json.dumps(view, default=str).encode("utf-8")
                return 200, "application/json", body
            if path == "/profile.json":
                profiler = getattr(self._provider, "profiler", None)
                if profiler is None:
                    return (
                        404,
                        "application/json",
                        b'{"error": "no profiler (tracing disabled)"}',
                    )
                body = json.dumps(
                    profiler.profile(), default=str
                ).encode("utf-8")
                return 200, "application/json", body
            if path == "/trace.json":
                tl = getattr(self._provider, "trace_timeline", None)
                timeline = tl() if tl is not None else None
                if timeline is None:
                    return (
                        404,
                        "application/json",
                        b'{"error": "no trace (tracing disabled)"}',
                    )
                body = json.dumps(timeline, default=str).encode("utf-8")
                return 200, "application/json", body
            return (
                404,
                "application/json",
                json.dumps({"error": "not found", "path": path}).encode(),
            )
        except Exception as e:
            if self._flight is not None and not self._error_logged:
                self._error_logged = True
                self._flight.record(
                    "serve_render_error", path=path, error=repr(e)
                )
            return (
                500,
                "application/json",
                json.dumps({"error": repr(e)}).encode(),
            )

    def _render_health(self):
        health = getattr(self._provider, "health", None)
        if health is None:
            state = {"level": "ok", "rules": []}
        else:
            state = health.state()
        code = 200 if state.get("level") != "crit" else HEALTH_BAD_STATUS
        return code, "application/json", json.dumps(state).encode("utf-8")

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "MetricsServer":
        self._started = True
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self, timeout: Optional[float] = 5.0) -> None:
        """Stop accepting, join the serve thread, release the socket.
        Idempotent — the job-close path and a user finally can race it."""
        if self.closed:
            return
        self.closed = True
        if self._started:  # shutdown() would block on a never-served loop
            self._httpd.shutdown()
            self._thread.join(timeout=timeout)
        self._httpd.server_close()
