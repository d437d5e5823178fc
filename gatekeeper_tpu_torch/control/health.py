"""Health endpoints.

Counterpart of the reference's healthz/readyz wiring (main.go:205-212:
a ping checker on /healthz and default-ready /readyz served on
--health-addr). /healthz consults the registered LIVENESS watchdogs
(none registered = plain ping): a wedged micro-batch flusher or a dead
audit loop fails liveness so k8s restarts the pod. /readyz consults the
registered readiness checks (including the kube-write circuit breaker)
and answers 503 with the failing check names until they all pass.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from .logging import logger

log = logger("health")


def parse_addr(addr: str) -> Optional[tuple[str, int]]:
    """":9090" / "0.0.0.0:9090" -> (host, port); None when disabled
    (empty or "0") or unparseable. Port 0 binds an EPHEMERAL port
    (tests use ":0" to avoid collisions)."""
    if not addr or addr == "0":
        return None
    host, _, port_s = addr.rpartition(":")
    try:
        port = int(port_s)
    except ValueError:
        return None
    if port < 0:
        return None
    return (host or "0.0.0.0", port)


class HealthServer:
    """/healthz + /readyz on --health-addr."""

    def __init__(self, host: str, port: int):
        self._checks: dict[str, Callable[[], bool]] = {}
        self._live: dict[str, Callable[[], bool]] = {}
        # /debug/<name> providers (shared registry with the metrics
        # server — an audit-only pod without a scrape port still
        # exposes its flight recorder through the health port)
        self._debug: dict[str, Callable] = {}
        self._lock = threading.Lock()
        checks = self._checks
        live = self._live
        debug = self._debug
        lock = self._lock

        def failing(items) -> list[str]:
            out = []
            for name, fn in items:
                try:
                    if not fn():
                        out.append(name)
                except Exception:
                    out.append(name)
            return out

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                path, _, query = self.path.partition("?")
                path = path.rstrip("/")
                if path.startswith("/debug/"):
                    with lock:
                        providers = dict(debug)
                    if providers:
                        from .metrics import render_debug
                        body, code = render_debug(
                            providers, path[len("/debug/"):], query)
                        self._reply(code, body, "application/json")
                        return
                if path == "/healthz":
                    # liveness watchdog: a wedged flusher/audit loop
                    # fails liveness so k8s restarts the pod (a process
                    # that is up but not serving is NOT alive)
                    with lock:
                        items = list(live.items())
                    bad = failing(items)
                    if bad:
                        log.error("liveness check failing",
                                  details={"checks": bad})
                        self._reply(503, ("not alive: "
                                          + ", ".join(bad)).encode())
                    else:
                        self._reply(200, b"ok")
                    return
                if path == "/readyz":
                    with lock:
                        items = list(checks.items())
                    bad = failing(items)
                    if bad:
                        self._reply(503, ("not ready: "
                                          + ", ".join(bad)).encode())
                    else:
                        self._reply(200, b"ok")
                    return
                self._reply(404, b"not found")

            def _reply(self, code: int, body: bytes,
                       ctype: str = "text/plain"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def add_readiness(self, name: str, check: Callable[[], bool]) -> None:
        with self._lock:
            self._checks[name] = check

    def add_liveness(self, name: str, check: Callable[[], bool]) -> None:
        """Register a liveness watchdog: /healthz answers 503 while any
        registered check fails, so the kubelet restarts a wedged pod."""
        with self._lock:
            self._live[name] = check

    def add_debug(self, name: str, provider: Callable) -> None:
        """Mount a /debug/<name> provider (same callable contract as
        metrics.serve's debug_providers: raw query string in, JSON-
        serializable object out)."""
        with self._lock:
            self._debug[name] = provider

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="health", daemon=True)
        self._thread.start()
        log.info("health endpoints serving",
                 details={"port": self.port})

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
