"""Live observability endpoints: ``/metrics``, ``/healthz``, ``/statusz``
(port of ``dpgo_tpu.serve.statusz``).

The report CLI is post-hoc — it reads artifacts after the run closes.  An
operated service needs its numbers *while it runs*: Prometheus scrapes
``/metrics`` on an interval, load balancers poll ``/healthz``, and humans
(or ``python -m dpgo_tpu_torch.obs.report --live HOST:PORT``) read
``/statusz``.
``MetricsSidecar`` is a stdlib ``ThreadingHTTPServer`` on a daemon thread
bound to one ``SolveServer`` + one ``TelemetryRun``:

* ``GET /metrics`` — the Prometheus text exposition of the run's live
  registry (``obs.exporters.to_prometheus_text``): request/shed/cache
  counters, latency histograms, SLO burn gauges, compile/device timings.
* ``GET /healthz`` — liveness JSON: ``{"ok": true, "uptime_s": ...}``
  while the server accepts work, HTTP 503 once it is closed.
* ``GET /statusz`` — ``SolveServer.status()`` as JSON: queue depth,
  per-tenant in-flight vs. quota, last-batch occupancy, cache
  hit/compile tallies, SLO burn rates, uptime.

Zero-overhead fence: ``SolveServer`` constructs a sidecar only when a
telemetry run is live (there is no registry to scrape otherwise), so
telemetry-off servers spawn no HTTP threads — the serving boom test
patches ``MetricsSidecar.__init__`` to prove it.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..obs.events import _jsonable
from ..obs.exporters import to_prometheus_text

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsSidecar:
    """HTTP observability sidecar for one ``SolveServer``.

    Binds on construction (``port=0`` = OS-assigned; read the resolved
    ``.port``), serves on daemon threads, and never touches devices —
    every endpoint renders host-side state the serving plane already
    keeps."""

    def __init__(self, server, run, host: str = "127.0.0.1",
                 port: int = 0):
        self.server = server
        self.run = run
        sidecar = self

        class _Handler(BaseHTTPRequestHandler):
            # One scrape per line of access log would drown the real
            # events; errors still surface through the response codes.
            def log_message(self, *args):
                pass

            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                try:
                    if path == "/metrics":
                        body = to_prometheus_text(
                            sidecar.run.registry).encode("utf-8")
                        ctype = PROMETHEUS_CONTENT_TYPE
                        code = 200
                    elif path == "/healthz":
                        # status() reads the lifecycle flags under the
                        # server lock — no bare cross-thread attribute
                        # peeking from the scrape threads.  A draining
                        # server still answers 200 (in-flight work is
                        # finishing) but says so, so load balancers can
                        # stop routing BEFORE the hard 503.
                        st = sidecar.server.status()
                        closed = st["closed"]
                        payload = {"ok": not closed,
                                   "draining": st.get("draining", False),
                                   "uptime_s": st["uptime_s"],
                                   "run": sidecar.run.run_id}
                        # Replica identity: lets a prober
                        # tell WHICH replica answered — id, pid, device —
                        # the distinction the router/manager health loop
                        # and rolling-restart tooling key on.
                        if st.get("replica") is not None:
                            payload["replica"] = st["replica"]
                        body = json.dumps(payload).encode("utf-8")
                        ctype = "application/json"
                        code = 200 if not closed else 503
                    elif path == "/statusz":
                        body = json.dumps(
                            _jsonable(sidecar.server.status())).encode(
                                "utf-8")
                        ctype = "application/json"
                        code = 200
                    else:
                        body = json.dumps(
                            {"error": f"unknown path {path!r}",
                             "paths": ["/metrics", "/healthz",
                                       "/statusz"]}).encode("utf-8")
                        ctype = "application/json"
                        code = 404
                except Exception as e:  # never take the scrape loop down
                    body = json.dumps({"error": repr(e)}).encode("utf-8")
                    ctype = "application/json"
                    code = 500
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        try:
            self._httpd.daemon_threads = True
            self.host, self.port = self._httpd.server_address[:2]
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True,
                name="dpgo-serve-metrics")
            self._thread.start()
        except BaseException:
            # Never strand the bound listening socket on a failed start
            # (leakcheck-enforced contract).
            self._httpd.server_close()
            raise

    def close(self) -> None:
        try:
            self._httpd.shutdown()
        finally:
            # The socket must die even when shutdown() fails — a wedged
            # serve thread should not keep the port bound.
            self._httpd.server_close()
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsSidecar":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
