"""MetricsServer — HTTP telemetry export (Prometheus text + JSON).

A copy of the JAX package's ``obs/server.py`` (no JAX in it). Endpoints:

- ``/metrics``       Prometheus text exposition (format 0.0.4) — point a
  Prometheus scrape job (or ``curl``) at it.
- ``/metrics.json``  the same registry as a structured JSON snapshot
  (histograms include per-bucket counts and p50/p99 estimates).
- ``/healthz``       liveness probe (200 ``ok``).
- ``/fleet/metrics``, ``/fleet/metrics.json`` — with a ``federation``
  (``obs/distributed.FederatedMetrics``), the merged view of N replicas.

The server is a stdlib ``ThreadingHTTPServer`` on a daemon thread — no
new dependencies, safe to run alongside a PLAYING pipeline (scrapes only
take short per-metric locks).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.obs.registry import MetricsRegistry, get_registry

log = get_logger("obs")

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _Handler(BaseHTTPRequestHandler):
    registry: MetricsRegistry  # set on the subclass by MetricsServer
    #: optional extra-sections provider (``slo`` / ``attribution`` /
    #: ``quantiles`` from the pipeline's flight recorder; in the port
    #: also ``regions``, the fused regions' dispatch counts, and
    #: ``launches``, the kernel wrappers' counts) merged into the
    #: /metrics.json snapshot — the in-process ``metrics_snapshot()``
    #: sections over HTTP, and what fleet federation scrapes
    snapshot_fn = None
    #: optional FederatedMetrics serving the /fleet/* routes
    federation = None

    def do_GET(self):  # noqa: N802 — http.server API
        path = self.path.split("?", 1)[0]
        if path in ("/metrics", "/"):
            body = self.registry.render_prometheus().encode()
            ctype = PROMETHEUS_CONTENT_TYPE
        elif path == "/metrics.json":
            snap = self.registry.snapshot()
            fn = type(self).snapshot_fn
            if fn is not None:
                try:
                    extra = fn() or {}
                except Exception as e:  # noqa: BLE001 — a scrape must
                    # never 500 because the pipeline is mid-transition
                    log.debug("metrics snapshot sections failed: %s", e)
                    extra = {}
                for key in ("slo", "attribution", "quantiles", "regions",
                            "launches"):
                    if key in extra:
                        snap[key] = extra[key]
            body = json.dumps(snap).encode()
            ctype = "application/json"
        elif path == "/healthz":
            body, ctype = b"ok\n", "text/plain"
        elif path == "/fleet/metrics" and self.federation is not None:
            body = self.federation.render_prometheus().encode()
            ctype = PROMETHEUS_CONTENT_TYPE
        elif path == "/fleet/metrics.json" and self.federation is not None:
            body = json.dumps(self.federation.collect()).encode()
            ctype = "application/json"
        else:
            self.send_error(404, "unknown path (try /metrics)")
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        log.debug("metrics http: " + fmt, *args)


class MetricsServer:
    """Serve a registry over HTTP; ``port=0`` binds an ephemeral port
    (resolved into :attr:`port` after :meth:`start`)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 host: str = "0.0.0.0", port: int = 0,
                 snapshot_fn=None, federation=None):
        self.registry = registry or get_registry()
        self.host = host
        self.port = int(port)
        #: callable returning extra /metrics.json sections
        #: (slo/attribution/quantiles/regions/launches) — see
        #: _Handler.snapshot_fn
        self.snapshot_fn = snapshot_fn
        #: FederatedMetrics aggregator backing /fleet/metrics[.json]
        self.federation = federation
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsServer":
        if self._httpd is not None:
            return self
        handler = type("BoundHandler", (_Handler,),
                       {"registry": self.registry,
                        "snapshot_fn": staticmethod(self.snapshot_fn)
                        if self.snapshot_fn is not None else None,
                        "federation": self.federation})
        self._httpd = ThreadingHTTPServer((self.host, self.port), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="metrics-http", daemon=True)
        self._thread.start()
        log.info("metrics server on http://%s:%d/metrics", self.host,
                 self.port)
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
