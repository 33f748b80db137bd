"""obs — process-wide metrics registry.

The counters, gauges and histograms of the JAX package's ``obs`` package
(``nns_<element>_<metric>{pipeline=..., element=...}``), carried over as
they are. ``quantiles.P2Quantile``, ``flight.LMTokenStats`` and
``collectors.register_engine_collector`` carry the serving engine's
metrics; ``collectors.register_pipeline_collector`` (registered by every
``Pipeline``) the per-element latency, throughput and invoke series. ``timeline`` is the frame ledger (per-frame spans across lanes,
queues, the dispatch window and transfers; ``NNSTPU_TRACE``);
``flight.FlightRecorder`` is the always-on recorder every pipeline
installs on that ledger (``NNSTPU_FLIGHT``); ``server.MetricsServer``
serves the registry over HTTP (Prometheus text and JSON), and with a
``distributed.FederatedMetrics`` the merged view of a fleet's replicas;
``distributed`` also carries a frame's trace across the query hop.
``lockgraph`` is the runtime lock-order witness (``NNSTPU_LOCKGRAPH``),
armed here before any other module of the package creates a lock.
"""

# FIRST import, before any sibling that creates module-level locks
# (the metrics registry, the flight recorder): when NNSTPU_LOCKGRAPH is
# set the lock factories must already be patched by the time those
# locks are created, or the witness misses them
from nnstreamer_tpu_torch.obs import lockgraph  # noqa: F401
lockgraph.maybe_activate_env()

from nnstreamer_tpu_torch.obs.registry import (  # noqa: E402,F401
    Counter,
    Gauge,
    Histogram,
    LATENCY_BUCKETS_S,
    MetricsRegistry,
    get_registry,
)
from nnstreamer_tpu_torch.obs.timeline import (  # noqa: F401
    TRACE_SEQ_META,
    Timeline,
    profiler_correlation,
    trace_enabled,
    tracing,
)
from nnstreamer_tpu_torch.obs.server import MetricsServer  # noqa: F401,E402
