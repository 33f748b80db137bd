"""obs — process-wide metrics registry.

The counters, gauges and histograms of the JAX package's ``obs`` package
(``nns_<element>_<metric>{pipeline=..., element=...}``), carried over as
they are. ``quantiles.P2Quantile``, ``flight.LMTokenStats`` and
``collectors.register_engine_collector`` carry the serving engine's
metrics. The timeline, the per-frame flight recorder and the export
server are not ported yet (ROADMAP.md, A.11).
"""

from nnstreamer_tpu_torch.obs.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    LATENCY_BUCKETS_S,
    MetricsRegistry,
    get_registry,
)
