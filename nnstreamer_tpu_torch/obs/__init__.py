"""obs — process-wide metrics registry.

The counters, gauges and histograms of the JAX package's ``obs`` package
(``nns_<element>_<metric>{pipeline=..., element=...}``), carried over as
they are. The timeline, flight-recorder and export-server layers are not
ported yet (ROADMAP.md, queue A).
"""

from nnstreamer_tpu_torch.obs.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    LATENCY_BUCKETS_S,
    MetricsRegistry,
    get_registry,
)
