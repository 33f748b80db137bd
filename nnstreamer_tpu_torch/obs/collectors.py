"""Scrape-time collectors bridging live objects into the registry.

A copy of the JAX package's ``obs/collectors.py``. The per-element gauges
are sampled from each element's ``InvokeStats`` (the object behind the
``latency``/``throughput`` properties) rather than counted twice on the hot
path, so the exported numbers agree with the properties by construction.
The serving engine's cumulative stats and batch occupancy are sampled the
same way.
"""

from __future__ import annotations

import weakref

from nnstreamer_tpu_torch.obs.registry import MetricsRegistry, get_registry


def register_pipeline_collector(pipeline, registry: MetricsRegistry = None
                                ) -> None:
    """Export per-element latency/throughput/invoke gauges for every
    element of ``pipeline``, refreshed at each scrape. Holds only a
    weakref: a garbage-collected pipeline unregisters itself."""
    reg = registry or get_registry()
    ref = weakref.ref(pipeline)

    def collect():
        pipe = ref()
        if pipe is None:
            return False  # subject gone: drop this collector
        for el in pipe.elements:
            labels = {"pipeline": pipe.name, "element": el.name,
                      "type": el.ELEMENT_NAME}
            stats = el._metrics_stats()
            reg.gauge("nns_element_latency_us",
                      "Windowed avg invoke latency (µs), the element "
                      "latency property", **labels).set(stats.latency_us)
            reg.gauge("nns_element_throughput_milli",
                      "Outputs/sec x1000, the element throughput "
                      "property", **labels).set(stats.throughput_milli)
            reg.counter("nns_element_invokes_total",
                        "Cumulative chain invocations",
                        **labels).set_total(stats.total_invokes)
        return True

    reg.register_collector(collect)


def register_engine_collector(engine, registry: MetricsRegistry = None
                              ) -> None:
    """Export the serving engine's cumulative stats + occupancy gauges
    (weakref-bound like the pipeline collector)."""
    reg = registry or get_registry()
    ref = weakref.ref(engine)

    def collect():
        eng = ref()
        if eng is None:
            return False
        labels = {"engine": eng.obs_name}
        reg.gauge("nns_serving_active_streams",
                  "Streams currently holding a batch slot",
                  **labels).set(eng.active_streams)
        reg.gauge("nns_serving_batch_slots", "Configured batch slots (B)",
                  **labels).set(eng.B)
        slot_steps = eng.stats["slot_steps"]
        occupancy = (eng.stats["active_slot_steps"] / slot_steps
                     if slot_steps else 0.0)
        reg.gauge("nns_serving_batch_occupancy_ratio",
                  "Fraction of dispatched slot-steps that served a live "
                  "stream", **labels).set(occupancy)
        for key in ("tokens_generated", "dispatches", "prefills",
                    "prefill_chunks", "prefix_hits",
                    "prefix_tokens_reused"):
            reg.counter(f"nns_serving_{key}_total", **labels).set_total(
                eng.stats[key])
        return True

    reg.register_collector(collect)
