"""Scrape-time collectors bridging live objects into the registry.

A copy of the JAX package's ``obs/collectors.py``
(:func:`register_engine_collector` only): the serving engine's cumulative
stats and batch occupancy, sampled at each scrape rather than counted on
the hot path.
"""

from __future__ import annotations

import weakref

from nnstreamer_tpu_torch.obs.registry import MetricsRegistry, get_registry


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
