"""LM serving latency quantiles.

A copy of the JAX package's ``obs/flight.py`` (:class:`LMTokenStats`
only; the per-frame flight recorder waits for ROADMAP A.11b): the serving
engine's split of time-to-first-token from the inter-token interval, each
as streaming P² quantiles exported as registry gauges.
"""

from __future__ import annotations

import weakref

from nnstreamer_tpu_torch.obs.quantiles import P2Quantile
from nnstreamer_tpu_torch.obs.registry import get_registry


class LMTokenStats:
    """Per-token serving-latency quantiles for ONE decode engine —
    the flight recorder's LM-serving split: time-to-first-token (queue
    wait + prefill + first sample, the interactive-feel number) tracked
    separately from the steady-state inter-token interval (decode
    throughput per stream). Four P² estimators, no sample storage,
    exported as ``nns_lm_ttft_p50/p99_ms`` and
    ``nns_lm_token_p50/p99_ms`` gauges labeled by engine.

    Gauges read through a weakref so a dropped engine (and its stats)
    unregisters cleanly instead of pinning itself via the registry.
    """

    def __init__(self, engine: str):
        self._q = {
            "ttft": {"p50": P2Quantile(0.5), "p99": P2Quantile(0.99)},
            "token": {"p50": P2Quantile(0.5), "p99": P2Quantile(0.99)},
        }
        reg = get_registry()
        ref = weakref.ref(self)

        def _q_fn(name, which):
            def read():
                st = ref()
                if st is None:
                    return 0.0
                v = st._q[name][which].quantile()
                return (v or 0.0) * 1e3

            return read

        for which in ("p50", "p99"):
            reg.gauge(f"nns_lm_ttft_{which}_ms",
                      "time-to-first-token (submit -> first emitted "
                      "token), streaming quantile",
                      fn=_q_fn("ttft", which), engine=engine)
            reg.gauge(f"nns_lm_token_{which}_ms",
                      "steady-state inter-token interval per stream, "
                      "streaming quantile",
                      fn=_q_fn("token", which), engine=engine)

    def observe_ttft(self, seconds: float) -> None:
        self._q["ttft"]["p50"].observe(seconds)
        self._q["ttft"]["p99"].observe(seconds)

    def observe_token(self, seconds: float) -> None:
        self._q["token"]["p50"].observe(seconds)
        self._q["token"]["p99"].observe(seconds)
