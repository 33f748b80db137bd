"""Arithmetic the end-to-end readers share: quantiles of the window's
latencies."""

from __future__ import annotations

from typing import List

import numpy as np


def quantile(values: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def latencies_ms(ctx) -> List[float]:
    """Due time to arrival, in ms, of every frame of an open loop due
    inside the window that arrived, in due order; empty in a closed
    loop."""
    if not ctx.open_loop:
        return []
    return [(arrival - due) * 1e3 for due, arrival in ctx.window
            if arrival is not None]


def latency_quantile(ctx, q: float):
    lat = latencies_ms(ctx)
    return quantile(lat, q) if lat else None
