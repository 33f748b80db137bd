"""Runtime latency/throughput instrumentation.

The reference measures itself around every filter invoke
(``prepare_statistics``/``record_statistics``, tensor_filter.c:325-423):
a window of recent invoke latencies (avg over the last ~10 exposed as the
``latency`` property, µs) and a throughput estimate (outputs/sec ×1000,
``throughput`` property), plus cumulative per-framework counters
(``GstTensorFilterFrameworkStatistics``, nnstreamer_plugin_api_filter.h:
162-174). This module is the same capability for every element: call
:meth:`InvokeStats.record` around the hot call and read ``latency_us`` /
``throughput_milli`` at any time.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Deque, Optional, Tuple


class InvokeStats:
    """Windowed latency + throughput tracker (thread-safe).

    ``window`` mirrors the reference's recent-sample window; samples older
    than ``max_age_s`` are dropped from the throughput estimate the way the
    reference prunes stale entries (tensor_filter.c:407-417).
    """

    def __init__(self, window: int = 10, max_age_s: float = 10.0):
        self.window = window
        self.max_age_s = max_age_s
        self._lat: Deque[float] = collections.deque(maxlen=window)
        self._stamps: Deque[float] = collections.deque()
        self._lock = threading.Lock()
        self.total_invokes = 0
        self.total_latency_s = 0.0

    def measure(self):
        """Context manager measuring one invoke."""
        return _Measure(self)

    def record(self, latency_s: float, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._lat.append(latency_s)
            self._stamps.append(now)
            cutoff = now - self.max_age_s
            while self._stamps and self._stamps[0] < cutoff:
                self._stamps.popleft()
            self.total_invokes += 1
            self.total_latency_s += latency_s

    # -- reference-named read-outs ------------------------------------------
    @property
    def latency_us(self) -> int:
        """Average invoke latency in µs over the recent window (reference
        ``latency`` property)."""
        with self._lock:
            if not self._lat:
                return 0
            return int(sum(self._lat) / len(self._lat) * 1e6)

    @property
    def throughput_milli(self) -> int:
        """Outputs/sec ×1000 over the recent window (reference ``throughput``
        property)."""
        with self._lock:
            n = len(self._stamps)
            if n < 2:
                return 0
            span = self._stamps[-1] - self._stamps[0]
            if span <= 0:
                return 0
            return int((n - 1) / span * 1000)

    def snapshot(self) -> dict:
        # read the properties outside the lock — they acquire it themselves
        # (the lock is non-reentrant)
        return {
            "latency_us": self.latency_us,
            "throughput_milli": self.throughput_milli,
            "total_invokes": self.total_invokes,
            "total_latency_s": self.total_latency_s,
        }


class _Measure:
    def __init__(self, stats: InvokeStats):
        self.stats = stats
        self.t0 = 0.0

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        now = time.monotonic()
        self.stats.record(now - self.t0, now)
        return False
