"""Thread-safe metrics registry: Counter / Gauge / Histogram primitives.

Design notes (who calls what, and from which thread):

- Hot paths (element ``chain``, queue worker, serving loop) hold a
  reference to their metric object and call ``inc``/``set``/``observe``
  — one short per-metric lock, no registry lookup per frame.
- Collectors are callables run at scrape time (``collect()``); they pull
  values out of live objects (e.g. each element's ``InvokeStats``) so
  sampled gauges always agree with the in-band properties. A collector
  returning ``False`` is dropped — the weakref-to-pipeline pattern.
- One metric identity = (name, sorted labels). Re-requesting it returns
  the same object (get-or-create), so instrumentation code never needs
  to coordinate creation.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

#: default latency buckets (seconds) — spans µs-scale host hops to the
#: multi-second first-compile outliers a TPU pipeline actually produces
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    100e-6, 250e-6, 500e-6, 1e-3, 2.5e-3, 5e-3, 10e-3, 25e-3, 50e-3,
    100e-3, 250e-3, 500e-3, 1.0, 2.5, 5.0, 10.0,
)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: Dict[str, str], extra: Optional[Dict[str, str]] = None
                ) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(items.items()))
    return "{" + body + "}"


class _Metric:
    KIND = "untyped"

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = {str(k): str(v) for k, v in labels.items()}
        self._lock = threading.Lock()


class Counter(_Metric):
    """Monotonically increasing count."""

    KIND = "counter"

    def __init__(self, name: str, labels: Dict[str, str]):
        super().__init__(name, labels)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters only go up (got {n})")
        with self._lock:
            self._value += n

    def set_total(self, value: float) -> None:
        """Collector-side absolute update from an external monotonic
        source (e.g. ``InvokeStats.total_invokes``); never decreases."""
        with self._lock:
            if value > self._value:
                self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Metric):
    """Point-in-time value; optionally backed by a callable sampled at
    collection time (``fn``)."""

    KIND = "gauge"

    def __init__(self, name: str, labels: Dict[str, str],
                 fn: Optional[Callable[[], float]] = None):
        super().__init__(name, labels)
        self._value = 0.0
        self.fn = fn

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        if self.fn is not None:
            try:
                return float(self.fn())
            except Exception:  # noqa: BLE001 — a dead callback reads 0,
                # it must not poison the whole scrape
                return 0.0
        with self._lock:
            return self._value


class Histogram(_Metric):
    """Fixed-bucket histogram (Prometheus cumulative-bucket semantics).

    Buckets are upper bounds in ascending order; an implicit +Inf bucket
    catches the tail. ``percentile(q)`` interpolates linearly inside the
    winning bucket — the same estimate a PromQL ``histogram_quantile``
    would produce, available in-process for the post-EOS tables.
    """

    KIND = "histogram"

    def __init__(self, name: str, labels: Dict[str, str],
                 buckets: Iterable[float] = LATENCY_BUCKETS_S):
        super().__init__(name, labels)
        self.bounds: Tuple[float, ...] = tuple(sorted(float(b)
                                                      for b in buckets))
        if not self.bounds:
            raise ValueError(f"{name}: histogram needs >= 1 bucket bound")
        self._counts = [0] * (len(self.bounds) + 1)  # +Inf tail slot
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def bucket_counts(self) -> List[Tuple[float, int]]:
        """Cumulative (upper_bound, count) pairs, +Inf last."""
        with self._lock:
            counts = list(self._counts)
        out, acc = [], 0
        for bound, n in zip(self.bounds, counts):
            acc += n
            out.append((bound, acc))
        out.append((float("inf"), acc + counts[-1]))
        return out

    def percentile(self, q: float) -> Optional[float]:
        """Estimated q-th percentile (0-100); None when empty."""
        cum = self.bucket_counts()
        total = cum[-1][1]
        if total == 0:
            return None
        rank = (q / 100.0) * total
        prev_bound, prev_cum = 0.0, 0
        for bound, c in cum:
            if c >= rank:
                if bound == float("inf"):
                    return prev_bound  # open-ended tail: lower bound
                if c == prev_cum:
                    return bound
                frac = (rank - prev_cum) / (c - prev_cum)
                return prev_bound + frac * (bound - prev_bound)
            prev_bound, prev_cum = bound, c
        return self.bounds[-1]


class MetricsRegistry:
    """Process-wide metric store + collector hooks + exporters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple], _Metric] = {}
        self._kinds: Dict[str, str] = {}
        self._help: Dict[str, str] = {}
        self._collectors: List[Callable[[], Any]] = []

    # -- get-or-create ------------------------------------------------------
    def _get_or_create(self, cls, name: str, help_: str, labels: dict,
                       **kw) -> _Metric:
        key = (name, _label_key(labels))
        with self._lock:
            existing = self._metrics.get(key)
            if existing is not None:
                if existing.KIND != cls.KIND:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.KIND}, not {cls.KIND}")
                return existing
            kind = self._kinds.get(name)
            if kind is not None and kind != cls.KIND:
                raise ValueError(
                    f"metric name {name!r} already used for kind {kind}")
            m = cls(name, labels, **kw)
            self._metrics[key] = m
            self._kinds[name] = cls.KIND
            if help_:
                self._help.setdefault(name, help_)
            return m

    def counter(self, name: str, help_: str = "", **labels) -> Counter:
        return self._get_or_create(Counter, name, help_, labels)

    def gauge(self, name: str, help_: str = "",
              fn: Optional[Callable[[], float]] = None, **labels) -> Gauge:
        g = self._get_or_create(Gauge, name, help_, labels, fn=fn)
        if fn is not None:
            g.fn = fn  # re-binding a callback gauge refreshes the source
        return g

    def histogram(self, name: str, help_: str = "",
                  buckets: Iterable[float] = LATENCY_BUCKETS_S,
                  **labels) -> Histogram:
        return self._get_or_create(Histogram, name, help_, labels,
                                   buckets=buckets)

    def get(self, name: str, **labels) -> Optional[_Metric]:
        """Look up an existing metric; None when absent."""
        with self._lock:
            return self._metrics.get((name, _label_key(labels)))

    # -- collectors ---------------------------------------------------------
    def register_collector(self, fn: Callable[[], Any]) -> None:
        """Register a scrape-time callback. Returning ``False`` (exactly)
        unregisters it — collectors holding weakrefs use this to clean
        up after their subject dies."""
        with self._lock:
            self._collectors.append(fn)

    def unregister_collector(self, fn: Callable[[], Any]) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def _run_collectors(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        dead = []
        for fn in collectors:
            try:
                if fn() is False:
                    dead.append(fn)
            except Exception:  # noqa: BLE001 — one broken collector must
                # not take down the scrape endpoint
                dead.append(fn)
        if dead:
            with self._lock:
                self._collectors = [c for c in self._collectors
                                    if c not in dead]

    def collect(self) -> List[_Metric]:
        """Run collectors, then return all metrics (stable order)."""
        self._run_collectors()
        with self._lock:
            return [self._metrics[k] for k in sorted(
                self._metrics, key=lambda k: (k[0], k[1]))]

    # -- exporters ----------------------------------------------------------
    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        seen_header = set()
        for m in self.collect():
            if m.name not in seen_header:
                seen_header.add(m.name)
                help_ = self._help.get(m.name)
                if help_:
                    lines.append(f"# HELP {m.name} {help_}")
                lines.append(f"# TYPE {m.name} {m.KIND}")
            if isinstance(m, Histogram):
                for bound, c in m.bucket_counts():
                    le = "+Inf" if bound == float("inf") else repr(bound)
                    lines.append(
                        f"{m.name}_bucket"
                        f"{_fmt_labels(m.labels, {'le': le})} {c}")
                lines.append(
                    f"{m.name}_sum{_fmt_labels(m.labels)} {m.sum}")
                lines.append(
                    f"{m.name}_count{_fmt_labels(m.labels)} {m.count}")
            else:
                v = m.value
                out = repr(v) if isinstance(v, float) and not v.is_integer()\
                    else str(int(v))
                lines.append(f"{m.name}{_fmt_labels(m.labels)} {out}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able snapshot of every metric."""
        metrics: List[dict] = []
        for m in self.collect():
            entry: Dict[str, Any] = {
                "name": m.name, "type": m.KIND, "labels": m.labels,
            }
            if isinstance(m, Histogram):
                entry["count"] = m.count
                entry["sum"] = m.sum
                entry["buckets"] = [
                    ["+Inf" if b == float("inf") else b, c]
                    for b, c in m.bucket_counts()]
                entry["p50"] = m.percentile(50)
                entry["p99"] = m.percentile(99)
            else:
                entry["value"] = m.value
            metrics.append(entry)
        wall_ts = time.time()  # export timestamp: epoch seconds on the wire
        return {"ts": wall_ts, "metrics": metrics}

    def reset(self) -> None:
        """Drop every metric and collector (test isolation only: live
        instrumented objects keep references to detached metrics until
        they re-create them)."""
        with self._lock:
            self._metrics.clear()
            self._kinds.clear()
            self._help.clear()
            self._collectors.clear()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry."""
    return _REGISTRY
