"""Streaming quantile estimation and SLO burn-rate windows.

A copy of the JAX package's ``obs/quantiles.py`` (no JAX in it). The
flight recorder (``obs/flight.py``) runs on every frame of every
pipeline, always — it cannot afford the Timeline's approach of keeping
raw samples and sorting at report time, and it cannot afford the
histogram's fixed buckets (a 50 µs stage and a 5 s stall must both
resolve). This module provides the two bounded-memory estimators it
needs:

- :class:`P2Quantile` — the P² (piecewise-parabolic) algorithm of Jain
  & Chlamtac (1985): one quantile tracked with FIVE stored markers,
  O(1) per observation, no sample storage. Accuracy is within a few
  percent of the exact order statistic on smooth distributions and
  degrades gracefully on multi-modal ones (the marker heights settle on
  the mode containing the target rank).
- :class:`BurnRateWindow` — a sliding-window SLO burn rate in the
  multi-window alerting sense: the fraction of completions that
  breached the budget inside the window, divided by the error budget
  (1 - target). A burn rate of 1.0 means the pipeline is consuming its
  error budget exactly at the sustainable rate; the flight recorder
  pairs a fast and a slow window and warns only when BOTH exceed the
  threshold (a fast-only spike is noise, a slow-only excess is an old
  incident).

Both are internally locked: the flight recorder feeds them from sink /
lane / queue threads concurrently and exports them from the metrics
scrape thread.
"""

from __future__ import annotations

import bisect
import threading
from collections import deque
from typing import List, Optional


class P2Quantile:
    """One streaming quantile via the P² algorithm — five markers, no
    sample storage, O(1) per observation.

    ``observe()`` feeds a value; ``quantile()`` reads the current
    estimate (exact while fewer than five observations have arrived,
    the middle marker afterwards). Thread-safe.
    """

    __slots__ = ("p", "_lock", "_count",
                 "_heights", "_pos", "_want", "_dwant")

    def __init__(self, p: float):
        if not 0.0 < p < 1.0:
            raise ValueError(f"quantile p must be in (0, 1), got {p}")
        self.p = float(p)
        self._lock = threading.Lock()
        self._count = 0
        #: first five observations (sorted), then the five marker heights
        self._heights: List[float] = []
        self._pos: List[float] = []
        self._want: List[float] = []
        self._dwant = (0.0, self.p / 2.0, self.p,
                       (1.0 + self.p) / 2.0, 1.0)

    # -- recording -----------------------------------------------------------
    def observe(self, x: float) -> None:
        x = float(x)
        with self._lock:
            self._observe_locked(x)

    def _observe_locked(self, x: float) -> None:
        n = self._count
        self._count = n + 1
        h = self._heights
        if n < 5:
            # warm-up: exact storage of the first five observations,
            # bounded by construction (this branch only runs while the
            # list holds fewer than five values)
            bisect.insort(h, x)  # nns-lint: disable=NNS114 -- bounded: P² stores exactly five marker heights
            if n == 4:
                self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
                self._want = [1.0 + 4.0 * d for d in self._dwant]
            return
        # locate the cell k containing x, clamping the extremes
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            for i in range(1, 4):
                if x >= h[i]:
                    k = i
        pos, want = self._pos, self._want
        for i in range(k + 1, 5):
            pos[i] += 1.0
        for i in range(5):
            want[i] += self._dwant[i]
        # adjust the three interior markers toward their desired ranks
        for i in (1, 2, 3):
            d = want[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or \
                    (d <= -1.0 and pos[i - 1] - pos[i] < -1.0):
                s = 1.0 if d > 0 else -1.0
                cand = self._parabolic(i, s)
                if not (h[i - 1] < cand < h[i + 1]):
                    cand = self._linear(i, s)
                h[i] = cand
                pos[i] += s

    def _parabolic(self, i: int, s: float) -> float:
        h, n = self._heights, self._pos
        return h[i] + s / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + s) * (h[i + 1] - h[i])
            / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - s) * (h[i] - h[i - 1])
            / (n[i] - n[i - 1]))

    def _linear(self, i: int, s: float) -> float:
        h, n = self._heights, self._pos
        j = i + int(s)
        return h[i] + s * (h[j] - h[i]) / (n[j] - n[i])

    # -- reading -------------------------------------------------------------
    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def quantile(self) -> Optional[float]:
        """Current estimate; ``None`` before the first observation."""
        with self._lock:
            n = self._count
            if n == 0:
                return None
            if n <= 5:
                # exact order statistic while the warm-up buffer is all
                # we have (heights are kept sorted during warm-up)
                idx = min(n - 1, int(round(self.p * (n - 1))))
                return self._heights[idx]
            return self._heights[2]

    # -- serving continuity --------------------------------------------------
    def snapshot(self) -> dict:
        """The complete serializable marker state — restoring it into a
        fresh instance of the same ``p`` resumes the estimate exactly
        where the previous process left it (warm-up included)."""
        with self._lock:
            return {
                "count": self._count,
                "heights": list(self._heights),
                "pos": list(self._pos),
                "want": list(self._want),
            }

    def restore(self, state: dict) -> None:
        with self._lock:
            self._count = int(state["count"])
            self._heights = [float(v) for v in state["heights"]]
            self._pos = [float(v) for v in state["pos"]]
            self._want = [float(v) for v in state["want"]]


def _snapshot_cdf_points(snap: dict) -> Optional[tuple]:
    """Reduce one P² snapshot to piecewise-linear CDF support points
    ``(count, heights, cum_probs)``; ``None`` for an empty snapshot.

    Warm-up snapshots (count ≤ 5) hold exact sorted samples, so each
    sample sits at its mid-rank. Converged snapshots hold five markers
    whose ``pos`` entries are the marker's cumulative sample rank, so
    marker *i* approximates the ``(pos[i] - 0.5) / count`` quantile.
    """
    n = int(snap.get("count", 0))
    if n <= 0:
        return None
    heights = [float(v) for v in snap.get("heights", [])]
    if not heights:
        return None
    pos = [float(v) for v in snap.get("pos", [])]
    if n <= 5 or len(heights) < 5 or len(pos) < 5:
        heights = sorted(heights)
        probs = [(i + 0.5) / len(heights) for i in range(len(heights))]
        return n, heights, probs
    pairs = sorted(zip(heights, pos))
    hs: List[float] = []
    ps: List[float] = []
    run = 0.0
    for h, q in pairs:
        prob = min(1.0, max(0.0, (q - 0.5) / n))
        run = max(run, prob)  # CDF must be nondecreasing in both axes
        hs.append(h)
        ps.append(run)
    return n, hs, ps


def _cdf_eval(heights: List[float], probs: List[float], x: float) -> float:
    if x < heights[0]:
        return 0.0
    if x >= heights[-1]:
        return 1.0
    for i in range(len(heights) - 1):
        h0, h1 = heights[i], heights[i + 1]
        if h0 <= x <= h1:
            if h1 <= h0:
                return probs[i + 1]
            t = (x - h0) / (h1 - h0)
            return probs[i] + t * (probs[i + 1] - probs[i])
    return probs[-1]


def merge_p2_snapshots(snapshots: List[dict], p: float) -> Optional[float]:
    """Merge serialized :meth:`P2Quantile.snapshot` states from N
    independent processes into one fleet-level quantile estimate.

    Each snapshot's five markers define a piecewise-linear CDF through
    the marker heights at their cumulative ranks; the merged estimate
    inverts the count-weighted mixture of those CDFs at ``p``. This is
    the "marker merge" the federation layer uses: replicas ship marker
    state (40 bytes of floats), never raw samples, and the aggregate
    stays within P²-class accuracy of the pooled-sample exact quantile.
    Returns ``None`` when every snapshot is empty.
    """
    if not 0.0 < p < 1.0:
        raise ValueError(f"quantile p must be in (0, 1), got {p}")
    parts = []
    total = 0
    for snap in snapshots:
        pts = _snapshot_cdf_points(snap)
        if pts is None:
            continue
        parts.append(pts)
        total += pts[0]
    if total == 0:
        return None

    def mixture(x: float) -> float:
        acc = 0.0
        for n, hs, ps in parts:
            acc += n * _cdf_eval(hs, ps, x)
        return acc / total

    lo = min(hs[0] for _, hs, _ in parts)
    hi = max(hs[-1] for _, hs, _ in parts)
    if hi <= lo:
        return lo
    # the mixture CDF is monotone: invert by bisection on the value axis
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        if mixture(mid) < p:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


class BurnRateWindow:
    """Sliding-window SLO burn rate over completion events.

    ``add(t, breached)`` records one completion; ``rate(now)`` returns
    ``breach_fraction / error_budget`` over the trailing ``window_s``
    seconds — 1.0 means the error budget is being consumed exactly at
    the sustainable rate, >1 means faster. The event deque is doubly
    bounded: by time (eviction at read and write) and by ``cap``
    entries, so a runaway completion rate cannot grow it.
    """

    def __init__(self, window_s: float, error_budget: float = 0.01,
                 cap: int = 4096):
        self.window_s = float(window_s)
        self.error_budget = max(float(error_budget), 1e-9)
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=int(cap))
        self._breaches = 0

    def _evict_locked(self, now: float) -> None:
        horizon = now - self.window_s
        ev = self._events
        while ev and ev[0][0] < horizon:
            _, breached = ev.popleft()
            if breached:
                self._breaches -= 1

    def add(self, t: float, breached: bool) -> None:
        with self._lock:
            if len(self._events) == self._events.maxlen:
                # cap eviction: keep the running breach count honest
                _, old = self._events[0]
                if old:
                    self._breaches -= 1
            self._events.append((float(t), bool(breached)))
            if breached:
                self._breaches += 1
            self._evict_locked(float(t))

    def rate(self, now: float) -> float:
        with self._lock:
            self._evict_locked(float(now))
            n = len(self._events)
            if n == 0:
                return 0.0
            return (self._breaches / n) / self.error_budget

    def sample_count(self, now: float) -> int:
        with self._lock:
            self._evict_locked(float(now))
            return len(self._events)
