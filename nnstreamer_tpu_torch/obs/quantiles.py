"""Streaming quantile estimation: the P² algorithm.

A copy of the JAX package's ``obs/quantiles.py`` (:class:`P2Quantile`
only; its SLO burn-rate window waits for the flight recorder, ROADMAP
A.11). :class:`P2Quantile` is the P² (piecewise-parabolic) algorithm of
Jain & Chlamtac (1985): one quantile tracked with FIVE stored markers,
O(1) per observation, no sample storage. Accuracy is within a few percent
of the exact order statistic on smooth distributions. It is internally
locked: the serving engine feeds it from its loop thread while a metrics
scrape reads it.
"""

from __future__ import annotations

import bisect
import threading
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
            bisect.insort(h, x)
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
