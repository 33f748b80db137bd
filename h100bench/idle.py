"""The card's idle time in a traced run put down to the port's own
threads, and the host's CPU time a frame: the arithmetic of the thread
metrics. It reads, from a run's records:

- ``ctx.slice.idle``: the profiled slice's idle intervals, ``(start µs,
  end µs)`` on the profiler's clock, disjoint and sorted: the slice less
  the union of the device's intervals (:func:`idle_intervals`), so they
  sum to its wall time less its busy time;
- ``ctx.ledger_spans``: the frame ledger's records on the same clock, in
  µs, as ``(thread, kind, seq, start, end, track, args)``, recorded with
  the thread spans on (``Timeline.profiler_records`` of
  ``nnstreamer_tpu_torch/obs/timeline.py``, divided by 1,000);
- ``ctx.thread_cpu_s``: each pipeline thread's CPU seconds over the
  window (``nns_thread_cpu_seconds_total`` at its close less at its
  open), and ``ctx.window_frames``, the frames delivered in it.

Each idle instant of the slice goes to exactly one cause, tested in this
order: a ``gc`` span open on any thread (the collecting thread holds the
interpreter lock); the launching thread (the one whose ring holds the
fused region's ``device`` spans) in ``wait_output`` or ``fence_wait``
(back-pressure); the launching thread in ``wait_input`` (starved:
nothing to launch, upstream sets the pace); else the launching thread is
working (dispatch: the staging upload, the replay's enqueue, the window's
admit and the Python between). The four shares of the slice's wall time
sum to ``device_idle_share``.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Span = Tuple[float, float]

#: the four causes, in the order they are tested
CAUSES = ("idle_gc_share", "idle_backpressure_share", "idle_starved_share",
          "idle_dispatch_share")
#: the element whose exclusive chain time ``convert_ms`` reads: an
#: element named by the launch string's auto-naming, ``tensor_converter<n>``
CONVERTER = "tensor_converter"
WAITS = ("wait_input", "wait_output")


def merge(spans: Iterable[Span]) -> List[Span]:
    """The union of ``spans`` as disjoint sorted spans (empty ones out)."""
    out: List[Span] = []
    for a, b in sorted(s for s in spans if s[1] > s[0]):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def length(spans: Sequence[Span]) -> float:
    return sum(b - a for a, b in spans)


def intersect(x: Sequence[Span], y: Sequence[Span]) -> List[Span]:
    """The intersection of two disjoint sorted span lists."""
    out: List[Span] = []
    i = j = 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(x: Sequence[Span], y: Sequence[Span]) -> List[Span]:
    """``x`` less ``y``, both disjoint and sorted."""
    out: List[Span] = []
    j = 0
    for a, b in x:
        while j < len(y) and y[j][1] <= a:
            j += 1
        k = j
        while k < len(y) and y[k][0] < b:
            if y[k][0] > a:
                out.append((a, y[k][0]))
            a = max(a, y[k][1])
            k += 1
        if a < b:
            out.append((a, b))
    return out


def idle_intervals(busy: Iterable[Span], t0: float, t1: float) -> List[Span]:
    """``[t0, t1)`` less the union of the device's ``busy`` intervals."""
    return subtract([(t0, t1)], merge(busy))


def launching_thread(spans: Iterable[tuple]) -> Optional[str]:
    """The thread that recorded the most ``device`` spans."""
    counts: Dict[str, int] = {}
    for thread, kind, *_ in spans:
        if kind == "device":
            counts[thread] = counts.get(thread, 0) + 1
    return max(counts, key=counts.get) if counts else None


def idle_causes(idle: Sequence[Span], spans: Sequence[tuple]
                ) -> Optional[Dict[str, float]]:
    """µs of ``idle`` that go to each of :data:`CAUSES`; None without a
    launching thread."""
    launcher = launching_thread(spans)
    if launcher is None:
        return None
    gc, back, starved = [], [], []
    for thread, kind, _seq, a, b, _track, _args in spans:
        if b is None:
            continue
        if kind == "gc":
            gc.append((a, b))
        elif thread == launcher:
            if kind in ("wait_output", "fence_wait"):
                back.append((a, b))
            elif kind == "wait_input":
                starved.append((a, b))
    left = merge(idle)
    out = {}
    for name, cause in zip(CAUSES, (gc, back, starved)):
        hit = intersect(left, merge(cause))
        out[name] = length(hit)
        left = subtract(left, hit)
    out[CAUSES[-1]] = length(left)
    return out


def idle_shares(ctx) -> Optional[Dict[str, float]]:
    """Each of :data:`CAUSES` as a share of the slice's wall time, in %;
    None where the run has no slice, no idle intervals or no ledger, or
    where ``device_idle_share`` reads nothing (no device time in it)."""
    sl = ctx.slice
    spans = getattr(ctx, "ledger_spans", None)
    idle = getattr(sl, "idle", None)
    if sl is None or idle is None or not spans or sl.wall_us <= 0 or \
            sl.busy_us <= 0:
        return None
    us = idle_causes(idle, spans)
    if us is None:
        return None
    return {k: 100.0 * v / sl.wall_us for k, v in us.items()}


def thread_cover(spans: Sequence[tuple], t0: float, t1: float,
                 kinds: Sequence[str] = WAITS + ("gc", "chain")
                 ) -> Dict[str, float]:
    """Each thread's share of ``[t0, t1)`` under its own spans of
    ``kinds``: by default how much of its time the thread spans name."""
    by_thread: Dict[str, List[Span]] = {}
    for thread, kind, _seq, a, b, _track, _args in spans:
        if b is not None and kind in kinds:
            by_thread.setdefault(thread, []).append((a, b))
    return {t: length(intersect(merge(v), [(t0, t1)])) / (t1 - t0)
            for t, v in sorted(by_thread.items())}


def hot_thread_cpu_ms_per_frame(ctx) -> Optional[float]:
    """The busiest pipeline thread's CPU ms in the window over the frames
    delivered in it."""
    cpu = getattr(ctx, "thread_cpu_s", None)
    if not cpu or not ctx.window_frames:
        return None
    return max(cpu.values()) * 1e3 / ctx.window_frames


def exclusive_chain_ms(spans: Sequence[tuple], prefix: str = CONVERTER
                       ) -> Optional[float]:
    """Mean ms a call of the elements named ``prefix<n>`` spends in their
    own ``chain`` spans less the ``chain`` and ``wait_*`` spans nested in
    them on the same thread; None without such a span."""
    by_thread: Dict[str, List[Span]] = {}
    mine: List[Tuple[str, float, float]] = []
    for thread, kind, _seq, a, b, _track, args in spans:
        if b is None or not (kind == "chain" or kind in WAITS):
            continue
        by_thread.setdefault(thread, []).append((a, b))
        name = (args or {}).get("element", "")
        if kind == "chain" and name.startswith(prefix) and \
                name[len(prefix):].isdigit():
            mine.append((thread, a, b))
    if not mine:
        return None
    for v in by_thread.values():
        v.sort()
    total = 0.0
    for thread, a, b in mine:
        inner = by_thread[thread]
        lo = bisect.bisect_left(inner, (a, a))
        nested = [s for s in inner[lo:bisect.bisect_right(inner, (b, b))]
                  if s != (a, b) and s[1] <= b]
        total += (b - a) - length(merge(nested))
    return total / len(mine) / 1e3
