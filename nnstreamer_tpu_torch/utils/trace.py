"""Tracing / profiling — per-element tracers + CUDA profiler integration.

Port of ``nnstreamer_tpu/utils/trace.py``: :class:`Tracer` is a copy;
``xla_profile`` becomes :func:`cuda_profile` over ``torch.profiler``.

Reference: no in-tree tracer; relies on GStreamer tracer hooks consumed by
GstShark (proctime / interlatency / framerate tracers,
tools/tracing/README.md) plus per-filter latency properties. Here tracing
is in-tree (SURVEY §5 asks for exactly this):

- :class:`Tracer` attaches to a pipeline and records, per buffer:
  **proctime** (element chain duration), **interlatency** (source pts →
  element arrival), and **framerate** per element — the three GstShark
  tracers the reference's docs describe.
- Export as Chrome trace-event JSON (``chrome://tracing`` /
  Perfetto-loadable) or aggregate dicts.
- :func:`cuda_profile` wraps ``torch.profiler`` (CPU and, with a card,
  CUDA activity) so device-side traces land next to the host-side ones.

Usage::

    tracer = Tracer()
    with tracer.attach(pipe):
        pipe.run()
    tracer.summary()         # {element: {proctime_us_avg, fps, ...}}
    tracer.export_chrome("trace.json")
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Dict, List, Optional

from nnstreamer_tpu_torch.pipeline.element import Element
from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline


class Tracer:
    def __init__(self, max_events: int = 100_000):
        self.events: List[dict] = []
        self.max_events = max_events
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        # first time each pts was seen anywhere in the pipeline — the
        # baseline for the interlatency metric (source → element delay)
        self._first_seen: Dict[int, float] = {}

    # -- hook installation ---------------------------------------------------
    @contextlib.contextmanager
    def attach(self, pipeline: Pipeline):
        """Wrap every element's chain entry with trace recording."""
        wrapped = []
        for el in pipeline.elements:
            el._chain_entry = self._wrap(el, el._chain_entry)
            wrapped.append(el)
        try:
            yield self
        finally:
            for el in wrapped:
                # drop the instance attribute so the class method resolves
                # again (no permanent shadowing)
                el.__dict__.pop("_chain_entry", None)
            # stream over (EOS or abandoned): every surviving baseline
            # belongs to a finished run — a reattach starts fresh
            with self._lock:
                self._first_seen.clear()

    def _wrap(self, el: Element, fn):
        is_sink = not el.srcpads  # terminal element: frames complete here

        def traced(pad, buf):
            t_in = time.monotonic()
            interlat_us = None
            if buf.pts is not None:
                with self._lock:
                    first = self._first_seen.setdefault(buf.pts, t_in)
                    if len(self._first_seen) > 16384:  # backstop bound
                        self._first_seen.pop(next(iter(self._first_seen)))
                interlat_us = (t_in - first) * 1e6
            ret = fn(pad, buf)
            t_out = time.monotonic()
            self._record(el.name, t_in, t_out, buf.pts, interlat_us)
            if is_sink and buf.pts is not None:
                # the frame completed — retire its baseline so the
                # backstop above only ever evicts truly-lost frames;
                # evicting oldest-INSERTED regardless of completion
                # churned live baselines on long runs and skewed
                # interlatency toward zero
                with self._lock:
                    self._first_seen.pop(buf.pts, None)
            return ret

        return traced

    def _record(self, name: str, t_in: float, t_out: float,
                pts: Optional[int], interlat_us: Optional[float] = None):
        with self._lock:
            if len(self.events) >= self.max_events:
                return
            self.events.append({
                "element": name,
                "ts_us": (t_in - self._t0) * 1e6,
                "dur_us": (t_out - t_in) * 1e6,
                "pts": pts,
                "interlatency_us": interlat_us,
            })

    # -- outputs -------------------------------------------------------------
    def summary(self) -> Dict[str, dict]:
        """Per-element proctime/framerate aggregates (GstShark metrics)."""
        agg: Dict[str, dict] = {}
        with self._lock:
            events = list(self.events)
        for ev in events:
            a = agg.setdefault(ev["element"], {
                "count": 0, "proctime_us_total": 0.0, "first_ts": ev["ts_us"],
                "last_ts": ev["ts_us"], "interlatency_us_total": 0.0,
                "interlatency_n": 0,
            })
            a["count"] += 1
            a["proctime_us_total"] += ev["dur_us"]
            a["last_ts"] = ev["ts_us"]
            if ev.get("interlatency_us") is not None:
                a["interlatency_us_total"] += ev["interlatency_us"]
                a["interlatency_n"] += 1
        for name, a in agg.items():
            a["proctime_us_avg"] = a["proctime_us_total"] / max(a["count"], 1)
            span_s = (a["last_ts"] - a["first_ts"]) / 1e6
            a["fps"] = (a["count"] - 1) / span_s if span_s > 0 else 0.0
            a["interlatency_us_avg"] = (
                a["interlatency_us_total"] / a["interlatency_n"]
                if a["interlatency_n"] else 0.0
            )
        return agg

    def export_chrome(self, path: str) -> None:
        """Chrome trace-event format (load in chrome://tracing/Perfetto).

        Each invoke is a ``ph:"X"`` slice carrying ``pts`` and
        ``interlatency_us`` as args; per-pts flow events (``s``/``t``/
        ``f``) chain a frame's slices across element tracks so Perfetto
        can follow one frame through the pipeline."""
        with self._lock:
            events = list(self.events)
        tids = {name: i for i, name in enumerate(
            sorted({ev["element"] for ev in events}))}
        trace: List[dict] = []
        flows: Dict[int, List[tuple]] = {}
        for ev in events:
            args: dict = {"pts": ev["pts"]}
            if ev.get("interlatency_us") is not None:
                args["interlatency_us"] = round(ev["interlatency_us"], 3)
            trace.append({
                "name": ev["element"],
                "cat": "element",
                "ph": "X",
                "ts": ev["ts_us"],
                "dur": ev["dur_us"],
                "pid": 1,
                "tid": tids[ev["element"]],
                "args": args,
            })
            if ev["pts"] is not None:
                flows.setdefault(ev["pts"], []).append(
                    (ev["ts_us"], tids[ev["element"]]))
        for pts, hops in flows.items():
            if len(hops) < 2:
                continue  # a frame seen on one track has nothing to link
            hops.sort()
            for i, (ts, tid) in enumerate(hops):
                ph = "s" if i == 0 else ("f" if i == len(hops) - 1 else "t")
                flow = {"name": "frame", "cat": "frame", "ph": ph,
                        "id": pts, "ts": ts, "pid": 1, "tid": tid}
                if ph == "f":
                    flow["bp"] = "e"
                trace.append(flow)
        with open(path, "w") as f:
            json.dump({"traceEvents": trace}, f)


#: the trace file :func:`cuda_profile` writes into its logdir
TRACE_FILE = "cuda_trace.json"


@contextlib.contextmanager
def cuda_profile(logdir: str):
    """Capture a ``torch.profiler`` trace around a pipeline run — CPU
    activity, and CUDA activity (kernel times on the card) when a card is
    present — and write it as Chrome trace-event JSON to
    ``<logdir>/cuda_trace.json``. The device-side counterpart of
    :class:`Tracer`'s host-side events. Yields the profiler (its
    ``key_averages()`` gives per-op device time)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))

