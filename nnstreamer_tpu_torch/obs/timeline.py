"""Frame-ledger timeline: per-frame lifecycle spans across the async
substrate (lanes, queues, dispatch window, transfers).

Port of ``nnstreamer_tpu/obs/timeline.py``; the recorder, the stage set,
the Chrome export and the reports are the JAX module's. Everything
between a frame's source ``create()`` and its sink is asynchronous:
lane workers process frames out of order behind a reorder buffer, the
dispatch window keeps K device batches in flight, queues hand runs of
buffers on. This module records where a FRAME's time goes.

Recording model
---------------
A :class:`Timeline` is installed process-wide (``ACTIVE``). The source
thread stamps a monotone sequence id (``meta["trace_seq"]``) on every
frame — the same single-writer monotone-id discipline the lane executor
already uses for reorder reassembly — and instrumentation points across
the stack append typed spans keyed by that id. Each recording thread
appends into its own bounded ring (``deque(maxlen=capacity)``): no
lock, no allocation beyond the tuple, GIL-atomic append. Export drains
every ring, so a span is attributed to the thread that recorded it
(lane workers, queue drains, the source loop each get their own track).

With no timeline installed (``ACTIVE is None`` — the default) every
instrumentation site is a single module-attribute read and an ``is
None`` test: the off path stays byte-identical and effectively free,
matching the ``NNSTPU_LANES`` / ``NNSTPU_FAULTS`` kill-switch
discipline.

Stage semantics (the frame ledger)
----------------------------------
The canonical span kinds in :data:`STAGES` tile a frame's critical
path, so their per-frame sums reconcile with the sink's end-to-end
latency:

- ``ingest``      source ``create()`` → first queue entry (host
                  preprocessing, minus any reorder-buffer wait)
- ``lane_reorder``time parked in the lane reorder buffer
- ``queue_wait``  queue residency (entry → hand-off downstream); a frame
                  handed on in a list (``Pad.push_list``) keeps waiting
                  inside the receiver until its own turn, and that wait
                  is ``queue_wait`` too: in a fused region until its
                  dispatch starts, in ``tensor_aggregator`` until its
                  window is pushed
- ``sched_hold``  EDF-heap residency in a scheduler-mode queue (the SLO
                  scheduler, ``serving/scheduler.py``)
- ``fence_wait``  dispatch-window fence block for the frame's own entry
- ``shard``       mesh placement: a ``mesh=`` filter's or sharded
                  region's ``serve.place_batch`` before its invoke
- ``device``      filter/fused-region invoke: on CUDA the HOST's enqueue
                  of the region's graph replay (or the filter's kernels),
                  not kernel time — launches are asynchronous, so the
                  device's share of a frame shows in ``fence_wait`` and
                  ``d2h``
- ``d2h``         the device→host fetch: ``to_host()``, and for a
                  ``materialize-host`` queue each frame of the fetched
                  run, from the copies' enqueue to the one
                  synchronisation (the queue's ``queue_wait`` ends where
                  the fetch starts)
- ``decode``      tensor→media decode (host part): the decoder's chain,
                  or a fused decoder's deferred finalize
- ``sink``        sink-side completion work after materialization

An aggregated window carries the trace seq of its first frame, and the
sink measures that frame's end-to-end time (``meta["tl_create_t"]``), so
the window's ledger entry is one frame's whole life.

Non-tiling kinds (``h2d``, ``lane_exec``, ``lane_stall``) and instant
events (``fault``, ``fault_retry``, ``fault_skip``, ``fault_degrade``,
``lane_restart``, ``watchdog_trip``) appear in the exported trace but are
excluded from the reconciliation sum — they overlap the stages above in
wall time.

Spans are ``time.monotonic()`` pairs, the clock of the source's
``create_t`` stamp; recording one never synchronises the device. Where
one stage ends at a hand-off to the next element, the two share one
reading (:data:`HANDOFF_META` in the frame's meta), so the time a frame
spends between two threads or in a ``push`` belongs to the receiver's
span and the stages tile the frame's life even on a busy host.

Export
------
:meth:`Timeline.to_chrome` emits Chrome trace-event JSON that Perfetto
loads directly: one process, one named thread track per recording
thread / lane / queue, ``ph:"X"`` slices with ``args`` carrying the
frame seq, ``s``/``t``/``f`` flow events linking one frame across
tracks, and ``b``/``e`` async spans for dispatch-window inflight slots.
:meth:`stage_breakdown` aggregates the same records into per-stage
means that must sum to ~e2e; :meth:`variance_report` attributes
warm-run spread to its dominant stage. :func:`profiler_correlation`
(the JAX module's ``jax_correlation``) runs ``torch.profiler`` over the
same window, so the kernels on the card line up with the frame ledger in
one Perfetto session.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import weakref
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

#: meta key carrying the frame's trace context: a monotone sequence id
#: stamped once by the source thread (single writer, like the lane
#: executor's ``lane_seq``)
TRACE_SEQ_META = "trace_seq"

#: meta key carrying the time a critical-path span ended at a hand-off
#: (a queue's hand-off downstream, a window's push, a dispatch's or a
#: decode's end): the receiver's next span starts at this same reading,
#: so the wall time between two elements — a ``push`` call, a thread
#: waiting for the GIL — lands in the receiver's span and never between
#: two spans
HANDOFF_META = "tl_handoff_t"

#: span kinds that tile a frame's critical path — the stage_breakdown /
#: reconciliation set, in pipeline order
LOCAL_STAGES: Tuple[str, ...] = ("ingest", "lane_reorder", "queue_wait",
                                 "sched_hold", "fence_wait", "shard",
                                 "device", "d2h", "decode", "sink")

#: distributed-hop stages spliced into the CLIENT ledger by
#: elements/query.py when cross-hop tracing is armed (obs/distributed):
#: outbound wire time, the remote pipeline's queue/device residency, the
#: remote remainder (decode/sink/unattributed), and inbound wire time.
#: All five are anchored inside the client's observed RTT window — raw
#: remote clocks are never compared against local ones — and stay
#: zero-valued (absent) on single-process pipelines, so every consumer
#: keyed off STAGES (flight quantiles, gauges, MAD attribution,
#: breakdowns) names remote stages without further wiring.
DIST_STAGES: Tuple[str, ...] = ("hop_send", "remote_queue",
                                "remote_device", "remote_other",
                                "hop_recv")

STAGES: Tuple[str, ...] = LOCAL_STAGES + DIST_STAGES

_ENV = "NNSTPU_TRACE"

#: the process-wide active timeline; ``None`` means tracing is OFF and
#: every instrumentation site reduces to one attribute read + is-None
#: test. Hot paths read this directly (``_timeline.ACTIVE``).
ACTIVE: Optional["Timeline"] = None


def trace_enabled() -> bool:
    """True when ``NNSTPU_TRACE`` asks for tracing (any non-empty value
    except the usual falsy spellings; a value that is not a boolean
    spelling is taken as the export path)."""
    v = os.environ.get(_ENV, "").strip()
    return bool(v) and v.lower() not in ("0", "false", "no", "off")


def env_export_path() -> Optional[str]:
    """The export path carried in ``NNSTPU_TRACE``, if it names one."""
    v = os.environ.get(_ENV, "").strip()
    if not v or v.lower() in ("0", "false", "no", "off", "1", "true",
                              "yes", "on"):
        return None
    return v


def active() -> Optional["Timeline"]:
    return ACTIVE


def activate(capacity: int = 1 << 16) -> "Timeline":
    """Install a fresh process-wide timeline and return it."""
    global ACTIVE
    tl = Timeline(capacity)
    ACTIVE = tl
    return tl


def deactivate() -> None:
    global ACTIVE
    ACTIVE = None


@contextmanager
def tracing(capacity: int = 1 << 16):
    """Scoped activation: ``with tracing() as tl: pipe.run(...)``."""
    tl = activate(capacity)
    try:
        yield tl
    finally:
        if ACTIVE is tl:
            deactivate()


def maybe_activate_env() -> Optional["Timeline"]:
    """``Pipeline.start()`` hook: honor ``NNSTPU_TRACE`` without code
    changes. Idempotent; an explicitly installed timeline wins."""
    if ACTIVE is not None:
        return ACTIVE
    if not trace_enabled():
        return None
    tl = activate()
    tl.export_path = env_export_path()
    tl._env_owned = True
    return tl


def maybe_export_env() -> None:
    """``Pipeline.stop()`` hook: export + retire an env-owned timeline
    (``NNSTPU_TRACE=/path/to/trace.json``)."""
    tl = ACTIVE
    if tl is None or not tl._env_owned:
        return
    if tl.export_path:
        try:
            tl.export_chrome(tl.export_path)
        except OSError:
            pass  # an unwritable path must not take down pipeline stop
    deactivate()


@contextmanager
def profiler_correlation(logdir: str):
    """Run ``torch.profiler`` (CPU and, with a card, CUDA activities) over
    the same window as the active timeline, and write its Chrome trace to
    ``<logdir>/profiler.json``, beside where the caller exports the ledger:
    the kernels on the card and the frame ledger then share a wall-clock
    span and load side by side in Perfetto. Yields the profiler; its
    ``trace_path`` attribute names the file. A profiler that will not
    start raises: on the card this never degrades to a silent no-op."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    prof.trace_path = os.path.join(logdir, "profiler.json")
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(prof.trace_path)


class _RingAnchor:
    """Weakref-able token parked in a recording thread's thread-local
    dict; its finalizer retires the thread's ring (see ``_ring``)."""

    __slots__ = ("__weakref__",)


def _retire_ring(tl_ref: "weakref.ref", entry: Tuple[str, deque]) -> None:
    tl = tl_ref()
    if tl is not None:
        tl._retire(entry)


class Timeline:
    """Low-overhead frame-ledger recorder (see module docstring)."""

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = int(capacity)
        self.epoch = time.monotonic()
        self.export_path: Optional[str] = None
        self._env_owned = False
        self._seq = itertools.count()  # next() is GIL-atomic
        self._local = threading.local()
        #: [(thread_name, ring)] — registry of every LIVE thread's ring;
        #: appended once per recording thread under the lock, drained
        #: at export, removed when the thread dies (see ``_ring``)
        self._rings: List[Tuple[str, deque]] = []
        self._rings_lock = threading.Lock()
        #: records salvaged from dead threads' rings — supervised lane
        #: restarts spin up fresh worker threads per crash cycle, so
        #: without retirement ``_rings`` grows one entry per restart
        #: forever; bounded like any single ring
        self._retired: deque = deque(maxlen=self.capacity)
        #: dispatch-window inflight slots: ("b"/"e", name, id, t, track)
        self._async: deque = deque(maxlen=4 * self.capacity)

    # -- recording (hot path) ------------------------------------------------
    def next_seq(self) -> int:
        return next(self._seq)

    def _ring(self) -> deque:
        r = getattr(self._local, "ring", None)
        if r is None:
            r = deque(maxlen=self.capacity)
            entry = (threading.current_thread().name, r)
            with self._rings_lock:
                self._rings.append(entry)
            # Unregister at thread death: the anchor lives only in this
            # thread's thread-local dict, so CPython drops it when the
            # thread exits and the finalizer moves the ring's records
            # into the bounded ``_retired`` store. Pipeline.stop() joins
            # workers before export, so post-join exports still see
            # every span; what this prevents is ``_rings`` growing one
            # dead entry per supervised lane restart.
            anchor = _RingAnchor()
            weakref.finalize(anchor, _retire_ring, weakref.ref(self),
                             entry)
            self._local.ring = r
            self._local.anchor = anchor
        return r

    def _retire(self, entry: Tuple[str, deque]) -> None:
        name, ring = entry
        with self._rings_lock:
            try:
                self._rings.remove(entry)
            except ValueError:
                return  # clear()/re-entry already handled it
            for rec in ring:
                self._retired.append((name,) + rec)

    def span(self, kind: str, seq: Optional[int], t0: float, t1: float,
             track: Optional[str] = None, **args) -> None:
        """Record a duration span [t0, t1) attributed to frame ``seq``."""
        self._ring().append((kind, seq, t0, t1, track, args or None))

    def mark(self, kind: str, seq: Optional[int],
             t: Optional[float] = None, track: Optional[str] = None,
             **args) -> None:
        """Record an instant event (shed/reject decisions, submits)."""
        if t is None:
            t = time.monotonic()
        self._ring().append((kind, seq, t, None, track, args or None))

    def async_begin(self, name: str, aid: int,
                    t: Optional[float] = None,
                    track: str = "dispatch") -> None:
        self._async.append(
            ("b", name, aid, time.monotonic() if t is None else t, track))

    def async_end(self, name: str, aid: int,
                  t: Optional[float] = None,
                  track: str = "dispatch") -> None:
        self._async.append(
            ("e", name, aid, time.monotonic() if t is None else t, track))

    def clear(self) -> None:
        """Drop recorded events (rings stay registered; epoch advances
        so a re-used timeline exports a fresh window)."""
        with self._rings_lock:
            rings = list(self._rings)
            self._retired.clear()
        for _, r in rings:
            r.clear()
        self._async.clear()
        self.epoch = time.monotonic()

    # -- aggregation ---------------------------------------------------------
    def _snapshot(self) -> List[tuple]:
        """All records as (thread, kind, seq, t0, t1, track, args),
        time-ordered."""
        with self._rings_lock:
            rings = list(self._rings)
            retired = list(self._retired)
        out: List[tuple] = list(retired)
        for tname, ring in rings:
            for rec in list(ring):
                out.append((tname,) + rec)
        out.sort(key=lambda r: r[3])
        return out

    def frame_ledger(self, skip_frames: int = 0
                     ) -> Dict[int, Dict[str, float]]:
        """Per-frame stage durations (seconds) keyed by trace seq; a
        frame that reached the sink also carries its measured ``e2e``.
        ``skip_frames`` drops the first N frames (warm-up exclusion)."""
        frames: Dict[int, Dict[str, float]] = {}
        for _, kind, seq, t0, t1, _, args in self._snapshot():
            if seq is None or t1 is None:
                continue
            d = frames.setdefault(seq, {})
            d[kind] = d.get(kind, 0.0) + (t1 - t0)
            if args and "e2e_s" in args:
                d["e2e"] = float(args["e2e_s"])
        for s in sorted(frames)[:skip_frames]:
            del frames[s]
        return frames

    def frame_stages(self, seq: int) -> Dict[str, float]:
        """Stage durations (seconds) for ONE frame — the scan-based
        span-vector source a query server uses for remote egress when
        no flight recorder (with its O(1) per-frame accumulator) is
        installed."""
        out: Dict[str, float] = {}
        for _, kind, s, t0, t1, _, _ in self._snapshot():
            if s == seq and t1 is not None:
                out[kind] = out.get(kind, 0.0) + (t1 - t0)
        return out

    def stage_breakdown(self, skip_frames: int = 0) -> Dict[str, Any]:
        """Mean per-frame seconds spent in each canonical stage, over
        frames that completed (have a sink e2e record). ``covered_ms``
        is the sum of the stage means; ``reconciliation`` is
        covered/e2e — ~1.0 means the ledger accounts for the frame's
        whole life, a gap shows as ``unattributed_ms``."""
        frames = self.frame_ledger(skip_frames)
        done = [d for d in frames.values() if "e2e" in d]
        n = len(done)
        if n == 0:
            return {"frames": 0, "stages_ms": {}, "e2e_mean_ms": 0.0,
                    "covered_ms": 0.0, "unattributed_ms": 0.0,
                    "reconciliation": 0.0}
        stages = {k: sum(d.get(k, 0.0) for d in done) / n * 1e3
                  for k in STAGES}
        e2e = sum(d["e2e"] for d in done) / n * 1e3
        covered = sum(stages.values())
        return {
            "frames": n,
            "stages_ms": {k: round(v, 4) for k, v in stages.items()},
            "e2e_mean_ms": round(e2e, 4),
            "covered_ms": round(covered, 4),
            "unattributed_ms": round(max(e2e - covered, 0.0), 4),
            "reconciliation": round(covered / e2e, 4) if e2e > 0 else 0.0,
        }

    def variance_report(self, skip_frames: int = 0) -> Dict[str, Any]:
        """Attribute e2e spread to its dominant stage: per-stage MAD of
        the per-frame durations (robust — one cold outlier cannot own
        the report), ranked; ``dominant_share`` is the winner's MAD as
        a fraction of the e2e MAD."""
        frames = self.frame_ledger(skip_frames)
        done = [d for d in frames.values() if "e2e" in d]
        if len(done) < 2:
            return {"frames": len(done), "e2e_mad_ms": 0.0,
                    "stage_mad_ms": {}, "dominant_stage": None,
                    "dominant_share": 0.0}

        def _mad(vals: List[float]) -> float:
            vals = sorted(vals)
            med = vals[len(vals) // 2]
            dev = sorted(abs(v - med) for v in vals)
            return dev[len(dev) // 2]

        stage_mad = {k: _mad([d.get(k, 0.0) for d in done]) * 1e3
                     for k in STAGES}
        e2e_mad = _mad([d["e2e"] for d in done]) * 1e3
        dominant = max(stage_mad, key=lambda k: stage_mad[k])
        if stage_mad[dominant] <= 0.0:
            dominant = None
        return {
            "frames": len(done),
            "e2e_mad_ms": round(e2e_mad, 4),
            "stage_mad_ms": {k: round(v, 4)
                             for k, v in stage_mad.items()},
            "dominant_stage": dominant,
            "dominant_share": round(stage_mad[dominant] / e2e_mad, 4)
            if dominant and e2e_mad > 0 else 0.0,
        }

    # -- export --------------------------------------------------------------
    def _us(self, t: float) -> float:
        return round((t - self.epoch) * 1e6, 3)

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (Perfetto-loadable): named thread
        tracks, ``X`` slices with frame-seq args, flow events following
        each frame across tracks, async inflight-slot spans.

        Spans carrying an ``endpoint`` arg (the spliced remote-hop
        stages from obs/distributed) render under their own *process*
        track — pid 1 stays the local process, each distinct endpoint
        gets the next pid — and the per-frame flow chain crosses those
        process boundaries, so a distributed timeline loads as one
        flame graph instead of colliding tids."""
        recs = self._snapshot()
        pids: Dict[str, int] = {"": 1}
        tids: Dict[Tuple[int, str], int] = {}
        tid_next: Dict[int, int] = {}

        def _pid(endpoint: Optional[str]) -> int:
            key = str(endpoint) if endpoint else ""
            p = pids.get(key)
            if p is None:
                p = pids[key] = len(pids) + 1
            return p

        def _tid(pid: int, track: str) -> int:
            t = tids.get((pid, track))
            if t is None:
                t = tid_next.get(pid, 0) + 1
                tid_next[pid] = t
                tids[(pid, track)] = t
            return t

        events: List[dict] = []
        flows: Dict[int, List[Tuple[float, int, int]]] = {}
        for thread, kind, seq, t0, t1, track, args in recs:
            track = track or thread
            a: Dict[str, Any] = {"seq": seq}
            if args:
                a.update(args)
            pid = _pid(a.get("endpoint"))
            tid = _tid(pid, track)
            if t1 is None:
                events.append({"name": kind, "cat": "timeline",
                               "ph": "i", "s": "t", "ts": self._us(t0),
                               "pid": pid, "tid": tid, "args": a})
            else:
                events.append({"name": kind, "cat": "timeline",
                               "ph": "X", "ts": self._us(t0),
                               "dur": max(round((t1 - t0) * 1e6, 3), 0.0),
                               "pid": pid, "tid": tid, "args": a})
                if seq is not None:
                    flows.setdefault(seq, []).append((t0, pid, tid))
        # flow events: one arrow chain per frame across its tracks (and,
        # for hop spans, across endpoint processes) — the "follow this
        # frame" affordance in Perfetto
        for seq, hops in flows.items():
            if len(hops) < 2:
                continue
            hops.sort()
            for i, (t0, pid, tid) in enumerate(hops):
                ph = "s" if i == 0 else ("f" if i == len(hops) - 1 else "t")
                ev = {"name": "frame", "cat": "frame", "ph": ph,
                      "id": seq, "ts": self._us(t0), "pid": pid,
                      "tid": tid}
                if ph == "f":
                    ev["bp"] = "e"
                events.append(ev)
        for ph, name, aid, t, track in list(self._async):
            events.append({"name": name, "cat": "inflight", "ph": ph,
                           "id": aid, "ts": self._us(t), "pid": 1,
                           "tid": _tid(1, track)})
        meta: List[dict] = []
        for endpoint, pid in sorted(pids.items(), key=lambda kv: kv[1]):
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "args": {"name": "nnstreamer_tpu_torch" if pid == 1
                                  else f"endpoint {endpoint}"}})
        for (pid, track), tid in sorted(tids.items(),
                                        key=lambda kv: (kv[0][0], kv[1])):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": track}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
