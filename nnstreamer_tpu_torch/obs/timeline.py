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

One clock
---------
Spans stay on ``time.monotonic()``. ``torch.profiler``'s raw events are
on the epoch clock (``time.time_ns()`` as the profiler converts its own
counter). A timeline reads the offset between the two when it is made
and at every export, each time as the tightest of :data:`CLOCK_PAIRS`
back-to-back pairs; :meth:`Timeline.profiler_ns` maps a ledger reading
onto the profiler's clock, :meth:`Timeline.profiler_records` every
record, and ``to_chrome(clock="profiler")`` writes the export on it, so
a ledger span can be placed against a gap on the card.

Thread spans
------------
``activate(threads=True)`` (default False) also records what each
pipeline thread does between frames, as kinds outside :data:`STAGES`
with ``seq=None`` (:data:`THREAD_KINDS`), which no stage report, flight
quantile or frame flow reads: ``wait_input`` (a thread blocked for its
next item: a queue worker's ``get``, ``appsrc``'s ``create``),
``wait_output`` (a producer blocked in a full queue's ``put``), ``gc``
(one collection, on the thread that ran it, with its ``generation``)
and ``chain`` (an element's ``_chain_entry`` / ``_chain_list_entry``,
with its ``element`` name, and a queue worker's pass over what it
drained). Their sites read :data:`THREADS`, one module attribute, which
is None unless such a timeline is active; the always-on flight recorder
never sets it. ``Pipeline.start()`` installs one process-wide
``gc.callbacks`` hook (:func:`gc_hook_acquire`) that always feeds
``nns_gc_pause_seconds{generation}`` and records the ``gc`` spans.
"""

from __future__ import annotations

import gc as _gc
import itertools
import json
import os
import re
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

#: what a pipeline thread does between frames, recorded with ``seq=None``
#: by a timeline activated with ``threads=True`` (module docstring)
THREAD_KINDS: Tuple[str, ...] = ("wait_input", "wait_output", "gc", "chain")

#: back-to-back (monotonic, epoch) readings a clock offset is taken from
CLOCK_PAIRS = 5

_ENV = "NNSTPU_TRACE"

#: the process-wide active timeline; ``None`` means tracing is OFF and
#: every instrumentation site reduces to one attribute read + is-None
#: test. Hot paths read this directly (``_timeline.ACTIVE``).
ACTIVE: Optional["Timeline"] = None

#: ``ACTIVE`` when it records thread spans, else None: a thread-span site
#: is this one attribute read with thread spans off
THREADS: Optional["Timeline"] = None


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


def activate(capacity: int = 1 << 16, threads: bool = False
             ) -> "Timeline":
    """Install a fresh process-wide timeline and return it; ``threads``
    also records the thread spans (module docstring)."""
    global ACTIVE, THREADS
    tl = Timeline(capacity)
    ACTIVE = tl
    THREADS = tl if threads else None
    return tl


def deactivate() -> None:
    global ACTIVE, THREADS
    ACTIVE = THREADS = None


@contextmanager
def tracing(capacity: int = 1 << 16, threads: bool = False):
    """Scoped activation: ``with tracing() as tl: pipe.run(...)``."""
    tl = activate(capacity, threads=threads)
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


class _GcHook:
    """The process's one ``gc.callbacks`` hook while a pipeline runs
    (:func:`gc_hook_acquire`): each collection is a ``gc`` span of the
    thread that ran it (with thread spans on) and a pause that
    ``nns_gc_pause_seconds{generation}`` takes at its next scrape.

    The hook takes no lock: a collection starts at any allocation, also
    on a thread that holds a lock the hook would wait for (a histogram's
    own, while a scrape copies its buckets), and then would never end.
    So it only appends to deques, and a registry collector folds the
    pauses into the histograms at each scrape (and the last pipeline's
    stop, at :func:`gc_hook_release`). Collections never overlap (the
    collecting thread holds the interpreter lock throughout), so one
    start reading serves."""

    def __init__(self):
        self.users = 0
        self._t0: Optional[float] = None
        self._hist: Dict[int, Any] = {}
        #: (generation, seconds) of each collection not yet observed
        self._pending: deque = deque(maxlen=1 << 16)
        self._registry = None

    def install(self) -> None:
        from nnstreamer_tpu_torch.obs.registry import get_registry

        reg = self._registry = get_registry()
        for gen in range(3):
            self._hist[gen] = reg.histogram(
                "nns_gc_pause_seconds",
                "Garbage-collection pauses of the process (every thread "
                "waits for the interpreter lock meanwhile)",
                generation=str(gen))
        reg.register_collector(self.fold)
        _gc.callbacks.append(self)

    def uninstall(self) -> None:
        try:
            _gc.callbacks.remove(self)
        except ValueError:
            pass  # someone else took it out of the list
        self.fold()
        if self._registry is not None:
            self._registry.unregister_collector(self.fold)
            self._registry = None

    def fold(self) -> None:
        """Observe the pending pauses (never inside a collection)."""
        while True:
            try:
                gen, seconds = self._pending.popleft()
            except IndexError:
                return
            h = self._hist.get(gen)
            if h is not None:
                h.observe(seconds)

    def __call__(self, phase: str, info: Dict[str, Any]) -> None:
        if phase == "start":
            self._t0 = time.monotonic()
            return
        t0, self._t0 = self._t0, None
        if t0 is None:
            return
        t1 = time.monotonic()
        gen = info.get("generation", 0)
        self._pending.append((gen, t1 - t0))
        th = THREADS
        if th is not None:
            th._loose_span("gc", t0, t1, generation=gen)


_GC_HOOK = _GcHook()
_GC_HOOK_LOCK = threading.Lock()


def gc_hook_acquire() -> None:
    """``Pipeline.start()``: install the process's GC hook (reference-
    counted: the first running pipeline installs it)."""
    with _GC_HOOK_LOCK:
        if _GC_HOOK.users == 0:
            _GC_HOOK.install()
        _GC_HOOK.users += 1


def gc_hook_release() -> None:
    """``Pipeline.stop()``: the last running pipeline removes the hook
    and observes what it still holds."""
    with _GC_HOOK_LOCK:
        if _GC_HOOK.users == 0:
            return
        _GC_HOOK.users -= 1
        if _GC_HOOK.users == 0:
            _GC_HOOK.uninstall()


@contextmanager
def profiler_correlation(logdir: str):
    """Run ``torch.profiler`` (CPU and, with a card, CUDA activities) over
    the same window as the active timeline, and write its Chrome trace to
    ``<logdir>/profiler.json`` and, with a timeline active, the ledger's on
    the profiler's clock to ``<logdir>/ledger.json`` (``ledger_path``; None
    without one): the kernels on the card and the frame ledger then share
    one clock, and the two files' ``traceEvents`` concatenated load as one
    Perfetto session. Yields the profiler; its ``trace_path`` attribute
    names its file. A profiler that will not start raises: on the card
    this never degrades to a silent no-op."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    prof.trace_path = os.path.join(logdir, "profiler.json")
    prof.ledger_path = None
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(prof.trace_path)
        tl = ACTIVE
        if tl is not None:
            prof.ledger_path = os.path.join(logdir, "ledger.json")
            tl.export_chrome(prof.ledger_path, clock="profiler",
                             base_ns=trace_base_ns(prof.trace_path))


def trace_base_ns(path: str) -> int:
    """The ``baseTimeNanoseconds`` a ``torch.profiler`` Chrome trace counts
    its ``ts`` from (written ahead of its events; 0 where it has none)."""
    with open(path, "rb") as f:
        head = f.read(1 << 16)
    m = re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)', head)
    return int(m.group(1)) if m else 0


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
        #: (ident, native id, kind, t0, t1, args) of threads that may have
        #: no ring of their own (``gc`` spans, recorded inside a
        #: collection, where making a ring or naming a thread Python did
        #: not start could wait for a lock the collecting thread holds);
        #: named at ``_snapshot``
        self._loose: deque = deque(maxlen=self.capacity)
        #: ``threading.get_ident()`` → name of each thread with a ring
        self._ident_names: Dict[int, str] = {}
        #: recording thread's name → ``threading.get_native_id()``, the
        #: id the profiler's host events carry
        self.native_ids: Dict[str, int] = {}
        #: (monotonic ns, profiler clock − monotonic in ns): the first
        #: pairing and the latest (``_sync_clock``)
        self._clock: List[Tuple[int, int]] = []
        self._sync_clock()

    # -- recording (hot path) ------------------------------------------------
    def next_seq(self) -> int:
        return next(self._seq)

    def _ring(self) -> deque:
        r = getattr(self._local, "ring", None)
        if r is None:
            r = deque(maxlen=self.capacity)
            entry = (threading.current_thread().name, r)
            self.native_ids[entry[0]] = threading.get_native_id()
            self._ident_names[threading.get_ident()] = entry[0]
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

    def _loose_span(self, kind: str, t0: float, t1: float, **args) -> None:
        """A thread span of the calling thread, kept outside its ring;
        takes no lock."""
        self._loose.append((threading.get_ident(), threading.get_native_id(),
                            kind, t0, t1, args or None))

    def _loose_records(self) -> List[tuple]:
        """``_loose`` as records, each named by its thread: the name of
        its ring, else of the live thread, else ``thread-<native id>``."""
        names = {t.ident: t.name for t in threading.enumerate()}
        names.update(self._ident_names)
        out = []
        for ident, native, kind, t0, t1, args in list(self._loose):
            name = names.get(ident) or f"thread-{native}"
            self.native_ids.setdefault(name, native)
            out.append((name, kind, None, t0, t1, None, args))
        return out

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
        self._loose.clear()
        self.epoch = time.monotonic()

    # -- aggregation ---------------------------------------------------------
    def _snapshot(self) -> List[tuple]:
        """All records as (thread, kind, seq, t0, t1, track, args),
        time-ordered."""
        with self._rings_lock:
            rings = list(self._rings)
            retired = list(self._retired)
        out: List[tuple] = list(retired)
        out.extend(self._loose_records())
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

    # -- one clock with the profiler ------------------------------------------
    def _sync_clock(self) -> None:
        """Pair the monotonic clock with the profiler's, as the tightest
        of :data:`CLOCK_PAIRS` back-to-back readings, and keep it beside
        the first pairing."""
        best = None
        for _ in range(CLOCK_PAIRS):
            m0 = time.monotonic_ns()
            w = time.time_ns()
            m1 = time.monotonic_ns()
            if best is None or m1 - m0 < best[0]:
                best = (m1 - m0, (m0 + m1) // 2, w)
        _, m, w = best
        self._clock[1:] = [(m, w - m)]

    def profiler_ns(self, t: float) -> int:
        """Ledger reading ``t`` (``time.monotonic()`` seconds) on the
        profiler's clock, in epoch ns: the offset interpolated between
        the first pairing and the latest."""
        m = int(round(t * 1e9))
        (m0, o0), (m1, o1) = self._clock[0], self._clock[-1]
        off = o0
        if m1 > m0:
            off += int((o1 - o0) * min(max((m - m0) / (m1 - m0), 0.0), 1.0))
        return m + off

    def profiler_records(self) -> List[tuple]:
        """Every record as :meth:`_snapshot` gives it, with its times on
        the profiler's clock (epoch ns)."""
        self._sync_clock()
        return [(thread, kind, seq, self.profiler_ns(t0),
                 None if t1 is None else self.profiler_ns(t1), track, args)
                for thread, kind, seq, t0, t1, track, args
                in self._snapshot()]

    # -- export --------------------------------------------------------------
    def _us(self, t: float) -> float:
        return round((t - self.epoch) * 1e6, 3)

    def to_chrome(self, clock: str = "ledger", base_ns: int = 0
                  ) -> Dict[str, Any]:
        """Chrome trace-event JSON (Perfetto-loadable): named thread
        tracks, ``X`` slices with frame-seq args, flow events following
        each frame across tracks, async inflight-slot spans.

        ``clock="ledger"`` (the default, the JAX module's export) counts
        µs from the timeline's epoch; ``clock="profiler"`` counts µs on
        the profiler's clock from ``base_ns`` (a profiler trace's
        ``baseTimeNanoseconds``, :func:`trace_base_ns`), so the export and
        that trace share one time axis, and gives each thread's track its
        ``native_tid`` too.

        Spans carrying an ``endpoint`` arg (the spliced remote-hop
        stages from obs/distributed) render under their own *process*
        track — pid 1 stays the local process, each distinct endpoint
        gets the next pid — and the per-frame flow chain crosses those
        process boundaries, so a distributed timeline loads as one
        flame graph instead of colliding tids."""
        if clock not in ("ledger", "profiler"):
            raise ValueError(f"clock must be 'ledger' or 'profiler', "
                             f"not {clock!r}")
        self._sync_clock()
        if clock == "profiler":
            def us(t: float) -> float:
                return round((self.profiler_ns(t) - base_ns) / 1e3, 3)
        else:
            us = self._us
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
                               "ph": "i", "s": "t", "ts": us(t0),
                               "pid": pid, "tid": tid, "args": a})
            else:
                events.append({"name": kind, "cat": "timeline",
                               "ph": "X", "ts": us(t0),
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
                      "id": seq, "ts": us(t0), "pid": pid,
                      "tid": tid}
                if ph == "f":
                    ev["bp"] = "e"
                events.append(ev)
        for ph, name, aid, t, track in list(self._async):
            events.append({"name": name, "cat": "inflight", "ph": ph,
                           "id": aid, "ts": us(t), "pid": 1,
                           "tid": _tid(1, track)})
        meta: List[dict] = []
        for endpoint, pid in sorted(pids.items(), key=lambda kv: kv[1]):
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "args": {"name": "nnstreamer_tpu_torch" if pid == 1
                                  else f"endpoint {endpoint}"}})
        for (pid, track), tid in sorted(tids.items(),
                                        key=lambda kv: (kv[0][0], kv[1])):
            named: Dict[str, Any] = {"name": track}
            if clock == "profiler" and track in self.native_ids:
                named["native_tid"] = self.native_ids[track]
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": named})
        doc = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
        if clock == "profiler":
            doc["baseTimeNanoseconds"] = base_ns
        return doc

    def export_chrome(self, path: str, clock: str = "ledger",
                      base_ns: int = 0) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(clock, base_ns), f)
