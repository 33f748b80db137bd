"""Pipeline — element container, source threads, and bus.

The reference's pipelines are GStreamer pipelines: sources run streaming
threads, ``queue`` elements decouple stages, a bus carries ERROR/EOS
messages to the application. The port keeps that capability:

- :class:`Pipeline` holds elements, drives state changes, runs one thread
  per source element, and exposes a bus (:meth:`Pipeline.pop_message`,
  :meth:`Pipeline.wait`).
- :class:`SourceElement` is the push-mode source base (GstBaseSrc's
  create-loop).
- :class:`Queue` is the explicit thread boundary (gst ``queue``): a bounded
  FIFO + worker thread. Stages separated by queues overlap host work with
  the card's asynchronous execution; with ``prefetch-device`` it is the
  staging point where host frames cross to the card in batches, and with
  ``materialize-host`` the point where results come back in groups.

As in the JAX package, a pipeline fuses by default: ``start()`` splices
a :class:`~nnstreamer_tpu_torch.pipeline.fuse.FusedRegion` over each run
of device-capable elements (``pipeline/fuse.py``; ``fuse=False`` or
``NNSTPU_FUSE=0`` turn it off), then ingest lanes behind each source
(``Pipeline(lanes=N)`` or ``pipe.lanes = N`` before ``start()``;
``pipeline/lanes.py``, ``NNSTPU_LANES``). ``error_policy`` sets the
default error policy of every element (``pipeline/supervise.py``) and
``watchdog_s`` (or ``NNSTPU_WATCHDOG_S``) arms the liveness watchdog.
``start()`` honours ``NNSTPU_TRACE`` (the frame ledger,
``obs/timeline.py``) and ``NNSTPU_FAULTS`` (``pipeline/faults.py``), and
installs the always-on flight recorder (``obs/flight.py``; off with
``NNSTPU_FLIGHT=0``, tail dumps into ``flight_dir`` or a directory named
by ``NNSTPU_FLIGHT``). ``slo_budget_ms`` (or a queue's
``slo-budget-ms``) attaches the SLO scheduler (``serving/scheduler.py``)
to the admission-point queues. ``NNSTPU_DUMP_DOT_DIR`` writes the started
graph as Graphviz dot (``pipeline/dot.py``). ``NNSTPU_HBM_BUDGET``
installs the HBM accountant at ``start()`` (``tensors/memory.py``;
``metrics_snapshot()["memory"]``). Serving continuity
(``pipeline/continuity.py``): :meth:`Pipeline.swap_model`,
:meth:`Pipeline.checkpoint` / :meth:`Pipeline.restore`, and the
``checkpoint_dir`` / ``NNSTPU_CHECKPOINT`` and ``NNSTPU_COMPILE_CACHE``
hooks at start and stop.
"""

from __future__ import annotations

import enum
import heapq
import os
import queue as _queue
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from nnstreamer_tpu_torch.device import resolve_device
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.obs.collectors import register_pipeline_collector
from nnstreamer_tpu_torch.obs import timeline as _timeline
from nnstreamer_tpu_torch.pipeline import faults as _faults
from nnstreamer_tpu_torch.tensors import memory as _memory
from nnstreamer_tpu_torch.pipeline.dispatch import (
    POOL_STASH_META,
    release_shed_payload,
)
from nnstreamer_tpu_torch.pipeline.element import (
    Element,
    EosEvent,
    Event,
    FlowError,
    FlowReturn,
)
from nnstreamer_tpu_torch.pipeline.fuse import fuse_pipeline, fusion_enabled
from nnstreamer_tpu_torch.registry import ELEMENT, subplugin
from nnstreamer_tpu_torch.tensors.buffer import (
    H2D_EXCLUSIVE_META,
    TensorBuffer,
    as_device_buffer,
    materialize_many,
    upload_many,
)
from nnstreamer_tpu_torch.tensors.pool import (
    get_pool,
    pool_enabled,
    release_all_pools,
)

log = get_logger("pipeline")


def poll_get(q: _queue.Queue, stop_evt: threading.Event, who: str):
    """``q``'s next item, polling every 0.1 s until ``stop_evt`` is set
    (then None). With thread spans on (``obs/timeline.py``) the whole
    wait, however many polls it took, is one ``wait_input`` span of the
    calling thread, with ``who`` as its element."""
    th = _timeline.THREADS
    t0 = time.monotonic() if th is not None else 0.0
    while not stop_evt.is_set():
        try:
            item = q.get(timeout=0.1)
        except _queue.Empty:
            continue
        if th is not None:
            th.span("wait_input", None, t0, time.monotonic(), element=who)
        return item
    return None


class State(enum.Enum):
    NULL = "null"
    READY = "ready"
    PLAYING = "playing"


class Message:
    """Bus message (GstMessage equivalent)."""

    def __init__(self, kind: str, source: Optional[Element] = None,
                 error: Optional[Exception] = None,
                 text: Optional[str] = None):
        self.kind = kind  # "eos" | "error" | "warning"
        self.source = source
        self.error = error
        self.text = text

    def __repr__(self):
        detail = f", text={self.text!r}" if self.text else ""
        return (f"Message({self.kind}, "
                f"src={getattr(self.source, 'name', None)}, "
                f"err={self.error}{detail})")


class SourceElement(Element):
    """Push-mode source: the pipeline runs :meth:`create` in a loop on a
    dedicated streaming thread until it returns None (EOS) or the pipeline
    stops."""

    ELEMENT_NAME = "source"
    PROPERTIES = {**Element.PROPERTIES}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        if not self.srcpads:
            self.add_src_pad("src")
        self._stop_evt = threading.Event()

    def create(self) -> Optional[TensorBuffer]:
        """Produce the next buffer, or None at end-of-stream. Blocking calls
        must poll ``self._stop_evt``."""
        raise NotImplementedError

    def negotiate(self) -> None:
        """Announce src caps before the first buffer (override)."""

    def run_loop(self, pipeline: "Pipeline") -> None:
        try:
            self.negotiate()
            while not self._stop_evt.is_set():
                buf = self.create()
                if buf is None:
                    break
                # capture-time stamp for end-to-end frame latency: sinks
                # measure now - create_t once the payload is on the host
                if "create_t" not in buf.meta:
                    buf.meta["create_t"] = time.monotonic()
                # frame-ledger trace context (obs/timeline.py): one
                # monotone id per frame, stamped by the single source
                # thread — the lane executor's single-writer discipline
                tl = _timeline.ACTIVE
                if tl is not None and \
                        _timeline.TRACE_SEQ_META not in buf.meta:
                    buf.meta[_timeline.TRACE_SEQ_META] = tl.next_seq()
                if self.srcpad.push(buf) is FlowReturn.EOS:
                    break
            for sp in self.srcpads:
                sp.push_event(EosEvent())
            pipeline.post_message(Message("eos", self))
        except Exception as e:  # noqa: BLE001 — the bus carries any failure
            pipeline.post_error(self, e)

    def start(self):
        self._stop_evt.clear()
        super().start()

    def stop(self):
        self._stop_evt.set()
        super().stop()


@subplugin(ELEMENT, "queue")
class Queue(Element):
    """Thread-boundary element: bounded FIFO + worker thread.

    - ``max-size-buffers`` bounds occupancy;
    - ``leaky`` (``no`` | ``downstream``) selects blocking vs drop-oldest
      backpressure (gst queue's leaky property); a dropped frame releases
      its pool stash at once;
    - ``drain-batch`` is the most buffers the worker gathers per wake,
      from what is already queued (it never waits); a run of data buffers
      goes to a ``HANDLES_LIST`` peer as one list, and 1 turns gathering
      off;
    - ``prefetch-device`` uploads each buffer to the package device: with
      ``batch-h2d`` (the default) on the worker side, where each gathered
      run of same-shaped host buffers crosses as ONE copy from one pinned
      window slab (``tensors/buffer.py`` ``upload_many``), else per buffer
      on the producer side. The pooled host arrays ride on as the
      buffer's ``pool_stash`` until the dispatch that reads them fences
      (``pipeline/dispatch.py``), and a partial window's deferred padding
      (aggregator ``pad-device``) is added on the device;
    - ``prefetch-host`` starts each buffer's device→host copies on the
      producer side, into pinned memory, so the consumer of the queue
      finds them in flight;
    - ``materialize-host`` hands HOST buffers downstream: each gathered
      run is fetched with one synchronisation (``materialize_many``) and
      its deferred finalizes applied, in order, before the pushes.
    - ``stamp-admission`` marks the admission point of a saturated
      pipeline: each buffer the queue accepts gets ``meta["admitted_t"]``
      (``nns_queue_admitted_total``), and a leaky drop of an admitted
      buffer revokes the stamp (``nns_queue_admitted_revoked_total``), so
      a sink's ``base="admitted"`` latency covers the served frames only;
    - ``slo-budget-ms`` (or a pipeline's ``slo_budget_ms`` on a
      stamp-admission queue) makes the queue an admission point of the
      pipeline's SLO scheduler (``serving/scheduler.py``): deadline
      admission at ``chain()`` (a rejected frame is dropped and never
      admitted), an earliest-deadline-first heap in place of the FIFO,
      late-first shedding on overflow (a shed frame's stamp is revoked
      and its staged slabs released), and runs formed under the
      controller's ``batch_cap``, with ``sched_hold`` as the frames'
      ledger span. With a uniform budget the heap's order is arrival
      order. The port supports the scheduler queue before
      ``tensor_aggregator``, where bench.py's string has it: the
      aggregator still forms whole windows, so a fused region behind it
      sees one input signature.

    The ``queue.push`` fault hook fires on entry; with a timeline active
    the queue records each frame's ``queue_wait`` (and the first queue a
    frame meets closes its ``ingest`` span).

    Uploads and fetches run on the worker's current stream, the device's
    default stream (``tensors/buffer.py``).
    """

    ELEMENT_NAME = "queue"
    HANDLES_DEFERRED = True  # pure hand-off: finalize stays lazy across it
    DEVICE_PASSTHROUGH = True  # never reads tensor bytes on the host
    PROPERTIES = {**Element.PROPERTIES, "max_size_buffers": 16, "leaky": "no",
                  "prefetch_host": False, "prefetch_device": False,
                  "materialize_host": False, "drain_batch": 64,
                  "batch_h2d": True, "stamp_admission": False,
                  "slo_budget_ms": 0.0}

    _EOS = object()
    #: worker wake token in scheduler mode: data rides the EDF heap, the
    #: FIFO carries only ordering (tokens, events, EOS)
    _TOKEN = object()
    #: at most one leaky-drop warning per this many seconds
    DROP_WARN_INTERVAL_S = 5.0

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        self._q: _queue.Queue = _queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._eos_done = threading.Event()
        self._m_drops = None
        self._m_blocked = None    # cumulative blocked-put seconds
        self._m_drain = None
        self._last_drop_warn_t = 0.0
        self._drops_since_warn = 0
        self._m_admitted = None       # stamp-admission accept counter
        self._m_adm_revoked = None    # admitted-then-dropped counter
        #: data buffers the worker popped but has not handed downstream
        #: yet (single writer: the worker)
        self._undelivered = 0
        #: where prefetch-device uploads to, resolved at start()
        self._device: Optional[torch.device] = None
        #: SLO scheduler binding (serving/scheduler.py), resolved at
        #: start(); None = the plain FIFO queue
        self._sched = None
        self._budget_ms = 0.0
        self._edf: list = []          # (deadline_t, seq, buf) heap
        self._edf_lock = threading.Lock()
        self._edf_seq = 0             # FIFO tiebreak for equal deadlines

    def property_changed(self, key):
        if key == "leaky" and self._props["leaky"] not in ("no", "downstream"):
            raise ValueError(f"{self.name}: leaky must be 'no' or "
                             f"'downstream', not {self._props['leaky']!r}")

    def _depth(self) -> int:
        """Occupancy: queued (the FIFO, or the EDF heap in scheduler
        mode) plus popped but not yet handed on."""
        if self._sched is not None:
            with self._edf_lock:
                queued = len(self._edf)
        else:
            queued = self._q.qsize()
        return queued + self._undelivered

    def obs_snapshot(self):
        out = super().obs_snapshot()
        out["depth"] = self._depth()
        if self._m_drops is not None:
            out["drops"] = int(self._m_drops.value)
            out["blocked_s"] = round(self._m_blocked.value, 4)
            if self.get_property("stamp_admission"):
                out["admitted"] = int(self._m_admitted.value)
                out["admitted_revoked"] = int(self._m_adm_revoked.value)
        if self._m_drain is not None and self._m_drain.count:
            out["drain_size_p50"] = self._m_drain.percentile(50)
        return out

    def start(self):
        super().start()
        self._stop_evt.clear()
        self._eos_done.clear()
        self._undelivered = 0
        if self.get_property("prefetch_device"):
            self._device = resolve_device()
        # scheduler binding: an admission point when the pipeline has an
        # SloScheduler AND this queue stamps admission or carries its own
        # budget; otherwise the plain FIFO path
        own_budget = float(self.get_property("slo_budget_ms") or 0.0)
        sched = getattr(self.pipeline, "_slo_scheduler", None)
        if sched is not None and (own_budget > 0
                                  or self.get_property("stamp_admission")):
            self._sched = sched
            self._budget_ms = own_budget if own_budget > 0 \
                else sched.budget_ms
            # data rides the EDF heap (bounded by max-size-buffers in
            # _chain_scheduled); the FIFO carries only wake tokens and
            # serialized events, so it never blocks a producer
            self._edf = []
            self._edf_seq = 0
            self._q = _queue.Queue()
        else:
            self._sched = None
            self._q = _queue.Queue(
                maxsize=int(self.get_property("max_size_buffers")))
        if self._m_drops is None:
            reg = get_registry()
            labels = dict(pipeline=getattr(self.pipeline, "name", "") or "",
                          element=self.name)
            self._m_drops = reg.counter(
                "nns_queue_drops_total",
                "Buffers discarded by leaky=downstream backpressure",
                **labels)
            self._m_blocked = reg.counter(
                "nns_queue_blocked_seconds_total",
                "Cumulative producer time spent blocked on a full queue",
                **labels)
            ref = weakref.ref(self)
            reg.gauge("nns_queue_depth", "Buffers currently queued",
                      fn=lambda: (ref()._depth() if ref() is not None
                                  else 0), **labels)
            self._m_drain = reg.histogram(
                "nns_queue_drain_size",
                "Data buffers the worker drained per wake (backlog "
                "batching)", buckets=(1, 2, 4, 8, 16, 32, 64), **labels)
            self._m_admitted = reg.counter(
                "nns_queue_admitted_total",
                "Buffers accepted at a stamp_admission point", **labels)
            self._m_adm_revoked = reg.counter(
                "nns_queue_admitted_revoked_total",
                "Admitted buffers later dropped before delivery (the "
                "admitted population nets these out)", **labels)
        self._worker = threading.Thread(
            target=self._drain_sched if self._sched is not None
            else self._drain, name=f"{self.name}-worker", daemon=True)
        self._worker.start()

    def stop(self):
        self._stop_evt.set()
        try:
            self._q.put_nowait(self._EOS)
        except _queue.Full:
            pass
        if self._worker is not None:
            self._worker.join(timeout=5)
            self._worker = None
        super().stop()

    def threads(self):
        return [self._worker] if self._worker is not None else []

    def accepts_now(self) -> bool:
        """True when a push would be absorbed without blocking or dropping.
        A latency-budget aggregator upstream polls this before flushing a
        partial window early."""
        if self._worker is None:
            return True
        if self._sched is not None:
            with self._edf_lock:
                return len(self._edf) < \
                    int(self.get_property("max_size_buffers"))
        maxsize = self._q.maxsize
        return maxsize <= 0 or self._q.qsize() < maxsize

    # -- frame-ledger hooks (obs/timeline.py) --------------------------------
    def _tl_arrive(self, buf) -> None:
        """The FIRST queue a frame reaches closes its ingest span (source
        ``create()`` → here, minus any lane reorder wait, so ingest +
        lane_reorder tile exactly); every queue stamps the entry time its
        drain side turns into a queue_wait span: the sender's hand-off
        reading where it left one (``HANDOFF_META``). One attribute read
        with tracing off."""
        tl = _timeline.ACTIVE
        if tl is None:
            return
        seq = buf.meta.get(_timeline.TRACE_SEQ_META)
        if seq is None:
            return
        now = buf.meta.pop(_timeline.HANDOFF_META, None) or time.monotonic()
        if "tl_ingest_done" not in buf.meta:
            buf.meta["tl_ingest_done"] = True
            create = buf.meta.get("create_t")
            if create is not None:
                reorder = buf.meta.pop("tl_reorder_s", 0.0)
                tl.span("ingest", seq, create, max(now - reorder, create),
                        track="ingest")
        buf.meta["tl_q_t"] = now

    def _tl_depart(self, buf, now: Optional[float] = None) -> None:
        """Drain-side twin of :meth:`_tl_arrive`: queue residency ends at
        the frame's hand-off downstream (at ``now`` when the caller took
        the reading): ``queue_wait``, or ``sched_hold`` for the EDF heap
        of a scheduler-mode queue. The frame carries the time as
        ``HANDOFF_META``, from which the receiver starts its next span: a
        frame handed on in a list waits there for its own turn."""
        tl = _timeline.ACTIVE
        if tl is None:
            return
        t0 = buf.meta.pop("tl_q_t", None)
        seq = buf.meta.get(_timeline.TRACE_SEQ_META)
        if t0 is None or seq is None:
            return
        if now is None:
            now = time.monotonic()
        tl.span("sched_hold" if self._sched is not None else "queue_wait",
                seq, t0, now, track=self.name)
        buf.meta[_timeline.HANDOFF_META] = now

    def _count_drop(self) -> None:
        """Count a leaky drop, with one rate-limited warning, so a live
        operator sees the loss without a log line per frame."""
        self._m_drops.inc()
        self._drops_since_warn += 1
        now = time.monotonic()
        if now - self._last_drop_warn_t >= self.DROP_WARN_INTERVAL_S:
            self.log.warning(
                "%s: leaky=downstream dropped %d buffer(s) since last "
                "report (downstream slower than producer; total %d)",
                self.name, self._drops_since_warn,
                int(self._m_drops.value))
            self._last_drop_warn_t = now
            self._drops_since_warn = 0

    def _drop_oldest(self) -> None:
        """leaky=downstream: drop the oldest queued buffer to make room."""
        try:
            dropped = self._q.get_nowait()
        except _queue.Empty:
            return
        self._count_drop()
        if dropped is self._EOS or isinstance(dropped, Event):
            return
        # a frame dropped AFTER stamp-admission leaves the admitted
        # population: revoke the stamp (a shared-meta consumer must not
        # report it as a served-latency outlier) and count the revocation
        if dropped.meta.pop("admitted_t", None) is not None:
            self._m_adm_revoked.inc()
        # it never reaches a fence: release its staged slabs now, not at GC
        release_shed_payload(dropped)

    def chain(self, pad, buf):
        fi = _faults.ACTIVE
        if fi is not None:
            # chaos hook (pipeline/faults.py): a raise here surfaces
            # through _chain_entry under THIS queue's error policy
            fi.check("queue.push",
                     seq=buf.meta.get(_timeline.TRACE_SEQ_META))
        if self.get_property("prefetch_host") and \
                not self.get_property("materialize_host"):
            # (materialize-host fetches on the worker side, grouped)
            buf = buf.prefetch_host()
        if self.get_property("prefetch_device"):
            # batch-h2d defers the upload to the worker, which coalesces
            # each gathered run into one staged window upload
            defer = (self.get_property("batch_h2d")
                     and self._worker is not None and not buf.on_device())
            if not defer:
                buf = self._upload_one(buf)
        self._tl_arrive(buf)
        if self._sched is not None and self._worker is not None:
            # SLO path: deadline admission + EDF heap; a rejected frame
            # never carries an admission stamp and is dropped here
            return self._chain_scheduled(buf)
        if self.get_property("stamp_admission") and \
                "admitted_t" not in buf.meta:
            buf.meta["admitted_t"] = time.monotonic()
            if self._m_admitted is not None:
                self._m_admitted.inc()
        if self._worker is None:  # not started: degenerate passthrough
            return self.srcpad.push(buf)
        if self.get_property("leaky") == "downstream":
            while True:
                try:
                    self._q.put_nowait(buf)
                    return FlowReturn.OK
                except _queue.Full:
                    self._drop_oldest()
        if self._stop_evt.is_set():
            return FlowReturn.EOS
        try:
            self._q.put_nowait(buf)
            return FlowReturn.OK
        except _queue.Full:
            pass
        # blocked from here: the wait counts whole, from before the first
        # poll (a put that never blocks reads no clock)
        t0 = time.monotonic()
        while not self._stop_evt.is_set():
            try:
                self._q.put(buf, timeout=0.1)
            except _queue.Full:
                continue
            t1 = time.monotonic()
            self._m_blocked.inc(t1 - t0)
            th = _timeline.THREADS
            if th is not None:
                th.span("wait_output", None, t0, t1, element=self.name)
            return FlowReturn.OK
        return FlowReturn.EOS

    def sink_event(self, pad, event):
        if self._worker is None:
            super().sink_event(pad, event)
            return
        if isinstance(event, EosEvent):
            # EOS is serialized: enqueue the sentinel in order, then block
            # until the worker has drained everything ahead of it and
            # forwarded EOS downstream (gst serialized-event semantics)
            self._q.put(self._EOS)
            self._eos_done.wait(timeout=30)
        else:
            self._q.put(event)

    # -- uploads (tensors/buffer.py upload_many) -----------------------------
    def _device_or_resolve(self) -> torch.device:
        if self._device is None:
            self._device = resolve_device()
        return self._device

    def _upload_one(self, buf):
        """Per-buffer upload (producer-side prefetch, run singletons,
        deferred-pad partial windows): the payload to the device, the
        pre-upload host arrays as the DeviceBuffer's host view, the pooled
        ones as its stash; then the deferred padding, on the device."""
        if not buf.on_device():
            pool = get_pool()
            stash = [t for t in buf.tensors if pool.owns(t)]
            host_src = list(buf.tensors)
            buf = as_device_buffer(buf.to_device(self._device_or_resolve()),
                                   host_view=host_src)
            buf.meta[H2D_EXCLUSIVE_META] = True
            if stash:
                # the copy reads the slabs after this returns, and so does
                # the dispatch: the window downstream releases them at its
                # fence
                buf.meta[POOL_STASH_META] = stash
        if buf.meta.get("pad_rows"):
            buf = buf.pad_rows_device()
        return buf

    def _upload_group(self, group: list) -> list:
        """One staged slab upload for ≥2 same-signature host buffers. The
        window slabs ride the LAST buffer's stash: the window fences in
        order, so by the time that fence releases them every dispatch
        that read the upload has completed."""
        pool = get_pool()
        stashes = [[t for t in b.tensors if pool.owns(t)] for b in group]
        devs, slabs = upload_many(group, self._device_or_resolve())
        for b, st in zip(devs, stashes):
            if st:
                b.meta[POOL_STASH_META] = st
        if slabs:
            last = devs[-1]
            last.meta[POOL_STASH_META] = list(
                last.meta.get(POOL_STASH_META) or []) + slabs
        return devs

    def _upload_run(self, run: list) -> list:
        """Split a drained run into maximal groups of consecutive host,
        same-shaped buffers and upload each group as one window slab;
        singletons, device buffers and deferred-pad partials go one by
        one."""
        def single(b) -> bool:
            return (b.on_device() or not b.tensors
                    or bool(b.meta.get("pad_rows"))
                    or not all(isinstance(t, np.ndarray) for t in b.tensors))

        out: list = []
        i = 0
        while i < len(run):
            b = run[i]
            if single(b):
                out.append(self._upload_one(b))
                i += 1
                continue
            sig = [(t.shape, t.dtype) for t in b.tensors]
            j = i + 1
            while j < len(run) and not single(run[j]) and \
                    [(t.shape, t.dtype) for t in run[j].tensors] == sig:
                j += 1
            if j - i >= 2:
                out.extend(self._upload_group(run[i:j]))
            else:
                out.append(self._upload_one(b))
            i = j
        return out

    def _flush_run(self, run: list) -> None:
        """Deliver a gathered run of data buffers: uploaded first with
        prefetch-device and batch-h2d; materialized as one group
        (materialize-host); as ONE list hand-off when the peer opts in;
        else one by one."""
        if not run:
            return
        if self.get_property("prefetch_device") and \
                self.get_property("batch_h2d"):
            run = self._upload_run(run)
        # queue residency ends at each frame's own hand-off (with tracing
        # on; one attribute read off), so a frame behind others in a
        # drained run is not left unattributed
        tl_on = _timeline.ACTIVE is not None
        if self.get_property("materialize_host"):
            # the residency pauses where the run's fetch starts: the fetch
            # is each frame's d2h stage, its finalize its decode stage
            # (tensors/buffer.py), and the wait behind the run's earlier
            # frames resumes it until the frame's own hand-off; the pause
            # and the fetch share one reading
            t_pause = None
            if tl_on:
                t_pause = time.monotonic()
                for it in run:
                    self._tl_depart(it, t_pause)
                    it.meta.pop(_timeline.HANDOFF_META, None)
            for host in materialize_many(run, t0=t_pause):
                self._undelivered -= 1
                if tl_on:
                    self._tl_depart(host)
                self.srcpad.push(host)
            return
        peer = self.srcpad.peer
        if len(run) > 1 and peer is not None and \
                getattr(peer.element, "HANDLES_LIST", False):
            self._undelivered -= len(run)
            if tl_on:
                for it in run:
                    self._tl_depart(it)
            self.srcpad.push_list(run)
            return
        for it in run:
            self._undelivered -= 1
            if tl_on:
                self._tl_depart(it)
            self.srcpad.push(it)

    def _drain(self):
        drain_max = max(1, int(self.get_property("drain_batch")))
        while not self._stop_evt.is_set():
            item = poll_get(self._q, self._stop_evt, self.name)
            if item is None:
                return
            # with thread spans on, the worker's pass over what it drained
            # (uploads, a fetch, the hand-offs) is a chain span of its own
            th = _timeline.THREADS
            t_pass = time.monotonic() if th is not None else 0.0
            go_on = self._drain_pass(item, drain_max)
            if th is not None:
                th.span("chain", None, t_pass, time.monotonic(),
                        element=self.name)
            if not go_on:
                return

    def _drain_pass(self, item, drain_max: int) -> bool:
        """Gather what is queued behind ``item`` and hand it on; False
        once the worker is done (EOS passed on, or a downstream error
        posted)."""
        batch = [item]
        if drain_max > 1 and not isinstance(item, Event) and \
                item is not self._EOS:
            # gather whatever is ALREADY queued (never wait); events
            # end a gathering and stay serialized with the data
            while len(batch) < drain_max:
                try:
                    nxt = self._q.get_nowait()
                except _queue.Empty:
                    break
                batch.append(nxt)
                if nxt is self._EOS or isinstance(nxt, Event):
                    break
        ndata = sum(1 for it in batch
                    if it is not self._EOS and not isinstance(it, Event))
        self._undelivered += ndata
        if ndata:
            self._m_drain.observe(ndata)
        run: list = []
        try:
            for it in batch:
                if it is self._EOS or isinstance(it, Event):
                    # events delimit runs: the data ahead goes first
                    self._flush_run(run)
                    run = []
                    if it is self._EOS:
                        self.srcpad.push_event(EosEvent())
                        self._eos_done.set()
                        return False
                    self.srcpad.push_event(it)
                else:
                    run.append(it)
            self._flush_run(run)
        except Exception as e:  # noqa: BLE001 — downstream failures
            # must reach the bus, not silently kill this worker thread
            self.post_error(e if isinstance(e, FlowError)
                            else FlowError(f"{self.name}: {e}"))
            self._eos_done.set()
            return False
        return True

    # -- SLO scheduler mode (serving/scheduler.py) ---------------------------
    def _chain_scheduled(self, buf) -> FlowReturn:
        """Producer side of scheduler mode: deadline admission, EDF
        enqueue, late-first shedding on overflow. With a uniform budget
        deadlines are monotone in arrival order, so an unloaded queue's
        pop order equals FIFO — byte-identical output."""
        sched = self._sched
        now = time.monotonic()
        with self._edf_lock:
            backlog = len(self._edf) + self._undelivered
        if not sched.admit(buf, now=now, backlog=backlog,
                           budget_ms=self._budget_ms):
            # rejected at the door, never admitted: nothing staged for it
            # reaches a fence
            self._count_drop()
            release_shed_payload(buf)
            return FlowReturn.OK
        self._m_admitted.inc()
        cap = int(self.get_property("max_size_buffers"))
        shed = None
        with self._edf_lock:
            self._edf_seq += 1
            heapq.heappush(self._edf,
                           (buf.meta["deadline_t"], self._edf_seq, buf))
            if cap > 0 and len(self._edf) > cap:
                shed = self._shed_one_locked(now)
        if shed is not None:
            sched.note_shed(shed, now)
            self._m_adm_revoked.inc()
            self._count_drop()
        self._q.put_nowait(self._TOKEN)  # wake the worker (unbounded)
        return FlowReturn.OK

    def _shed_one_locked(self, now: float):
        """The overflow victim (caller holds ``_edf_lock``): late-first —
        the MOST-late frame (the heap root, if its deadline passed) sheds
        before any on-time one; with nothing late, the least-urgent
        (latest-deadline) frame goes."""
        if self._edf[0][0] <= now:
            return heapq.heappop(self._edf)[2]
        i = max(range(len(self._edf)), key=lambda j: self._edf[j][0])
        victim = self._edf[i][2]
        last = self._edf.pop()
        if i < len(self._edf):
            self._edf[i] = last
            heapq.heapify(self._edf)
        return victim

    def _flush_edf(self, limit: Optional[int]) -> None:
        """Batch former: pop up to ``limit`` admitted frames in EDF order
        and deliver them as one run (one ``push_list`` to a HANDLES_LIST
        peer: the downstream dispatch window's fence is the free-slot
        backpressure). A frame whose deadline passed while it sat in the
        heap is shed here, not delivered; on the per-frame hand-off path
        the deadline is tested again right before each push. An unloaded
        pipeline never goes late, so its output equals the FIFO's."""
        now = time.monotonic()
        shed: list = []
        with self._edf_lock:
            n = len(self._edf) if limit is None \
                else min(max(1, limit), len(self._edf))
            run = []
            while self._edf and len(run) < n:
                deadline_t, _seq, buf = heapq.heappop(self._edf)
                if deadline_t <= now:
                    shed.append(buf)
                else:
                    run.append(buf)
        if run:
            self._undelivered += len(run)
            self._m_drain.observe(len(run))
            peer = self.srcpad.peer
            if len(run) > 1 and not self.get_property("materialize_host") \
                    and peer is not None \
                    and getattr(peer.element, "HANDLES_LIST", False):
                self._flush_run(run)
            else:
                for it in run:
                    if it.meta["deadline_t"] <= time.monotonic():
                        self._undelivered -= 1
                        shed.append(it)
                        continue
                    self._flush_run([it])
        for buf in shed:
            self._sched.note_shed(buf, time.monotonic())
            self._m_adm_revoked.inc()
            self._count_drop()

    def _drain_sched(self):
        """Scheduler-mode worker: wake tokens pop EDF runs capped by the
        feedback controller; events and EOS flush all pending data first
        (EDF order), so an event never overtakes data queued ahead of
        it."""
        sched = self._sched
        while not self._stop_evt.is_set():
            try:
                item = self._q.get(timeout=0.1)
            except _queue.Empty:
                continue
            try:
                if item is self._EOS or isinstance(item, Event):
                    self._flush_edf(None)
                    if item is self._EOS:
                        self.srcpad.push_event(EosEvent())
                        self._eos_done.set()
                        return
                    self.srcpad.push_event(item)
                else:
                    # a shed frame leaves its wake token behind: the token
                    # then pops an empty heap, a cheap no-op
                    self._flush_edf(sched.batch_cap())
            except Exception as e:  # noqa: BLE001 — downstream failures
                # must reach the bus, not silently kill this worker
                self.post_error(e if isinstance(e, FlowError)
                                else FlowError(f"{self.name}: {e}"))
                self._eos_done.set()
                return


class Pipeline:
    """Element container + source threads + bus.

    The keyword arguments are the JAX package's. ``fuse`` (default True)
    splices fused regions at ``start()``; ``lanes`` (default 1, the
    serial path) splices ingest lanes behind each source after fusion;
    ``error_policy`` is the default error policy of every element;
    ``watchdog_s`` > 0 arms the liveness watchdog; ``slo_budget_ms`` > 0
    attaches the SLO scheduler at ``start()``; ``flight_dir`` (set before
    ``start()``) arms the flight recorder's tail dumps."""

    def __init__(self, name: str = "pipeline", fuse: bool = True,
                 lanes: int = 1, slo_budget_ms: float = 0.0,
                 error_policy: Optional[str] = None,
                 watchdog_s: float = 0.0):
        self.name = name
        self.elements: List[Element] = []
        self.by_name: Dict[str, Element] = {}
        self.state = State.NULL
        self._bus: _queue.Queue = _queue.Queue()
        self._threads: List[threading.Thread] = []
        self._eos_pending = 0
        self._fuse = fuse
        #: fused regions (pipeline/fuse.py), spliced at the first start()
        #: and kept across restarts
        self._regions: Optional[list] = None
        #: requested ingest lane count (pipeline/lanes.py); 1 = serial
        #: path, NNSTPU_LANES overrides at start()
        self.lanes = lanes
        #: lane executors, spliced at the first start() after fusion and
        #: kept across restarts
        self._lane_execs: Optional[list] = None
        #: pipeline-default error policy (pipeline/supervise.py): elements
        #: without their own ``error-policy`` inherit it; None = halt
        self.error_policy = error_policy
        #: watchdog deadline in seconds (>0 arms PipelineWatchdog at
        #: start()); NNSTPU_WATCHDOG_S applies when it is 0
        self.watchdog_s = float(watchdog_s or 0.0)
        self._watchdog = None
        #: pipeline-wide SLO budget in ms (serving/scheduler.py); > 0
        #: attaches deadline admission, EDF and feedback control to the
        #: admission-point queues at start(). 0 with no queue budget = no
        #: scheduler object at all
        self.slo_budget_ms = float(slo_budget_ms or 0.0)
        self._slo_scheduler = None
        #: tail-event dump directory of the flight recorder
        #: (obs/flight.py); None defers to NNSTPU_FLIGHT. The recorder
        #: itself is always on unless NNSTPU_FLIGHT=0
        self.flight_dir: Optional[str] = None
        self._flight = None
        #: serving-continuity checkpoint directory
        #: (pipeline/continuity.py); None defers to NNSTPU_CHECKPOINT.
        #: Unset, the continuity layer never runs
        self.checkpoint_dir: Optional[str] = None
        self._continuity_restored = False
        #: holds a reference on the process's GC hook (obs/timeline.py)
        #: while PLAYING
        self._gc_hooked = False
        # export per-element latency/throughput gauges at scrape time
        # (weakref-bound: a collected pipeline unregisters itself)
        register_pipeline_collector(self)

    # -- construction ---------------------------------------------------------
    def add(self, *elements: Element) -> "Pipeline":
        for el in elements:
            if el.name in self.by_name:
                raise ValueError(f"duplicate element name {el.name!r}")
            el.pipeline = self
            self.elements.append(el)
            self.by_name[el.name] = el
        return self

    def add_linked(self, *elements: Element) -> "Pipeline":
        """Add elements and link them in sequence."""
        self.add(*elements)
        for a, b in zip(elements, elements[1:]):
            a.link(b)
        return self

    def get(self, name: str) -> Element:
        return self.by_name[name]

    def verify(self):
        """Static pre-flight of the constructed graph (no buffers run):
        dangling pads, cycles, sync-policy conflicts, tee fan-out without
        queues. A list of ``analysis.Diagnostic``, empty when the graph
        is clean."""
        from nnstreamer_tpu_torch.analysis.verify import verify_pipeline

        return verify_pipeline(self)

    def to_dot(self) -> str:
        """Graphviz dot text of the current runtime graph (fused regions
        as clusters) — ``pipeline/dot.py``."""
        from nnstreamer_tpu_torch.pipeline.dot import pipeline_to_dot

        return pipeline_to_dot(self)

    def metrics_snapshot(self) -> Dict[str, Any]:
        """In-process structured metrics read: one dict per element with
        the reference-style windowed stats plus element-specific extras."""
        elements: Dict[str, Any] = {}
        for el in self.elements:
            # a fused member whose chain does not run reads its region's
            stats = el._metrics_stats()
            entry: Dict[str, Any] = {
                "type": el.ELEMENT_NAME,
                "latency_us": stats.latency_us,
                "throughput_milli": stats.throughput_milli,
                "invokes": stats.total_invokes,
            }
            entry.update(el.obs_snapshot())
            elements[el.name] = entry
        out = {"pipeline": self.name, "state": self.state.value,
               "elements": elements}
        if pool_enabled():
            # the process-wide staging pool (sources, converters and
            # aggregators share it): is the hot path recycling?
            out["pool"] = get_pool().snapshot()
        if self._lane_execs:
            # lane executors are spliced, not in self.elements
            out["lanes"] = {ex.name: ex.obs_snapshot()
                            for ex in self._lane_execs}
        if self._regions:
            # regions are spliced, not in self.elements: their dispatch
            # counts (eager frames, replays, captures, retraces)
            out["regions"] = {r.name: {"members": [m.name for m in r.members],
                                       "unspliced": r._dead,
                                       **r.obs_snapshot()}
                              for r in self._regions}
        if self._slo_scheduler is not None:
            out["scheduler"] = self._slo_scheduler.snapshot()
        if _memory.ACTIVE is not None:
            out["memory"] = _memory.ACTIVE.snapshot()
        if self._flight is not None:
            # the always-on flight recorder: streaming stage/e2e
            # quantiles and burn rates, the continuous variance
            # attribution, and the raw P² marker states per stage
            out["slo"] = self._flight.slo_snapshot()
            out["attribution"] = self._flight.attribution()
            out["quantiles"] = self._flight.quantile_states()
        return out

    # -- serving continuity (pipeline/continuity.py) ---------------------------
    def swap_model(self, filter_name: str, model: Optional[str] = None,
                   weights: Any = None) -> Dict[str, Any]:
        """Zero-downtime versioned model swap on a running pipeline: drain
        the owning dispatch window (the cutover fence), install the new
        model or weights (a state dict) under a bumped epoch, touch the
        owning fused region once. No frames are dropped."""
        from nnstreamer_tpu_torch.pipeline import continuity as _continuity

        return _continuity.swap_model(self, filter_name, model=model,
                                      weights=weights)

    def checkpoint(self, directory: Optional[str] = None) -> str:
        """Serialize the durable serving state (repo slots, scheduler
        EWMAs and knobs, residency LRU order, flight-recorder quantiles)
        into ``directory`` — defaults to ``checkpoint_dir`` /
        ``NNSTPU_CHECKPOINT``."""
        from nnstreamer_tpu_torch.pipeline import continuity as _continuity

        return _continuity.checkpoint(self, directory)

    def restore(self, directory: Optional[str] = None) -> Dict[str, Any]:
        """Re-arm the warm serving state from a checkpoint written by
        :meth:`checkpoint` (typically in a previous process)."""
        from nnstreamer_tpu_torch.pipeline import continuity as _continuity

        return _continuity.restore(self, directory)

    # -- state ----------------------------------------------------------------
    def _plan_mesh(self) -> None:
        """The serving mesh (``parallel/serve.py``), once every region and
        backend holds its plan: verify the matched-sharding contract
        across device-passthrough boundaries (a mismatch is a hard
        ``MeshShardingError`` here, before any frame could reshard), then
        align the SLO scheduler's admission quantum and the batch formers'
        windows to the mesh's fan-out so batches split evenly. Both are
        no-ops without a ``mesh=`` property (or with ``NNSTPU_MESH=0``)."""
        from nnstreamer_tpu_torch.pipeline.fuse import (
            pipeline_shard_count,
            verify_mesh_boundaries,
        )

        verify_mesh_boundaries(self)
        quantum = pipeline_shard_count(self)
        if self._slo_scheduler is not None:
            self._slo_scheduler.note_mesh(quantum)
        if quantum > 1:
            for el in self.elements:
                hook = getattr(el, "note_mesh_quantum", None)
                if hook is not None:
                    hook(quantum)

    def start(self) -> "Pipeline":
        """NULL→PLAYING: start all elements (non-sources first so queues and
        filters are ready), splice fused regions over them and then ingest
        lanes behind the sources (once; both persist across restarts),
        spawn one streaming thread per source, and arm the watchdog."""
        if self.state is State.PLAYING:
            return self
        # the frame ledger and fault injection from the environment, before
        # any element starts, so the source stamp and every hook see them;
        # unset, both stay None and every site is one attribute read
        _timeline.maybe_activate_env()
        _faults.maybe_activate_env()
        # the HBM accountant (NNSTPU_HBM_BUDGET) before any backend opens,
        # and the kernels' compile cache before any kernel builds; unset,
        # both are env reads
        _memory.maybe_activate_env()
        from nnstreamer_tpu_torch.pipeline import continuity as _continuity

        _continuity.maybe_default_compile_cache(self)
        sources = [e for e in self.elements if isinstance(e, SourceElement)]
        others = [e for e in self.elements
                  if not isinstance(e, SourceElement)]
        # the SLO scheduler before any element starts: admission-point
        # queues bind to it in their start(). No budget anywhere, no
        # scheduler object
        if self._slo_scheduler is None and (
                self.slo_budget_ms > 0
                or any(float(el._props.get("slo_budget_ms") or 0.0) > 0
                       for el in self.elements)):
            from nnstreamer_tpu_torch.serving.scheduler import (
                ensure_scheduler,
            )

            ensure_scheduler(self)
        # the always-on flight recorder, after the scheduler (so the SLO
        # budget is known) and only when no explicit or env timeline owns
        # the ledger slot; NNSTPU_FLIGHT=0 keeps ACTIVE None
        from nnstreamer_tpu_torch.obs import flight as _flight

        fr = _flight.maybe_install(self)
        if fr is not None:
            self._flight = fr
        # a restart streams anew: the last run's EOS no longer holds
        for el in self.elements + (self._regions or []) + \
                (self._lane_execs or []):
            for pad in el.sinkpads + el.srcpads:
                pad.eos = False
        started: List[Element] = []
        try:
            for el in others:
                el.start()
                started.append(el)
            # region fusion after backends opened, before any buffer flows
            if self._fuse and fusion_enabled() and self._regions is None:
                self._regions = fuse_pipeline(self)
            for r in self._regions or ():
                r.start()
                started.append(r)
            self._plan_mesh()
            # lanes after fusion: a transform folded into a region is out
            # of the replicable segment, so its math stays in the graph
            if self._lane_execs is None:
                from nnstreamer_tpu_torch.pipeline.lanes import (
                    effective_lanes,
                    splice_lanes,
                )

                self._lane_execs = splice_lanes(
                    self, effective_lanes(self.lanes))
            for ex in self._lane_execs:
                ex.start()
                started.append(ex)
            # the warm serving state, after the scheduler, the flight
            # recorder and the residency units exist and before any frame
            _continuity.maybe_restore_env(self)
            for el in sources:
                el.start()
                started.append(el)
        except Exception:
            for el in reversed(started):
                el.stop()
            if fr is not None:
                _flight.retire(fr)
            raise
        self.state = State.PLAYING
        # GC pauses into nns_gc_pause_seconds (and gc spans when thread
        # spans are on), one hook a process
        _timeline.gc_hook_acquire()
        self._gc_hooked = True
        # GST_DEBUG_DUMP_DOT_DIR's counterpart (pipeline/dot.py), after
        # fusion so the dump shows the regions that will run
        from nnstreamer_tpu_torch.pipeline.dot import maybe_dump_dot

        maybe_dump_dot(self)
        self._eos_pending = len(sources)
        for src in sources:
            t = threading.Thread(
                target=src.run_loop, args=(self,),
                name=f"{self.name}:{src.name}", daemon=True
            )
            self._threads.append(t)
            t.start()
        wd_s = self._effective_watchdog_s()
        if wd_s > 0 and self._watchdog is None:
            from nnstreamer_tpu_torch.pipeline.supervise import (
                PipelineWatchdog,
            )

            self._watchdog = PipelineWatchdog(self, wd_s)
            self._watchdog.start()
        return self

    def threads(self) -> List[threading.Thread]:
        """Every thread this pipeline runs: one a source, and each
        element's and lane executor's own (``Element.threads``)."""
        out = list(self._threads)
        for el in self.elements + (self._lane_execs or []):
            out.extend(el.threads())
        return out

    def _effective_watchdog_s(self) -> float:
        if self.watchdog_s > 0:
            return self.watchdog_s
        raw = os.environ.get("NNSTPU_WATCHDOG_S", "").strip()
        if not raw:
            return 0.0
        try:
            return float(raw)
        except ValueError:
            log.warning("NNSTPU_WATCHDOG_S=%r is not a number; watchdog "
                        "stays off", raw)
            return 0.0

    def stop(self) -> "Pipeline":
        if self.state is State.NULL:
            return self
        # watchdog first: teardown quiescence must not read as a stall
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None
        # an injected stall models a hung device; teardown ends it
        fi = _faults.ACTIVE
        if fi is not None:
            fi.release_stalls()
        for el in self.elements:
            if isinstance(el, SourceElement):
                el.stop()
        for t in self._threads:
            t.join(timeout=10)
        self._threads.clear()
        # lane executors stop after their upstream source threads and
        # before the elements they feed
        for ex in self._lane_execs or ():
            ex.stop()
        for el in self.elements:
            if not isinstance(el, SourceElement):
                el.stop()
        for r in self._regions or ():
            r.stop()
        # a stopped pipeline holds no free staging slabs (shared pool and
        # lane arenas)
        release_all_pools()
        self.state = State.NULL
        if self._gc_hooked:
            _timeline.gc_hook_release()
            self._gc_hooked = False
        # every element is stopped and every window drained: a consistent
        # checkpoint when armed (one env read otherwise)
        from nnstreamer_tpu_torch.pipeline import continuity as _continuity

        _continuity.maybe_checkpoint_on_stop(self)
        # retire the flight recorder before the env-owned export check: a
        # pending tail dump near EOS flushes here, and the recorder stays
        # on self._flight for the caller to read
        if self._flight is not None:
            from nnstreamer_tpu_torch.obs import flight as _flight

            _flight.retire(self._flight)
        # an env-owned timeline (NNSTPU_TRACE=<path>) exports its ledger
        # once the run is over; an explicitly installed one is the
        # caller's to export
        _timeline.maybe_export_env()
        return self

    # -- bus ------------------------------------------------------------------
    def post_message(self, msg: Message) -> None:
        self._bus.put(msg)

    def post_error(self, source: Element, error: Exception) -> None:
        log.error("pipeline %s: error from %s: %s", self.name,
                  source.name if source else "?", error)
        self._bus.put(Message("error", source, error))

    def post_warning(self, source: Optional[Element], text: str) -> None:
        """Non-fatal bus message: logged, delivered to ``pop_message``
        readers, and skipped over by ``wait()``."""
        log.warning("pipeline %s: warning from %s: %s", self.name,
                    source.name if source else "?", text)
        self._bus.put(Message("warning", source, text=text))

    def pop_message(self, timeout: Optional[float] = None
                    ) -> Optional[Message]:
        try:
            return self._bus.get(timeout=timeout)
        except _queue.Empty:
            return None

    def wait(self, timeout: Optional[float] = None) -> Optional[Message]:
        """Block until every source reached EOS (returns the final EOS
        message) or any element errored (returns the error message);
        None on timeout."""
        remaining = self._eos_pending
        t_end = None if timeout is None else time.monotonic() + timeout
        while True:
            t_left = None if t_end is None else max(0.0,
                                                    t_end - time.monotonic())
            msg = self.pop_message(timeout=t_left)
            if msg is None:
                return None
            if msg.kind == "error":
                return msg
            if msg.kind == "eos":
                remaining -= 1
                if remaining <= 0:
                    return msg

    def run(self, timeout: Optional[float] = None) -> Optional[Message]:
        """start() + wait() + stop(); raises on an error message."""
        self.start()
        try:
            msg = self.wait(timeout=timeout)
            if msg is not None and msg.kind == "error":
                raise FlowError(str(msg.error)) from msg.error
            return msg
        finally:
            self.stop()

