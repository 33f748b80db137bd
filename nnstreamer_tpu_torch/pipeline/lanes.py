"""Parallel ingest lanes — ordered multi-worker ingest.

Port of ``nnstreamer_tpu/pipeline/lanes.py``. Everything upstream of a
pipeline's first ``queue`` runs on ONE streaming thread (the source's
``run_loop`` drives the chain as plain calls). This module replicates
the *replicable* part of that pre-queue segment across N worker lanes
while keeping the stream order contract exact:

- The source keeps its single ``create()`` loop (acquisition is cheap and
  inherently ordered); every frame is stamped with a **monotone sequence
  number** at the executor's sink pad and round-robined to a lane.
- Each lane owns private **clones** of the segment elements (same type,
  same properties) so no per-frame state is ever shared, plus a private
  :func:`~nnstreamer_tpu_torch.tensors.pool.get_lane_pool` arena: the
  first thing a lane does is copy the frame into a page-locked staging
  slab — a numpy ``copyto`` that releases the GIL, so lanes overlap even
  when the per-frame math runs on the card.
- Outputs reassemble through a **bounded reorder buffer**; a single drain
  pushes them downstream strictly in sequence order, so the bytes, the
  order, and the EOS drain are identical to the serial path.

Which elements replicate is decided by :meth:`Element.reorder_safe`
(class flag ``REORDER_SAFE``): the walk from the source stops at the
first stateful / multi-pad element, queue, or fused region. Lanes splice
after ``fuse_pipeline``, so a ``tensor_transform`` adjacent to a filter
is already inside the region's CUDA graph (kernel B1) and out of the
segment: lane workers spend their time in numpy and copy code. A lane
worker makes no CUDA call but the page-locking of a new slab and the
pool's copy-event query (``tensors/pool.py``).

``lanes=1`` (or the ``NNSTPU_LANES=1`` kill switch) leaves the pipeline
untouched — the exact serial code path. Observability:
``nns_lane_occupancy`` (busy lanes), ``nns_lane_reorder_stall_seconds``
(worker time blocked on a full reorder buffer — head-of-line pressure),
and ``nns_ingest_fps`` (frames forwarded downstream per second), all in
``Pipeline.metrics_snapshot()`` under ``lanes``.
"""

from __future__ import annotations

import collections
import os
import queue as _queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.obs import timeline as _timeline
from nnstreamer_tpu_torch.pipeline import faults as _faults
from nnstreamer_tpu_torch.pipeline.element import (
    CapsEvent,
    Element,
    EosEvent,
    Event,
    FlowError,
    FlowReturn,
    Pad,
)
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

log = get_logger("lanes")

#: sequence stamp carried in buffer meta (observability; the reorder
#: machinery itself threads (seq, buf) pairs explicitly)
LANE_SEQ_META = "lane_seq"

#: how long a serialized EOS may wait for the reorder drain (mirrors
#: Queue's serialized-EOS timeout)
_EOS_DRAIN_TIMEOUT_S = 30.0


def lanes_override() -> Optional[int]:
    """The ``NNSTPU_LANES`` env override: ``1`` is the kill switch that
    restores the serial path regardless of configuration, higher values
    force that lane count. Unset/invalid → None (use the configured
    value)."""
    raw = os.environ.get("NNSTPU_LANES", "").strip()
    if not raw:
        return None
    try:
        return max(1, int(raw))
    except ValueError:
        log.warning("NNSTPU_LANES=%r is not an int; ignoring", raw)
        return None


def effective_lanes(requested: int) -> int:
    """The lane count a pipeline actually runs: env override first, then
    the pipeline's configured ``lanes``."""
    env = lanes_override()
    if env is not None:
        return env
    try:
        return max(1, int(requested or 1))
    except (TypeError, ValueError):
        return 1


def _single_io(el: Element) -> bool:
    return len(el.sinkpads) == 1 and len(el.srcpads) == 1


def _tl_seq(items: List[Tuple[str, Any]]) -> Optional[int]:
    """Trace context of a reorder slot: the first buffer's stamped
    frame-ledger seq (obs/timeline.py); event-only slots have none."""
    for kind, payload in items:
        if kind == "buf":
            return payload.meta.get(_timeline.TRACE_SEQ_META)
    return None


class _LaneTail(Element):
    """Terminal collector of one lane's clone chain: records everything
    the segment emits (buffers AND events, in emission order) so the
    worker can hand the frame's complete output to the reorder buffer as
    one ordered unit."""

    ELEMENT_NAME = "lane_tail"
    HANDLES_DEFERRED = True   # never force a deferred finalize
    DEVICE_PASSTHROUGH = True  # never materialize a resident payload

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        #: ("buf", TensorBuffer) | ("event", Event), single-threaded per
        #: lane (only that lane's worker — or the negotiating source
        #: thread, never both at once — drives this chain)
        self.items: List[Tuple[str, Any]] = []

    def chain(self, pad, buf):
        self.items.append(("buf", buf))
        return FlowReturn.OK

    def sink_event(self, pad, event):
        self.items.append(("event", event))

    def take(self) -> List[Tuple[str, Any]]:
        out, self.items = self.items, []
        return out


class IngestLanes(Element):
    """The lane executor, spliced between a source and its replicable
    segment's downstream peer (same splice mechanics as
    :class:`~nnstreamer_tpu_torch.pipeline.fuse.FusedRegion`). The original
    segment elements stay in the pipeline but no buffers flow through
    them; per-lane clones do the work."""

    ELEMENT_NAME = "ingest_lanes"
    HANDLES_DEFERRED = True
    DEVICE_PASSTHROUGH = True
    PROPERTIES = {**Element.PROPERTIES,
                  #: reorder-buffer capacity in frames ahead of the next
                  #: in-order sequence; 0 = auto (2× lane count, min 8)
                  "reorder_capacity": 0}

    def __init__(self, source: Element, segment: List[Element],
                 lanes: int, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        self.source = source
        self.segment: List[Element] = list(segment)
        self.n = max(2, int(lanes))
        # lane machinery (built per start(): a restart picks up property
        # edits on the originals and starts from clean clone state)
        self._heads: List[Element] = []
        self._tails: List[_LaneTail] = []
        self._clones: List[List[Element]] = []
        self._lane_qs: List[_queue.Queue] = []
        self._pools: List[Any] = []
        self._stage_win: dict = {}
        self._busy: List[bool] = []
        self._workers: List[threading.Thread] = []
        self._drainer: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        # sequence / reorder state — _seq is written only by the single
        # upstream streaming thread; _pending/_next under _cv
        self._seq = 0
        self._next = 0
        #: slots fully pushed downstream (bumped AFTER _forward returns —
        #: _next alone would let a serialized EOS overtake the final
        #: frame, which the drain thread pops before it pushes)
        self._delivered = 0
        self._pending: Dict[int, List[Tuple[str, Any]]] = {}
        #: reorder-buffer entry stamps for the frame ledger (tracing
        #: only; keyed like _pending, maintained under _cv)
        self._pending_t: Dict[int, float] = {}
        self._cv = threading.Condition()
        self._forwarded = 0
        self._fwd_times: collections.deque = collections.deque(maxlen=256)
        self._last_caps_str: Optional[str] = None
        #: last negotiated caps — replayed through a restarted lane's
        #: fresh clone chain so it is negotiated like its predecessor
        self._saved_caps = None
        self._m_stall = None  # lazy: labels need the owning pipeline
        self._m_leaked = None
        self._m_restarts = None

    # -- capacity ------------------------------------------------------------
    def _capacity(self) -> int:
        cap = int(self.get_property("reorder_capacity") or 0)
        return cap if cap > 0 else max(8, 2 * self.n)

    # -- obs -----------------------------------------------------------------
    def _obs_init(self) -> None:
        import weakref

        reg = get_registry()
        labels = self._obs_labels()
        self._m_stall = reg.counter(
            "nns_lane_reorder_stall_seconds",
            "Cumulative lane-worker time blocked on a full reorder "
            "buffer (head-of-line pressure from a slow lane)", **labels)
        self._m_leaked = reg.counter(
            "nns_lane_leaked_threads_total",
            "Lane executor threads that failed to join within the "
            "stop() timeout (leaked past teardown)", **labels)
        self._m_restarts = reg.counter(
            "nns_fault_lane_restarts_total",
            "Lane worker clone-chain restarts under supervision",
            **labels)
        ref = weakref.ref(self)
        reg.gauge(
            "nns_lane_occupancy",
            "Lane workers currently processing a frame",
            fn=lambda: (sum(ref()._busy) if ref() is not None else 0),
            **labels)
        reg.gauge(
            "nns_ingest_fps",
            "Frames the lane executor forwarded downstream per second "
            "(recent window)",
            fn=lambda: (ref()._ingest_fps() if ref() is not None else 0.0),
            **labels)

    def _ingest_fps(self) -> float:
        times = list(self._fwd_times)
        if len(times) < 2:
            return 0.0
        span = times[-1] - times[0]
        return (len(times) - 1) / span if span > 0 else 0.0

    def obs_snapshot(self):
        out = super().obs_snapshot()
        with self._cv:
            reorder_depth = len(self._pending)
        out.update({
            "lanes": self.n,
            "occupancy": sum(self._busy),
            "reorder_depth": reorder_depth,
            "reorder_capacity": self._capacity(),
            "forwarded": self._forwarded,
            "ingest_fps": round(self._ingest_fps(), 2),
        })
        if self._m_stall is not None:
            out["reorder_stall_s"] = round(self._m_stall.value, 4)
        return out

    # -- lane construction ---------------------------------------------------
    def _clone_of(self, el: Element, lane: int) -> Element:
        props = {k: v for k, v in el._props.items() if k != "name"}
        clone = type(el)(name=f"{el.name}~l{lane}", **props)
        clone.pipeline = self.pipeline  # metric labels / error context
        return clone

    def _build_lanes(self) -> None:
        from nnstreamer_tpu_torch.tensors.pool import get_lane_pool, pool_enabled

        self._heads, self._tails, self._clones = [], [], []
        self._lane_qs, self._pools = [], []
        #: per-lane rolling staging windows (id(pool) → window state);
        #: single-writer per entry — only that lane's worker
        self._stage_win = {}
        self._busy = [False] * self.n
        for k in range(self.n):
            clones = [self._clone_of(el, k) for el in self.segment]
            tail = _LaneTail(name=f"{self.name}~tail{k}")
            tail.pipeline = self.pipeline
            for a, b in zip(clones, clones[1:]):
                a.srcpads[0].link(b.sinkpads[0])
            clones[-1].srcpads[0].link(tail.sinkpads[0])
            for c in clones:
                c.start()
            self._clones.append(clones)
            self._heads.append(clones[0])
            self._tails.append(tail)
            # small per-lane feed queue: enough to keep the lane busy,
            # small enough that backpressure reaches the source promptly
            self._lane_qs.append(_queue.Queue(maxsize=4))
            self._pools.append(get_lane_pool(k) if pool_enabled() else None)

    # -- state ---------------------------------------------------------------
    def start(self):
        super().start()
        self._stop_evt.clear()
        self._seq = 0
        self._next = 0
        self._delivered = 0
        self._pending = {}
        self._pending_t = {}
        self._forwarded = 0
        self._fwd_times.clear()
        self._last_caps_str = None
        self._build_lanes()
        if self._m_stall is None:
            self._obs_init()
        self._workers = []
        for k in range(self.n):
            t = threading.Thread(target=self._worker, args=(k,),
                                 name=f"{self.name}-lane{k}", daemon=True)
            self._workers.append(t)
            t.start()
        self._drainer = threading.Thread(target=self._drain_loop,
                                         name=f"{self.name}-drain",
                                         daemon=True)
        self._drainer.start()

    def stop(self):
        self._stop_evt.set()
        with self._cv:
            self._cv.notify_all()
        for k, t in enumerate(self._workers):
            t.join(timeout=5)
            if t.is_alive():
                self._count_leaked(f"lane {k} worker", t)
        self._workers = []
        if self._drainer is not None:
            self._drainer.join(timeout=5)
            if self._drainer.is_alive():
                self._count_leaked("drain thread", self._drainer)
            self._drainer = None
        for clones in self._clones:
            for c in clones:
                c.stop()
        super().stop()

    def _count_leaked(self, what: str, thread: threading.Thread) -> None:
        """A join timed out: the thread outlives the executor. Silent
        before — now every leak is logged with its identity and counted
        (``nns_lane_leaked_threads_total``) so teardown hangs show up in
        tests and on dashboards instead of as mystery threads."""
        self.log.warning(
            "%s: %s (%s) did not join within 5s at stop(); thread leaked",
            self.name, what, thread.name)
        if self._m_leaked is not None:
            self._m_leaked.inc()

    # -- splicing ------------------------------------------------------------
    def splice(self, pipe) -> None:
        self.pipeline = pipe
        first, last = self.segment[0], self.segment[-1]
        up_src = first.sinkpads[0].peer  # the source's src pad
        down_sink = last.srcpads[0].peer
        if up_src is not None:
            up_src.unlink()
            up_src.link(self.sinkpad)
        if down_sink is not None:
            last.srcpads[0].unlink()
            self.srcpad.link(down_sink)
        log.info("ingest lanes: %s (%d lanes over [%s])", self.name,
                 self.n, "+".join(el.name for el in self.segment))

    # -- hot path ------------------------------------------------------------
    def chain(self, pad, buf):
        seq = self._seq
        self._seq = seq + 1
        buf.meta[LANE_SEQ_META] = seq
        q = self._lane_qs[seq % self.n]
        # a parked source (stop(), a watchdog trip) must not stay blocked
        # on a full lane feed until the executor itself stops
        src_stop = getattr(self.source, "_stop_evt", None)
        while not self._stop_evt.is_set() and not (
                src_stop is not None and src_stop.is_set()):
            try:
                q.put((seq, buf), timeout=0.1)
                return FlowReturn.OK
            except _queue.Full:
                continue
        # never fed: the slot must not exist, or the EOS drain would wait
        # for it (single writer: this streaming thread)
        self._seq = seq
        return FlowReturn.EOS

    #: frames staged per rolling window slab (per lane, per tensor): the
    #: lane writes successive frames into successive SLOTS of one
    #: contiguous pool slab instead of per-frame staging buffers, so a
    #: downstream batched upload (``tensors/buffer.py`` ``upload_many``)
    #: re-wraps a drained run as the stacked H2D view with zero extra
    #: host copies (``pool.contiguous_window_view``)
    STAGE_WINDOW_FRAMES = 8

    def _stage_copy(self, buf: TensorBuffer, pool) -> TensorBuffer:
        """Copy host payloads into this lane's private pool arena: the
        GIL-releasing memcpy that makes lane parallelism real even when
        the per-frame math was folded on-device, and the reason a source
        frame (possibly a shared cached array or another pool's slab)
        never couples lanes through slab refcounts.

        Frames land in consecutive slots of a rolling window slab
        (single-writer: only this lane's worker touches its window
        state). A signature change or a full window rolls to a fresh
        slab; old slabs stay alive through their live slot views (the
        pool's refcount guard) and fall to GC when the last reader
        drops."""
        if pool is None or not buf.tensors:
            return buf
        if not all(isinstance(t, np.ndarray) for t in buf.tensors):
            return buf  # resident payloads stage nothing on the host
        sig = tuple((t.shape, t.dtype) for t in buf.tensors)
        wins = self._stage_win
        st = wins.get(id(pool))
        if st is None or st["sig"] != sig or \
                st["next"] >= self.STAGE_WINDOW_FRAMES:
            st = {"sig": sig, "next": 0,
                  "slabs": [pool.acquire_window(self.STAGE_WINDOW_FRAMES,
                                                t.shape, t.dtype)
                            for t in buf.tensors]}
            wins[id(pool)] = st
        i = st["next"]
        st["next"] = i + 1
        staged = []
        for t, win in zip(buf.tensors, st["slabs"]):
            np.copyto(win[i], t)
            staged.append(win[i])
        return buf.with_tensors(staged)

    def _worker(self, k: int) -> None:
        q, pool = self._lane_qs[k], self._pools[k]
        while not self._stop_evt.is_set():
            try:
                seq, buf = q.get(timeout=0.1)
            except _queue.Empty:
                continue
            self._busy[k] = True
            tl = _timeline.ACTIVE
            t_pick = time.monotonic() if tl is not None else 0.0
            try:
                fi = _faults.ACTIVE
                if fi is not None:
                    # chaos hook: kind=crash simulates abrupt worker
                    # death — supervision (below) restarts the lane
                    fi.check("lane.worker",
                             seq=buf.meta.get(_timeline.TRACE_SEQ_META))
                # re-read per iteration: supervision may have swapped in
                # a fresh clone chain after a restart
                head = self._heads[k]
                head._chain_entry(head.sinkpads[0],
                                  self._stage_copy(buf, pool))
                items = self._tails[k].take()
            except Exception as e:  # noqa: BLE001 — a lane failure must
                # reach the bus (halt) or lane supervision (any other
                # error policy), never die silently
                self._busy[k] = False
                if self._halt_policy():
                    self.post_error(
                        e if isinstance(e, FlowError)
                        else FlowError(f"{self.name}: lane {k}: {e}"))
                    self._stop_evt.set()
                    with self._cv:
                        self._cv.notify_all()
                    return
                self._supervise_lane_failure(k, seq, buf, e)
                continue
            self._busy[k] = False
            if tl is not None:
                # recorded from the lane worker's own thread, so the
                # export shows each lane as its own track (lanes as
                # threads); not part of the reconciliation tiling — it
                # overlaps the frame's ingest window
                tl.span("lane_exec",
                        buf.meta.get(_timeline.TRACE_SEQ_META),
                        t_pick, time.monotonic(), lane=k)
            self._reorder_put(seq, items)

    def _reorder_put(self, seq: int, items: List[Tuple[str, Any]]) -> None:
        cap = self._capacity()
        t0 = None
        with self._cv:
            while seq - self._next >= cap and not self._stop_evt.is_set():
                if t0 is None:
                    t0 = time.monotonic()
                self._cv.wait(timeout=0.1)
            if t0 is not None and self._m_stall is not None:
                self._m_stall.inc(time.monotonic() - t0)
            self._pending[seq] = items
            tl = _timeline.ACTIVE
            if tl is not None:
                now = time.monotonic()
                self._pending_t[seq] = now
                if t0 is not None:
                    tl.span("lane_stall", _tl_seq(items), t0, now)
            self._cv.notify_all()

    # -- lane supervision (pipeline/supervise.py policies) -------------------
    def _supervise_lane_failure(self, k: int, seq: int, buf,
                                exc: BaseException) -> None:
        """A lane worker failed with a non-halt error policy: restart
        the lane's clone chain (its per-frame state is untrusted after
        an arbitrary failure), then either replay the in-flight frame
        through the fresh chain (``retry``/``degrade``) or account it as
        dropped (``skip-frame``). Either way the frame's sequence slot
        is filled — a real result or an empty tombstone — so the reorder
        buffer delivers every surviving frame in order, byte-identical
        to a run where the dead frame never existed."""
        from nnstreamer_tpu_torch.pipeline import supervise

        policy = supervise.effective_policy(self)
        if self._m_restarts is not None:
            self._m_restarts.inc()
        tl = _timeline.ACTIVE
        if tl is not None:
            tl.mark("lane_restart",
                    buf.meta.get(_timeline.TRACE_SEQ_META),
                    track="faults", lane=k)
        self.log.warning(
            "%s: lane %d worker failed on seq %d (%s); restarting clone "
            "chain under error-policy=%s", self.name, k, seq, exc, policy)
        try:
            self._rebuild_lane(k)
        except Exception as e:  # noqa: BLE001 — a lane that cannot be
            # rebuilt is unrecoverable; fail the pipeline
            self.post_error(FlowError(
                f"{self.name}: lane {k} restart failed: {e}"))
            self._stop_evt.set()
            with self._cv:
                self._cv.notify_all()
            return
        m = supervise._metrics(self)
        if policy == "skip-frame":
            self._tombstone(k, seq, buf, exc, m)
            return
        # retry / degrade: replay the in-flight frame through the fresh
        # chain with the element-standard bounded backoff
        retry_max = max(1, int(self._props.get("retry_max") or 3))
        base_ms = float(self._props.get("retry_backoff_ms") or 5.0)
        pool = self._pools[k]
        last = exc
        for attempt in range(1, retry_max + 1):
            supervise._backoff_sleep(self, attempt, base_ms)
            m["retries"].inc()
            try:
                head = self._heads[k]
                head._chain_entry(head.sinkpads[0],
                                  self._stage_copy(buf, pool))
                items = self._tails[k].take()
            except Exception as e:  # noqa: BLE001 — bounded ladder; the
                # frame is tombstoned below when attempts run out
                last = e
                continue
            m["recovered"].inc()
            self.log.warning(
                "%s: lane %d recovered seq %d on retry %d/%d", self.name,
                k, seq, attempt, retry_max)
            self._reorder_put(seq, items)
            return
        self._tombstone(k, seq, buf, last, m)

    def _tombstone(self, k: int, seq: int, buf, exc: BaseException,
                   m) -> None:
        """Fill the dead frame's sequence slot with an empty unit: the
        drain advances past it delivering nothing, so survivors stay in
        order and the EOS drain still completes."""
        m["skipped"].inc()
        tl = _timeline.ACTIVE
        if tl is not None:
            tl.mark("fault_skip", buf.meta.get(_timeline.TRACE_SEQ_META),
                    track="faults", element=self.name, lane=k)
        self.log.warning("%s: lane %d dropped seq %d after failure (%s)",
                         self.name, k, seq, exc)
        self._reorder_put(seq, [])

    def _rebuild_lane(self, k: int) -> None:
        """Swap lane k's clone chain for a fresh one. Single-writer
        safe: only worker k drives lane k's chain, and the caps
        renegotiation barrier waits for every stamped slot (including
        the in-flight one this rebuild is filling) before touching
        heads."""
        for c in self._clones[k]:
            try:
                c.stop()
            except Exception as e:  # noqa: BLE001 — the dead chain's
                # teardown must not block its replacement
                self.log.warning("%s: lane %d clone %s stop failed: %s",
                                 self.name, k, c.name, e)
        clones = [self._clone_of(el, k) for el in self.segment]
        tail = _LaneTail(name=f"{self.name}~tail{k}")
        tail.pipeline = self.pipeline
        for a, b in zip(clones, clones[1:]):
            a.srcpads[0].link(b.sinkpads[0])
        clones[-1].srcpads[0].link(tail.sinkpads[0])
        for c in clones:
            c.start()
        self._clones[k] = clones
        self._heads[k] = clones[0]
        self._tails[k] = tail
        if self._saved_caps is not None:
            head = clones[0]
            head._event_entry(head.sinkpads[0],
                              CapsEvent(self._saved_caps))
            tail.take()  # announcement already forwarded by lane 0

    def _drain_loop(self) -> None:
        while not self._stop_evt.is_set():
            with self._cv:
                items = self._pending.pop(self._next, None)
                if items is None:
                    self._cv.wait(timeout=0.1)
                    continue
                t_in = self._pending_t.pop(self._next, None)
                self._next += 1
                self._cv.notify_all()
            tl = _timeline.ACTIVE
            if tl is not None and t_in is not None:
                # the frame's park time in the reorder buffer — a
                # critical-path stage; the first downstream queue
                # subtracts it from the ingest span so the two tile
                now = time.monotonic()
                tl.span("lane_reorder", _tl_seq(items), t_in, now,
                        track="reorder")
                for kind, payload in items:
                    if kind == "buf":
                        payload.meta["tl_reorder_s"] = now - t_in
                        break
            try:
                self._forward(items)
                with self._cv:
                    self._delivered += 1
                    self._cv.notify_all()
            except Exception as e:  # noqa: BLE001 — downstream failures
                # must reach the bus, not silently kill the drain thread
                self.post_error(e if isinstance(e, FlowError)
                                else FlowError(f"{self.name}: {e}"))
                self._stop_evt.set()
                with self._cv:
                    self._cv.notify_all()
                return

    def _forward(self, items: List[Tuple[str, Any]]) -> None:
        """Push one sequence slot's output downstream, in emission order.
        Single consumer (the drain thread, or the streaming thread during
        negotiation when no frames are in flight) — downstream elements
        see exactly one pushing thread, like the serial path."""
        for kind, payload in items:
            if kind == "buf":
                self._forwarded += 1
                self._fwd_times.append(time.monotonic())
                self.srcpad.push(payload)
            else:
                if isinstance(payload, CapsEvent):
                    # every lane announces the same lazily-derived caps;
                    # the serial path announces once — dedupe to match
                    key = str(payload.caps)
                    if key == self._last_caps_str:
                        continue
                    self._last_caps_str = key
                self.srcpad.push_event(payload)

    # -- events --------------------------------------------------------------
    def _wait_drained(self, target: int, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._delivered < target and not self._stop_evt.is_set():
                if time.monotonic() >= deadline:
                    return False
                self._cv.wait(timeout=0.1)
        return True

    def sink_event(self, pad, event):
        if isinstance(event, CapsEvent):
            # (re)negotiation is a barrier: flush in-flight frames, then
            # run the caps through every lane's clone chain so each is
            # negotiated; forward lane 0's announcement (all identical)
            self._saved_caps = event.caps
            if not self._wait_drained(self._seq,
                                      timeout=_EOS_DRAIN_TIMEOUT_S):
                # a False here must not be dropped silently — the
                # barrier proceeding with frames still in flight means
                # those frames render under the WRONG caps downstream
                self.post_warning(
                    f"caps renegotiation barrier timed out after "
                    f"{_EOS_DRAIN_TIMEOUT_S:.0f}s with "
                    f"{self._seq - self._delivered} frame slot(s) "
                    f"undelivered; proceeding — in-flight frames may "
                    f"carry stale caps")
            first_items: List[Tuple[str, Any]] = []
            for k in range(self.n):
                head = self._heads[k]
                head._event_entry(head.sinkpads[0], CapsEvent(event.caps))
                items = self._tails[k].take()
                if k == 0:
                    first_items = items
            self._forward(first_items)
            return
        if isinstance(event, EosEvent):
            # serialized EOS: every stamped frame drains through the
            # reorder buffer before EOS crosses downstream
            if not self._wait_drained(self._seq,
                                      timeout=_EOS_DRAIN_TIMEOUT_S):
                # the undrained frames are lost: put the loss on the bus
                # where applications (and the chaos tests) can see it
                self.post_warning(
                    f"EOS drain timed out after "
                    f"{_EOS_DRAIN_TIMEOUT_S:.0f}s with "
                    f"{self._seq - self._delivered} frame slot(s) "
                    f"undelivered; those frames are lost")
            self.srcpad.push_event(event)
            return
        # any other serialized event: give it a sequence slot so it never
        # overtakes (or falls behind) the frames around it
        seq = self._seq
        self._seq = seq + 1
        self._reorder_put(seq, [("event", event)])

    def __repr__(self):
        names = "+".join(el.name for el in self.segment)
        return f"<IngestLanes {self.name!r} n={self.n} over [{names}]>"


# --------------------------------------------------------------------------
# planning
# --------------------------------------------------------------------------
def plan_lane_segments(pipe) -> List[Tuple[Element, List[Element]]]:
    """Find, per eligible source, the maximal replicable pre-queue
    segment: single-src-pad REORDER_SAFE source, then the downstream run
    of single-io ``reorder_safe()`` elements, stopping at the first
    queue, fused region, multi-pad, or stateful element. Runs after
    ``fuse_pipeline`` so a transform folded into a region (the
    device-side preprocessing preamble) is already out of the segment."""
    from nnstreamer_tpu_torch.pipeline.fuse import FusedRegion, device_foldable
    from nnstreamer_tpu_torch.pipeline.pipeline import Queue, SourceElement

    plans: List[Tuple[Element, List[Element]]] = []
    for src in pipe.elements:
        if not isinstance(src, SourceElement):
            continue
        if len(src.srcpads) != 1 or not src.reorder_safe():
            continue
        segment: List[Element] = []
        peer = src.srcpads[0].peer
        cur = peer.element if peer is not None else None
        while (cur is not None and _single_io(cur)
               and not isinstance(cur, (Queue, SourceElement, FusedRegion))
               and getattr(cur, "_fused_region", None) is None
               and cur.reorder_safe()):
            segment.append(cur)
            nxt = cur.srcpads[0].peer
            cur = nxt.element if nxt is not None else None
        if not segment:
            continue
        if isinstance(cur, FusedRegion):
            log.info("lane segment for %s ends at %s — preprocessing "
                     "runs device-side inside the fused region", src.name,
                     cur.name)
        elif cur is not None and device_foldable(cur):
            log.info("lane segment for %s ends at stage-capable %s left "
                     "unfused (NNSTPU_FUSE=0 or fuse=False)",
                     src.name, cur.name)
        plans.append((src, segment))
    return plans


def splice_lanes(pipe, lanes: int) -> List[IngestLanes]:
    """Splice an :class:`IngestLanes` executor behind every source with a
    replicable segment. ``lanes <= 1`` is the serial path: nothing is
    planned, nothing is touched."""
    if lanes <= 1:
        return []
    execs: List[IngestLanes] = []
    for src, segment in plan_lane_segments(pipe):
        ex = IngestLanes(src, segment, lanes, name=f"{src.name}-lanes")
        ex.splice(pipe)
        execs.append(ex)
    return execs
