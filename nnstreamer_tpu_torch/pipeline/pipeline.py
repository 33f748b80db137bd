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
``NNSTPU_FUSE=0`` turn it off). The JAX package's ingest lanes, SLO
scheduler, watchdog, fault injection and serving continuity are not
ported yet: asking for one raises ``NotImplementedError`` naming its
ROADMAP.md item.
"""

from __future__ import annotations

import enum
import queue as _queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from nnstreamer_tpu_torch.device import resolve_device
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.obs import get_registry
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
    not_ported,
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

_TRACING = "A.11 supervision hooks, tracing and scheduling"


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

    Uploads and fetches run on the worker's current stream, the device's
    default stream (``tensors/buffer.py``).
    """

    ELEMENT_NAME = "queue"
    HANDLES_DEFERRED = True  # pure hand-off: finalize stays lazy across it
    DEVICE_PASSTHROUGH = True  # never reads tensor bytes on the host
    PROPERTIES = {**Element.PROPERTIES, "max_size_buffers": 16, "leaky": "no",
                  "prefetch_host": False, "prefetch_device": False,
                  "materialize_host": False, "drain_batch": 64,
                  "batch_h2d": True}
    UNPORTED_PROPERTIES = {
        "stamp_admission": _TRACING,
        "slo_budget_ms": _TRACING,
    }

    _EOS = object()

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        self._q: _queue.Queue = _queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._eos_done = threading.Event()
        self._m_drops = None
        self._m_drain = None
        #: data buffers the worker popped but has not handed downstream
        #: yet (single writer: the worker)
        self._undelivered = 0
        #: where prefetch-device uploads to, resolved at start()
        self._device: Optional[torch.device] = None

    def property_changed(self, key):
        if key == "leaky" and self._props["leaky"] not in ("no", "downstream"):
            raise ValueError(f"{self.name}: leaky must be 'no' or "
                             f"'downstream', not {self._props['leaky']!r}")

    def obs_snapshot(self):
        out = super().obs_snapshot()
        out["depth"] = self._q.qsize() + self._undelivered
        if self._m_drops is not None:
            out["drops"] = int(self._m_drops.value)
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
            self._m_drain = reg.histogram(
                "nns_queue_drain_size",
                "Data buffers the worker drained per wake (backlog "
                "batching)", buckets=(1, 2, 4, 8, 16, 32, 64), **labels)
        self._worker = threading.Thread(
            target=self._drain, name=f"{self.name}-worker", daemon=True)
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

    def accepts_now(self) -> bool:
        """True when a push would be absorbed without blocking or dropping.
        A latency-budget aggregator upstream polls this before flushing a
        partial window early."""
        if self._worker is None:
            return True
        maxsize = self._q.maxsize
        return maxsize <= 0 or self._q.qsize() < maxsize

    def chain(self, pad, buf):
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
        if self._worker is None:  # not started: degenerate passthrough
            return self.srcpad.push(buf)
        if self.get_property("leaky") == "downstream":
            while True:
                try:
                    self._q.put_nowait(buf)
                    return FlowReturn.OK
                except _queue.Full:
                    try:
                        dropped = self._q.get_nowait()  # drop the oldest
                        self._m_drops.inc()
                        if not (dropped is self._EOS
                                or isinstance(dropped, Event)):
                            # it never reaches a fence: release its
                            # staged slabs now, not at GC
                            release_shed_payload(dropped)
                    except _queue.Empty:
                        pass
        while not self._stop_evt.is_set():
            try:
                self._q.put(buf, timeout=0.1)
                return FlowReturn.OK
            except _queue.Full:
                continue
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
        if self.get_property("materialize_host"):
            for host in materialize_many(run):
                self._undelivered -= 1
                self.srcpad.push(host)
            return
        peer = self.srcpad.peer
        if len(run) > 1 and peer is not None and \
                getattr(peer.element, "HANDLES_LIST", False):
            self._undelivered -= len(run)
            self.srcpad.push_list(run)
            return
        for it in run:
            self._undelivered -= 1
            self.srcpad.push(it)

    def _drain(self):
        drain_max = max(1, int(self.get_property("drain_batch")))
        while not self._stop_evt.is_set():
            try:
                item = self._q.get(timeout=0.1)
            except _queue.Empty:
                continue
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
                            return
                        self.srcpad.push_event(it)
                    else:
                        run.append(it)
                self._flush_run(run)
            except Exception as e:  # noqa: BLE001 — downstream failures
                # must reach the bus, not silently kill this worker thread
                self.post_error(e if isinstance(e, FlowError)
                                else FlowError(f"{self.name}: {e}"))
                self._eos_done.set()
                return


class Pipeline:
    """Element container + source threads + bus.

    The keyword arguments are the JAX package's. ``fuse`` (default True)
    splices fused regions at ``start()``; for the others every value but
    the default names a feature the port does not have yet and raises."""

    def __init__(self, name: str = "pipeline", fuse: bool = True,
                 lanes: int = 1, slo_budget_ms: float = 0.0,
                 error_policy: Optional[str] = None,
                 watchdog_s: float = 0.0):
        check_unported_options(lanes=lanes, slo_budget_ms=slo_budget_ms,
                               error_policy=error_policy,
                               watchdog_s=watchdog_s)
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
        if self._regions:
            # regions are spliced, not in self.elements: their dispatch
            # counts (eager frames, replays, captures, retraces)
            out["regions"] = {r.name: {"members": [m.name for m in r.members],
                                       "unspliced": r._dead,
                                       **r.obs_snapshot()}
                              for r in self._regions}
        return out

    # -- state ----------------------------------------------------------------
    def start(self) -> "Pipeline":
        """NULL→PLAYING: start all elements (non-sources first so queues and
        filters are ready), splice fused regions over them (once; they
        persist across restarts), then spawn one streaming thread per
        source."""
        if self.state is State.PLAYING:
            return self
        sources = [e for e in self.elements if isinstance(e, SourceElement)]
        others = [e for e in self.elements
                  if not isinstance(e, SourceElement)]
        # a restart streams anew: the last run's EOS no longer holds
        for el in self.elements + (self._regions or []):
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
            for el in sources:
                el.start()
                started.append(el)
        except Exception:
            for el in reversed(started):
                el.stop()
            raise
        self.state = State.PLAYING
        self._eos_pending = len(sources)
        for src in sources:
            t = threading.Thread(
                target=src.run_loop, args=(self,),
                name=f"{self.name}:{src.name}", daemon=True
            )
            self._threads.append(t)
            t.start()
        return self

    def stop(self) -> "Pipeline":
        if self.state is State.NULL:
            return self
        for el in self.elements:
            if isinstance(el, SourceElement):
                el.stop()
        for t in self._threads:
            t.join(timeout=10)
        self._threads.clear()
        for el in self.elements:
            if not isinstance(el, SourceElement):
                el.stop()
        for r in self._regions or ():
            r.stop()
        # a stopped pipeline holds no free staging slabs
        release_all_pools()
        self.state = State.NULL
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


def check_unported_options(lanes=1, slo_budget_ms=0.0, error_policy=None,
                           watchdog_s=0.0) -> None:
    """Raise for a pipeline-level option whose feature is not ported."""
    if lanes not in (None, 1):
        raise not_ported("ingest lanes (lanes=)", _TRACING)
    if slo_budget_ms:
        raise not_ported("the SLO scheduler (slo_budget_ms=)", _TRACING)
    if error_policy not in (None, "halt"):
        raise not_ported("error policies (error_policy=)", _TRACING)
    if watchdog_s:
        raise not_ported("the pipeline watchdog (watchdog_s=)", _TRACING)
