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
  the card's asynchronous execution.

The JAX package's region fusion, ingest lanes, SLO scheduler, watchdog,
fault injection and serving continuity are not ported yet: asking for one
raises ``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

import enum
import queue as _queue
import threading
import time
from typing import Any, Dict, List, Optional

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.pipeline.element import (
    Element,
    EosEvent,
    Event,
    FlowError,
    FlowReturn,
    not_ported,
)
from nnstreamer_tpu_torch.registry import ELEMENT, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

log = get_logger("pipeline")

_TRACING = "A.11 supervision hooks, tracing and scheduling"
_STAGING = "A.10 staging pool, dispatch window and aggregator"


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
      backpressure (gst queue's leaky property);
    - ``prefetch-host`` starts each buffer's device→host copies on the
      producer side, into pinned memory, so the consumer of the queue
      finds them in flight;
    - ``materialize-host`` hands HOST buffers downstream: the worker
      fetches each buffer (and applies its deferred finalize) before the
      push.
    """

    ELEMENT_NAME = "queue"
    HANDLES_DEFERRED = True  # pure hand-off: finalize stays lazy across it
    DEVICE_PASSTHROUGH = True  # never reads tensor bytes on the host
    PROPERTIES = {**Element.PROPERTIES, "max_size_buffers": 16, "leaky": "no",
                  "prefetch_host": False, "materialize_host": False}
    UNPORTED_PROPERTIES = {
        "prefetch_device": _STAGING,
        "batch_h2d": _STAGING,
        "drain_batch": _STAGING,
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

    def property_changed(self, key):
        if key == "leaky" and self._props["leaky"] not in ("no", "downstream"):
            raise ValueError(f"{self.name}: leaky must be 'no' or "
                             f"'downstream', not {self._props['leaky']!r}")

    def obs_snapshot(self):
        out = super().obs_snapshot()
        out["depth"] = self._q.qsize()
        if self._m_drops is not None:
            out["drops"] = int(self._m_drops.value)
        return out

    def start(self):
        super().start()
        self._stop_evt.clear()
        self._eos_done.clear()
        self._q = _queue.Queue(
            maxsize=int(self.get_property("max_size_buffers")))
        if self._m_drops is None:
            self._m_drops = get_registry().counter(
                "nns_queue_drops_total",
                "Buffers discarded by leaky=downstream backpressure",
                pipeline=getattr(self.pipeline, "name", "") or "",
                element=self.name)
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

    def chain(self, pad, buf):
        if self.get_property("prefetch_host"):
            buf = buf.prefetch_host()
        if self._worker is None:  # not started: degenerate passthrough
            return self.srcpad.push(buf)
        if self.get_property("leaky") == "downstream":
            while True:
                try:
                    self._q.put_nowait(buf)
                    return FlowReturn.OK
                except _queue.Full:
                    try:
                        self._q.get_nowait()  # drop the oldest
                        self._m_drops.inc()
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

    def _drain(self):
        materialize = bool(self.get_property("materialize_host"))
        while not self._stop_evt.is_set():
            try:
                item = self._q.get(timeout=0.1)
            except _queue.Empty:
                continue
            try:
                if item is self._EOS:
                    self.srcpad.push_event(EosEvent())
                    self._eos_done.set()
                    return
                if isinstance(item, Event):
                    self.srcpad.push_event(item)
                    continue
                self.srcpad.push(item.to_host() if materialize else item)
            except Exception as e:  # noqa: BLE001 — downstream failures
                # must reach the bus, not silently kill this worker thread
                self.post_error(e if isinstance(e, FlowError)
                                else FlowError(f"{self.name}: {e}"))
                self._eos_done.set()
                return


class Pipeline:
    """Element container + source threads + bus.

    The keyword arguments are the JAX package's; every value other than
    the default names a feature the port does not have yet and raises."""

    def __init__(self, name: str = "pipeline", fuse: bool = False,
                 lanes: int = 1, slo_budget_ms: float = 0.0,
                 error_policy: Optional[str] = None,
                 watchdog_s: float = 0.0):
        check_unported_options(fuse=fuse, lanes=lanes,
                               slo_budget_ms=slo_budget_ms,
                               error_policy=error_policy,
                               watchdog_s=watchdog_s)
        self.name = name
        self.elements: List[Element] = []
        self.by_name: Dict[str, Element] = {}
        self.state = State.NULL
        self._bus: _queue.Queue = _queue.Queue()
        self._threads: List[threading.Thread] = []
        self._eos_pending = 0

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
            entry: Dict[str, Any] = {
                "type": el.ELEMENT_NAME,
                "latency_us": el.stats.latency_us,
                "throughput_milli": el.stats.throughput_milli,
                "invokes": el.stats.total_invokes,
            }
            entry.update(el.obs_snapshot())
            elements[el.name] = entry
        return {"pipeline": self.name, "state": self.state.value,
                "elements": elements}

    # -- state ----------------------------------------------------------------
    def start(self) -> "Pipeline":
        """NULL→PLAYING: start all elements (non-sources first so queues and
        filters are ready), then spawn one streaming thread per source."""
        if self.state is State.PLAYING:
            return self
        sources = [e for e in self.elements if isinstance(e, SourceElement)]
        others = [e for e in self.elements
                  if not isinstance(e, SourceElement)]
        started: List[Element] = []
        try:
            for el in others + sources:
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


def check_unported_options(fuse=False, lanes=1, slo_budget_ms=0.0,
                           error_policy=None, watchdog_s=0.0) -> None:
    """Raise for a pipeline-level option whose feature is not ported."""
    if fuse:
        raise not_ported("region fusion (Pipeline(fuse=True))",
                         "A.8 region fusion")
    if lanes not in (None, 1):
        raise not_ported("ingest lanes (lanes=)", _TRACING)
    if slo_budget_ms:
        raise not_ported("the SLO scheduler (slo_budget_ms=)", _TRACING)
    if error_policy not in (None, "halt"):
        raise not_ported("error policies (error_policy=)", _TRACING)
    if watchdog_s:
        raise not_ported("the pipeline watchdog (watchdog_s=)", _TRACING)
