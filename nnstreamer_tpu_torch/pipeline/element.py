"""Element / Pad / Event — the dataflow substrate.

The reference builds on GStreamer's element model: elements expose src/sink
pads; buffers flow downstream through per-pad ``chain`` functions; events
(CAPS, EOS, custom) flow alongside; caps negotiation fixes stream formats
before the first buffer. The JAX package keeps that model and so does the
port:

- **Synchronous push by default.** A source thread drives its chain of
  elements as plain function calls, so a CUDA tensor produced by one
  element is consumed by the next with no host round trip. CUDA's
  asynchronous launches already pipeline device work behind the host.
- **Explicit thread boundaries.** A ``queue`` element introduces a bounded
  FIFO + worker thread where stage decoupling is wanted.
- **Events carry negotiation.** ``CapsEvent`` fixes per-pad caps before the
  first buffer; elements override hooks rather than reimplementing
  negotiation.

Flow control mirrors GstFlowReturn: ``FlowReturn.OK/EOS``, errors raise
:class:`FlowError` (carried to the pipeline bus by the driving thread).
A ``chain`` that raises goes through the element's error policy
(``error-policy``, ``retry-max``, ``retry-backoff-ms``;
``pipeline/supervise.py``): ``halt``, the default, wraps and raises.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time as _time
from typing import Any, Dict, List, Optional

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.obs import timeline as _timeline
from nnstreamer_tpu_torch.pipeline.caps import Caps, CapsList
from nnstreamer_tpu_torch.tensors.buffer import (
    DeviceBuffer,
    TensorBuffer,
    record_residency_entry,
    residency_enabled,
)
from nnstreamer_tpu_torch.utils.stats import InvokeStats


class FlowReturn(enum.Enum):
    OK = "ok"
    EOS = "eos"


class FlowError(RuntimeError):
    """Fatal streaming error (GST_FLOW_ERROR equivalent)."""


def not_ported(what: str, roadmap_item: str) -> NotImplementedError:
    """The error for a feature of the JAX package that this port does not
    have yet: it names the ROADMAP.md item that brings it."""
    return NotImplementedError(
        f"{what} is not ported to nnstreamer_tpu_torch yet "
        f"(ROADMAP.md, {roadmap_item})")


class PadDirection(enum.Enum):
    SRC = "src"
    SINK = "sink"


# --------------------------------------------------------------------------
# Events
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Event:
    """Base event; flows downstream through pads."""


@dataclasses.dataclass
class CapsEvent(Event):
    caps: Caps


@dataclasses.dataclass
class EosEvent(Event):
    pass


@dataclasses.dataclass
class CustomEvent(Event):
    """Named application event (reference custom downstream events)."""

    name: str
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class QosEvent(Event):
    """Throttling QoS — flows *upstream* (reference GST_EVENT_QOS, posted
    by tensor_rate with throttle=true so upstream inference skips frames
    that would be dropped).

    ``target_interval_ns == 0`` lifts the throttle."""

    target_interval_ns: int = 0


# --------------------------------------------------------------------------
# Pad
# --------------------------------------------------------------------------
class Pad:
    """A connection point on an element.

    Sink pads receive buffers/events (dispatched to the owner element's
    ``chain``/``sink_event``); src pads push to their linked peer.
    """

    def __init__(self, element: "Element", name: str,
                 direction: PadDirection,
                 template_caps: Optional[CapsList] = None):
        self.element = element
        self.name = name
        self.direction = direction
        self.template_caps = template_caps or CapsList.any()
        self.peer: Optional["Pad"] = None
        self.caps: Optional[Caps] = None  # negotiated, fixed caps
        self.eos = False

    def link(self, sink: "Pad") -> None:
        if self.direction is not PadDirection.SRC:
            raise ValueError(f"{self} is not a src pad")
        if sink.direction is not PadDirection.SINK:
            raise ValueError(f"{sink} is not a sink pad")
        if self.peer is not None or sink.peer is not None:
            raise ValueError(f"pad already linked: {self} / {sink}")
        inter = self.template_caps.intersect(sink.template_caps)
        if inter.is_empty():
            raise ValueError(
                f"cannot link {self} -> {sink}: caps do not intersect "
                f"({self.template_caps} vs {sink.template_caps})"
            )
        self.peer = sink
        sink.peer = self

    def unlink(self) -> None:
        if self.peer is not None:
            self.peer.peer = None
            self.peer = None

    def push(self, buf: TensorBuffer) -> FlowReturn:
        """Push a buffer downstream (src pads only); an unlinked src pad
        drops it."""
        if self.peer is None:
            return FlowReturn.OK
        return self.peer.element._chain_entry(self.peer, buf)

    def push_list(self, bufs: List[TensorBuffer]) -> FlowReturn:
        """Push a backlog of buffers downstream in one hand-off. Peers that
        opt in (``Element.HANDLES_LIST``) receive the whole list through
        one ``chain_list`` call; everyone else gets the per-buffer push
        sequence, so opting out never changes behaviour."""
        if self.peer is None:
            return FlowReturn.OK
        el = self.peer.element
        if getattr(el, "HANDLES_LIST", False) and len(bufs) > 1:
            return el._chain_list_entry(self.peer, bufs)
        ret = FlowReturn.OK
        for b in bufs:
            ret = el._chain_entry(self.peer, b)
            if ret is FlowReturn.EOS:
                return ret
        return ret

    def push_event(self, event: Event) -> None:
        if isinstance(event, CapsEvent):
            self.caps = event.caps
        if self.peer is not None:
            self.peer.element._event_entry(self.peer, event)

    def push_upstream_event(self, event: Event) -> None:
        """Send an event upstream (sink pads only): it arrives on the
        peer src pad and dispatches to that element's ``src_event``."""
        if self.direction is not PadDirection.SINK:
            raise ValueError(f"{self}: upstream events leave via sink pads")
        if self.peer is not None:
            self.peer.element._upstream_event_entry(self.peer, event)

    def set_caps(self, caps: Caps) -> None:
        """Fix this src pad's caps and announce downstream."""
        if not caps.is_fixed():
            caps = caps.fixate()
        self.push_event(CapsEvent(caps))

    def __repr__(self):
        return f"Pad({self.element.name}.{self.name}:{self.direction.value})"


def peer_device_capable(pad: "Pad") -> bool:
    """True when the element behind ``pad``'s peer forwards device-resident
    buffers without a host materialization at entry."""
    peer = pad.peer
    if peer is None:
        return False
    return bool(getattr(peer.element, "DEVICE_PASSTHROUGH", False))


# --------------------------------------------------------------------------
# Element
# --------------------------------------------------------------------------
class Element:
    """Base class for all stream elements.

    Subclasses declare::

        ELEMENT_NAME = "tensor_something"   # registry name
        PROPERTIES = {"prop": default, ...}

    and override :meth:`chain` (per-buffer work), :meth:`transform_caps`
    (negotiation), and optionally :meth:`start`/:meth:`stop`. Every element
    gets reference-style ``latency`` / ``throughput`` read-outs via
    :attr:`stats`.
    """

    ELEMENT_NAME = "element"
    #: ``error_policy`` None = inherit ``Pipeline(error_policy=...)``,
    #: else ``halt`` — see pipeline/supervise.py for the policy set and
    #: ``retry_max``/``retry_backoff_ms`` semantics
    PROPERTIES: Dict[str, Any] = {"silent": True, "name": None,
                                  "error_policy": None, "retry_max": 3,
                                  "retry_backoff_ms": 5.0}
    #: properties the JAX package has and the port does not yet:
    #: name → the ROADMAP.md item that brings them. Setting one raises.
    UNPORTED_PROPERTIES: Dict[str, str] = {}

    #: Elements that merely hold or hand off buffers (queue, sinks) set this
    #: True to keep a pending ``TensorBuffer.finalize`` lazy. Everything else
    #: materializes a finalize-pending buffer on entry.
    HANDLES_DEFERRED = False

    #: Elements that accept a whole buffer backlog per entry (aggregator,
    #: fused regions) set this True; a batch-draining queue then hands its
    #: backlog through ONE ``chain_list`` call instead of a per-buffer push
    #: sequence. The list keeps queue order and is consumed in order.
    HANDLES_LIST = False

    #: Elements that route/hold/compute without reading tensor bytes on the
    #: host set this True: a :class:`DeviceBuffer` then crosses their pads
    #: without materializing. Everything else gets the buffer
    #: host-materialized at pad entry.
    DEVICE_PASSTHROUGH = False

    #: Elements whose per-buffer output is a pure function of the input
    #: buffer and their (fixed) properties — no per-frame mutable state —
    #: set this True: the ingest lane planner (``pipeline/lanes.py``) may
    #: replicate them across parallel worker lanes, process frames out of
    #: order, and reassemble by sequence number without changing a byte.
    #: On a SourceElement the flag means each ``create()`` output is
    #: self-contained (pts stamped at the source), so stamped sequence
    #: numbers fully determine stream order.
    REORDER_SAFE = False

    _instance_counter: Dict[str, int] = {}
    _instance_counter_lock = threading.Lock()

    @classmethod
    def _next_auto_name(cls) -> str:
        with Element._instance_counter_lock:
            n = Element._instance_counter.get(cls.ELEMENT_NAME, 0)
            Element._instance_counter[cls.ELEMENT_NAME] = n + 1
        return f"{cls.ELEMENT_NAME}{n}"

    def __init__(self, name: Optional[str] = None, **props):
        cls_props: Dict[str, Any] = {}
        unported: Dict[str, str] = {}
        for klass in reversed(type(self).__mro__):
            cls_props.update(getattr(klass, "PROPERTIES", {}))
            unported.update(getattr(klass, "UNPORTED_PROPERTIES", {}))
        self._props = dict(cls_props)
        self._unported = unported
        self.name = name or self._next_auto_name()
        self.log = get_logger(self.name)
        self.sinkpads: List[Pad] = []
        self.srcpads: List[Pad] = []
        self.stats = InvokeStats()
        self.pipeline = None  # set by Pipeline.add
        self._obs_hist = None  # per-element chain histogram, lazy
        self._started = False
        #: the fused region this element is a member of (pipeline/fuse.py)
        self._fused_region = None
        for k, v in props.items():
            self.set_property(k, v)

    # -- properties ----------------------------------------------------------
    def set_property(self, key: str, value: Any) -> None:
        key = key.replace("-", "_")
        if key in self._unported:
            raise not_ported(f"{self.ELEMENT_NAME} property "
                             f"{key.replace('_', '-')!r}",
                             self._unported[key])
        if key not in self._props:
            raise KeyError(
                f"{self.ELEMENT_NAME} has no property {key!r} "
                f"(has: {sorted(self._props)})"
            )
        self._props[key] = self._coerce_property(key, value)
        self.property_changed(key)
        region = self._fused_region
        if region is not None:
            # a live edit may change the member's computation or its
            # fusibility: the region re-plans at its next frame
            region.invalidate()

    def get_property(self, key: str) -> Any:
        key = key.replace("-", "_")
        if key in ("latency", "throughput"):
            stats = self._metrics_stats()
            return stats.latency_us if key == "latency" else \
                stats.throughput_milli
        return self._props[key]

    def _metrics_stats(self) -> InvokeStats:
        """The stats behind ``latency``/``throughput``: this element's
        chain window, or, for a fused member whose chain does not run, its
        region's (a member's latency is then the region's)."""
        region = self._fused_region
        if region is not None and self.stats.total_invokes == 0:
            return region.stats
        return self.stats

    def _coerce_property(self, key: str, value: Any) -> Any:
        """Coerce string property values (from parse_launch) to the default's
        type."""
        default = self._props.get(key)
        if isinstance(value, str):
            if isinstance(default, bool):
                return value.strip().lower() in ("1", "true", "yes", "on")
            if isinstance(default, int) and not isinstance(default, bool):
                return int(value)
            if isinstance(default, float):
                return float(value)
        return value

    def property_changed(self, key: str) -> None:
        """Hook: subclass reacts to a property update."""

    def reorder_safe(self) -> bool:
        """Instance-level lane-replicability check; defaults to the class
        flag. Elements that are only conditionally stateless
        (tensor_converter: per-buffer regimes yes, frame batching no)
        override this with a property-aware answer."""
        return bool(self.REORDER_SAFE)

    def _obs_labels(self) -> Dict[str, str]:
        """Stable metric labels: ``{pipeline=..., element=...}``."""
        return {"pipeline": getattr(self.pipeline, "name", "") or "",
                "element": self.name}

    # -- pad management ------------------------------------------------------
    def add_sink_pad(self, name: str = "sink", caps: Optional[CapsList] = None
                     ) -> Pad:
        pad = Pad(self, name, PadDirection.SINK, caps)
        self.sinkpads.append(pad)
        return pad

    def add_src_pad(self, name: str = "src", caps: Optional[CapsList] = None
                    ) -> Pad:
        pad = Pad(self, name, PadDirection.SRC, caps)
        self.srcpads.append(pad)
        return pad

    def request_sink_pad(self) -> Pad:
        """For N-input elements: allocate a new sink pad. Default: error."""
        raise NotImplementedError(f"{self.ELEMENT_NAME} has fixed pads")

    def request_src_pad(self) -> Pad:
        """For N-output elements: allocate a new src pad. Default: error."""
        raise NotImplementedError(f"{self.ELEMENT_NAME} has fixed src pads")

    @property
    def sinkpad(self) -> Pad:
        return self.sinkpads[0]

    @property
    def srcpad(self) -> Pad:
        return self.srcpads[0]

    def link(self, downstream: "Element") -> "Element":
        """Link this element's first free src pad to downstream's first free
        sink pad (gst_element_link). Returns downstream for chaining."""
        src = next((p for p in self.srcpads if p.peer is None), None)
        if src is None:
            raise ValueError(f"{self.name}: no free src pad")
        sink = next((p for p in downstream.sinkpads if p.peer is None), None)
        if sink is None:
            sink = downstream.request_sink_pad()
        src.link(sink)
        return downstream

    # -- dataflow entry (with uniform instrumentation) -----------------------
    def _obs_chain_hist(self):
        """The per-element chain-latency histogram (lazy: labels include
        the owning pipeline's name, known only after Pipeline.add)."""
        h = self._obs_hist
        if h is None:
            h = self._obs_hist = get_registry().histogram(
                "nns_element_chain_seconds",
                "Per-buffer chain duration (invoke + downstream push)",
                pipeline=getattr(self.pipeline, "name", "") or "",
                element=self.name)
        return h

    def obs_snapshot(self) -> Dict[str, Any]:
        """Element-specific extras for ``Pipeline.metrics_snapshot()``."""
        h = self._obs_hist
        if h is None or h.count == 0:
            return {}
        return {"chain_p50_ms": round(h.percentile(50) * 1e3, 3),
                "chain_p99_ms": round(h.percentile(99) * 1e3, 3)}

    def _entered(self, buf: TensorBuffer) -> TensorBuffer:
        """A buffer as this element sees it at pad entry: a resident buffer
        stays resident across elements that declared passthrough or keep
        deferred work lazy; otherwise this entry is the (cached)
        materialization. Every DeviceBuffer entry is tallied resident or
        materialized (``nns_buffer_resident_ratio``). With residency off
        (``NNSTPU_RESIDENT=0``) no DeviceBuffer exists, so an element that
        is not device-capable gets an all-device payload on the host
        here, as a DeviceBuffer's entry would have handed it over."""
        if isinstance(buf, DeviceBuffer):
            resident = self.HANDLES_DEFERRED or (
                self.DEVICE_PASSTHROUGH and buf.finalize is None)
            record_residency_entry(resident)
            if not resident:
                return buf.to_host()
        elif buf.finalize is not None and not self.HANDLES_DEFERRED:
            return buf.to_host()
        elif not (self.DEVICE_PASSTHROUGH or self.HANDLES_DEFERRED) and \
                buf.on_device() and not residency_enabled():
            return buf.to_host()
        return buf

    def _chain_list_entry(self, pad: Pad,
                          bufs: List[TensorBuffer]) -> FlowReturn:
        """Batch twin of :meth:`_chain_entry` (``Pad.push_list`` → here):
        the same entry contract per buffer; stats spread the batch's
        duration evenly over its buffers, so invoke counts and throughput
        read as on the per-buffer path."""
        if pad.eos:
            return FlowReturn.EOS
        t0 = _time.monotonic()
        try:
            try:
                bufs = [self._entered(b) for b in bufs]
                ret = self.chain_list(pad, bufs)
            except FlowError:
                raise
            except Exception as e:
                ret = self._recover_chain_list(pad, bufs, e)
        finally:
            now = _time.monotonic()
            per = (now - t0) / max(len(bufs), 1)
            hist = self._obs_chain_hist()
            for _ in range(max(len(bufs), 1)):
                self.stats.record(per, now)
                hist.observe(per)
            th = _timeline.THREADS
            if th is not None:
                th.span("chain", None, t0, now, element=self.name)
        return FlowReturn.OK if ret is None else ret

    def _chain_entry(self, pad: Pad, buf: TensorBuffer) -> FlowReturn:
        if pad.eos:
            return FlowReturn.EOS
        t0 = _time.monotonic()
        try:
            try:
                buf = self._entered(buf)
                ret = self.chain(pad, buf)
            except FlowError:
                raise
            except Exception as e:
                ret = self._recover_chain(pad, buf, e)
        finally:
            now = _time.monotonic()
            self.stats.record(now - t0, now)
            self._obs_chain_hist().observe(now - t0)
            th = _timeline.THREADS
            if th is not None:
                th.span("chain", None, t0, now, element=self.name)
        return FlowReturn.OK if ret is None else ret

    def _halt_policy(self) -> bool:
        """True when this element's effective error policy is ``halt``
        (the default). Decided from the two property reads alone so the
        common no-supervision case never imports the recovery module."""
        pol = self._props.get("error_policy") or \
            getattr(self.pipeline, "error_policy", None)
        return not pol or str(pol).replace("_", "-") == "halt"

    def _recover_chain(self, pad: Pad, buf: TensorBuffer,
                       exc: BaseException) -> FlowReturn:
        """A ``chain`` call raised a non-FlowError: apply the element's
        error policy (``pipeline/supervise.py``). ``halt`` is the plain
        wrap-and-raise."""
        if self._halt_policy():
            raise FlowError(f"{self.name}: {exc}") from exc
        from nnstreamer_tpu_torch.pipeline import supervise

        return supervise.recover_chain(self, pad, buf, exc)

    def _recover_chain_list(self, pad: Pad, bufs: List[TensorBuffer],
                            exc: BaseException) -> FlowReturn:
        if self._halt_policy():
            raise FlowError(f"{self.name}: {exc}") from exc
        from nnstreamer_tpu_torch.pipeline import supervise

        return supervise.recover_chain_list(self, pad, bufs, exc)

    def _event_entry(self, pad: Pad, event: Event) -> None:
        if isinstance(event, CapsEvent):
            pad.caps = event.caps
        if isinstance(event, EosEvent):
            pad.eos = True
        self.sink_event(pad, event)

    def _upstream_event_entry(self, pad: Pad, event: Event) -> None:
        self.src_event(pad, event)

    # -- subclass hooks ------------------------------------------------------
    def chain(self, pad: Pad, buf: TensorBuffer) -> Optional[FlowReturn]:
        """Process one input buffer. Default: passthrough to first src pad."""
        if self.srcpads:
            return self.srcpad.push(buf)
        return FlowReturn.OK

    def chain_list(self, pad: Pad, bufs: List[TensorBuffer]
                   ) -> Optional[FlowReturn]:
        """Process a queue-drained backlog in order. Default: loop
        :meth:`chain`; HANDLES_LIST elements may override to hoist
        per-buffer overhead (one lock acquisition per backlog)."""
        ret = None
        for i, b in enumerate(bufs):
            try:
                ret = self.chain(pad, b)
            except Exception as e:
                # buffers before index i were fully chained (and pushed
                # downstream): a non-halt error policy replays only the
                # unconsumed suffix instead of re-pushing delivered frames
                if getattr(e, "_nns_list_done", None) is None:
                    try:
                        e._nns_list_done = i
                    except AttributeError:
                        pass  # __slots__ exceptions lose the replay hint
                raise
            if ret is FlowReturn.EOS:
                break
        return ret

    def src_event(self, pad: Pad, event: Event) -> None:
        """Handle an upstream-flowing event arriving on a src pad.
        Default: forward further upstream through every sink pad."""
        for sp in self.sinkpads:
            sp.push_upstream_event(event)

    def _qos_throttled(self, min_interval_s: float = 0.0) -> bool:
        """Shared invoke drop check: True when this invoke must be skipped
        to honor the larger of the element's own minimum interval and the
        downstream QoS interval adopted in ``src_event``
        (``_qos_interval_s``). Updates the invoke clock when the invoke is
        allowed."""
        interval = max(min_interval_s,
                       getattr(self, "_qos_interval_s", 0.0))
        if interval <= 0:
            return False
        now = _time.monotonic()
        if now - getattr(self, "_last_invoke_t", 0.0) < interval:
            return True
        self._last_invoke_t = now
        return False

    def sink_event(self, pad: Pad, event: Event) -> None:
        """Handle a downstream-flowing event. Default: CAPS → negotiate via
        :meth:`transform_caps`; EOS/custom → forward when all sink pads agree.
        """
        if isinstance(event, CapsEvent):
            out = self.transform_caps(pad, event.caps)
            if out is not None and self.srcpads:
                for sp in self.srcpads:
                    sp.set_caps(out)
        elif isinstance(event, EosEvent):
            if all(p.eos for p in self.sinkpads):
                self.handle_eos()
                for sp in self.srcpads:
                    sp.push_event(event)
        else:
            for sp in self.srcpads:
                sp.push_event(event)

    def transform_caps(self, pad: Pad, caps: Caps) -> Optional[Caps]:
        """Map fixed input caps to output caps. Default: identity."""
        return caps

    def handle_eos(self) -> None:
        """Hook: flush buffered state at end-of-stream."""

    # -- state ---------------------------------------------------------------
    def start(self) -> None:
        """Transition to streaming state (allocate resources, open models)."""
        self._started = True

    def stop(self) -> None:
        self._started = False

    def threads(self) -> List[threading.Thread]:
        """The threads this element runs of its own (a queue's worker, a
        lane executor's workers); ``nns_thread_cpu_seconds_total`` reads
        their CPU time."""
        return []

    def post_error(self, exc: Exception) -> None:
        if self.pipeline is not None:
            self.pipeline.post_error(self, exc)
        else:
            raise exc

    def post_warning(self, text: str) -> None:
        """Post a non-fatal condition to the pipeline bus."""
        if self.pipeline is not None:
            self.pipeline.post_warning(self, text)
        else:
            self.log.warning("%s: %s", self.name, text)

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"
