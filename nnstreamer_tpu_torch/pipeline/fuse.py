"""Region fusion — a run of device-capable elements replayed as one CUDA
graph.

Port of ``nnstreamer_tpu/pipeline/fuse.py``. After the elements start,
maximal runs of fusible single-in/single-out elements are re-linked behind
a :class:`FusedRegion`, whose chain runs the members' device stages
composed into one function. Where the JAX region jits that function into
one XLA program, this one

- on a CUDA device runs the first frame of each input signature (shapes
  and dtypes) eagerly, then captures the composed stages once as a CUDA
  graph and replays it for every later frame of that signature: the
  flagship's uint8 frame → kernel B1 → MobileNetV2 → argmax is one graph
  launch between a copy of the frame into the graph's static inputs and
  copies of its outputs;
- on the CPU calls the composed stages directly.

An element opts in by implementing ``device_stage() -> DeviceStage |
None``. Elements whose per-frame behaviour is host control flow do not,
and stay unfused; so do neighbours whose stages compute on different
devices.

A plain ``stop()``/``start()`` keeps the captured graphs, as the JAX
region keeps its trace: ``start()`` rebuilds the stages and keeps the
graphs only when every stage key equals the last build's (no key None)
and so does every stage's storage pin — the (data_ptr, dtype, shape,
device) of each tensor its consts hold, a module's parameters and
buffers included — since a graph replays the addresses it captured: a
weight rebound between runs (``module.half()``, ``param.data = ...``,
``load_state_dict(assign=True)``) captures anew. A property edit, a custom
event, a model reload and ``degrade`` call :meth:`FusedRegion.invalidate`,
which drops them, and the next frame captures anew.

Each frame's copy into the static inputs, its replay and its output
copies run in that order on the dispatching thread's current stream (the
device's default stream): the next frame's copy overwrites the static
inputs, which is safe only because it is enqueued behind this frame's
replay on the same stream. A region has a dispatch window
(``pipeline/dispatch.py``) of the largest ``inflight`` among its members;
its fence is an event recorded after the output copies.

The region is the fused members' ``filter.invoke`` fault site
(``pipeline/faults.py``): the hook fires before the stash pop and before
any copy or replay, so an error policy that retries the frame replays
the same graph. With a timeline active each dispatch is the frame's
``device`` span — on the card the host's enqueue of the copy in, the
replay and the copies out, not kernel time — and a frame handed in a
list records its wait for its turn as ``queue_wait``.

A QoS event from downstream (``tensor_rate throttle=true``) that a member
consumes (the filter) gates the region's dispatch: a frame that comes
too soon is dropped before any copy or replay (``qos_drops``), and the
rest replay the captured graph as before. A member that stops being
fusible mid-stream (a filter's ``throttle`` set above 0) makes the next
frame unsplice the region: from then on the members run eagerly, the
transform launching B1 itself, and no captured graph is replayed.

What the JAX module has and this one does not: donation of the input slab
(``NNSTPU_DONATE``) has no counterpart, since the graph reads static input
buffers into which each frame is copied; a mesh-sharded stage raises
(A.24).

Disable globally with ``NNSTPU_FUSE=0`` or per pipeline with
``Pipeline(fuse=False)``.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.obs import timeline as _timeline
from nnstreamer_tpu_torch.ops import _counts
from nnstreamer_tpu_torch.pipeline import faults as _faults
from nnstreamer_tpu_torch.pipeline.element import (
    CustomEvent,
    Element,
    EosEvent,
    Event,
    FlowError,
    Pad,
    QosEvent,
    not_ported,
    peer_device_capable,
)
from nnstreamer_tpu_torch.pipeline.dispatch import (
    POOL_STASH_META,
    DispatchWindow,
    release_shed_payload,
)
from nnstreamer_tpu_torch.tensors.buffer import (
    as_device_buffer,
    as_torch,
    copy_host_to,
)

log = get_logger("fuse")


@dataclasses.dataclass
class DeviceStage:
    """One element's contribution to a fused region.

    ``fn(consts, tensors) -> tensors`` works on torch tensors (a stage
    that is first in its region may also get host arrays on the CPU) and
    must be capturable on the card: no host synchronisation, no data-
    dependent Python control flow. ``consts`` is threaded through every
    call (a model's module). ``key`` identifies the computation, not the
    consts' storage (the region pins that itself); None means it cannot
    be shown unchanged.
    """

    consts: Any
    fn: Callable[[Any, List[Any]], List[Any]]
    key: Any = None
    #: deferred host completion ``fn(host_buf) -> TensorBuffer`` attached
    #: to outgoing buffers (a decoder's label lookup). A finalizing stage
    #: ends its run.
    finalize: Optional[Callable] = None
    #: the device the stage computes on and its consts live on; None for
    #: a stage that runs where its inputs lie (a decoder's device half)
    device: Optional[torch.device] = None
    #: the JAX stage's serving-mesh spec: not ported
    mesh: Optional[str] = None

    def __post_init__(self):
        if self.mesh is not None:
            raise not_ported("mesh-sharded region stages (mesh=)",
                             "A.24 multi-GPU serving")


def _storage_pin(consts) -> Optional[tuple]:
    """What a captured graph reads of ``consts``: the (data_ptr, dtype,
    shape, device) of every tensor they hold, a module's parameters and
    buffers by name; scalars and strings by value. None when ``consts``
    hold something else, whose storage cannot be shown unchanged."""
    if consts is None or isinstance(consts, (bool, int, float, str)):
        return ("value", consts)
    if isinstance(consts, torch.Tensor):
        return ("tensor", consts.data_ptr(), consts.dtype,
                tuple(consts.shape), str(consts.device))
    if isinstance(consts, torch.nn.Module):
        named = list(consts.named_parameters()) + \
            list(consts.named_buffers())
        return ("module",) + tuple((n, _storage_pin(t)) for n, t in named)
    if isinstance(consts, (list, tuple)):
        items = tuple(_storage_pin(c) for c in consts)
        return None if None in items else ("seq",) + items
    if isinstance(consts, dict):
        items = tuple((k, _storage_pin(v)) for k, v in sorted(consts.items()))
        return None if any(v is None for _, v in items) \
            else ("dict",) + items
    return None


def fusion_enabled() -> bool:
    return os.environ.get("NNSTPU_FUSE", "1").strip().lower() not in (
        "0", "false", "no", "off"
    )


def _single_io(el: Element) -> bool:
    return len(el.sinkpads) == 1 and len(el.srcpads) == 1


def _stage_of(el: Element) -> Optional[DeviceStage]:
    getter = getattr(el, "device_stage", None)
    if getter is None:
        return None
    try:
        return getter()
    except Exception as e:  # noqa: BLE001 — an element that can't stage
        # simply stays unfused; fusion is an optimization, never a failure
        log.debug("element %s not fusible: %s", el.name, e)
        return None


def device_foldable(el: Element) -> bool:
    """Whether this element currently offers a device stage, i.e. whether
    ``fuse_pipeline`` could fold its per-frame math into a region."""
    return _single_io(el) and _stage_of(el) is not None


def _same_device(a: Optional[torch.device],
                 b: Optional[torch.device]) -> bool:
    return a is None or b is None or a == b


@functools.lru_cache(maxsize=None)
def _torch_dtype(np_dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


def _signature(tensors: Sequence[Any]) -> tuple:
    """Shapes and dtypes of a frame: one graph per signature."""
    return tuple((tuple(t.shape), t.dtype if isinstance(t, torch.Tensor)
                  else _torch_dtype(np.asarray(t).dtype)) for t in tensors)


class _Graph:
    """One captured signature: the graph, its static inputs and outputs,
    and the kernel launches (``ops/_counts.py``) one replay runs."""

    def __init__(self, graph, inputs, outputs, tally):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.tally = tally

    def replay(self, tensors: Sequence[Any]) -> List[torch.Tensor]:
        """Copy a frame into the static inputs, replay, and return copies
        of the outputs (the next replay overwrites the static ones, while
        downstream may still hold this frame's), all on the current
        stream."""
        for s, t in zip(self.inputs, tensors):
            copy_host_to(s, t)
        self.graph.replay()
        _counts.add_replay(self.tally)
        return [o.clone() for o in self.outputs]


class FusedRegion(Element):
    """Replaces a run of fusible elements with one dispatch per frame: a
    CUDA graph replay on the card, a direct call of the composed stages on
    the CPU.

    The member elements stay in the pipeline (their properties, stats and
    custom-event handling remain live); only their pads are re-routed so
    buffers flow through this region instead. Caps negotiation chains the
    members' own ``transform_caps``. Custom events are delivered into the
    member chain (internal links are kept); whatever the members do NOT
    consume reaches this region's internal return pad and is forwarded
    downstream — the consume semantics of the unfused graph.
    """

    ELEMENT_NAME = "fused_region"
    #: device tensors enter as they are: they are copied into the graph's
    #: static inputs (or handed to the composed stages on the CPU)
    DEVICE_PASSTHROUGH = True
    #: a queue feeding a region may hand its backlog as one list: each
    #: buffer dispatches at once and the dispatch window paces them
    HANDLES_LIST = True
    PROPERTIES = {**Element.PROPERTIES, "inflight": 2}

    def __init__(self, members: Sequence[Element], name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        #: receives whatever flows out of the last member (events only —
        #: buffers no longer flow through members)
        self.internal_pad = self.add_sink_pad("fused-internal")
        self.members: List[Element] = list(members)
        # `tensor_filter inflight=K` keeps its meaning after fusion
        member_inflight = [int(m.get_property("inflight"))
                           for m in self.members if "inflight" in m._props]
        if member_inflight:
            self._props["inflight"] = max(member_inflight)
        self._window = DispatchWindow(self)
        #: (consts_list, composed fn, finalize, device) — swapped
        #: atomically; readers take one local reference
        self._compiled = None
        #: stage keys of the last build; the CPU's signatures seen and
        #: the card's graphs belong to them
        self._keys: Optional[list] = None
        self._seen: set = set()
        self._graphs: Dict[tuple, _Graph] = {}
        self._pool = None    # the graphs' shared memory pool (lazy)
        self._stream = None  # the capture stream (lazy)
        self._dead = False   # set when un-spliced back out of the graph
        self._m_retrace = None
        self._m_whole = None
        #: frames the composed stages ran on directly (every CPU frame;
        #: on the card each signature's first), graph replays, captures
        self.eager_frames = 0
        self.replays = 0
        self.captures = 0
        #: frames dropped by a downstream QoS interval before dispatch
        self.qos_drops = 0

    # -- stage (re)build -----------------------------------------------------
    def _build(self):
        stages = []
        for m in self.members:
            st = _stage_of(m)
            if st is None:
                raise FlowError(f"fused region {self.name}: member {m.name} "
                                f"is no longer fusible")
            stages.append(st)
        devices = {st.device for st in stages if st.device is not None}
        if len(devices) > 1:
            raise FlowError(f"fused region {self.name}: members compute on "
                            f"{sorted(str(d) for d in devices)}")
        device = devices.pop() if devices else None
        # the device is part of what a graph computes: a stage key names
        # the computation, not where it runs; the storage pin names the
        # addresses its consts hold, which a graph replays
        keys = [None if st.key is None or pin is None else (st.key, pin)
                for st, pin in ((st, _storage_pin(st.consts))
                                for st in stages)]
        keys.append(("device", str(device)))
        # a None key means "cannot prove the computation is unchanged"
        if any(k is None for k in keys) or keys != self._keys:
            self._keys = None if any(k is None for k in keys) else keys
            self._seen = set()
            self._drop_graphs()
        fns = [st.fn for st in stages]

        def composed(consts, tensors):
            for f, c in zip(fns, consts):
                tensors = f(c, list(tensors))
            return list(tensors)

        compiled = ([st.consts for st in stages], composed,
                    stages[-1].finalize, device)
        self._compiled = compiled
        if self._m_whole is None:
            ref = weakref.ref(self)

            def _whole() -> float:
                r = ref()
                return 1.0 if (r is not None and r._compiled is not None
                               and r._compiled[2] is not None) else 0.0

            self._m_whole = get_registry().gauge(
                "nns_fuse_whole_graph",
                "1 when this region covers the whole device-decodable graph "
                "(finalizing decoder stage folded in: host-only work "
                "deferred to the sink's fetch point)",
                fn=_whole, **self._labels())
        return compiled

    def _labels(self) -> Dict[str, str]:
        return {"pipeline": getattr(self.pipeline, "name", "") or "",
                "element": self.name}

    def _count_retrace(self) -> None:
        """``nns_fuse_retraces_total``: one per capture on the card, one
        per new input signature on the CPU (as JAX counts traces)."""
        if self._m_retrace is None:
            self._m_retrace = get_registry().counter(
                "nns_fuse_retraces_total",
                "Region captures (a CUDA graph each) or, on the CPU, new "
                "input signatures", **self._labels())
        self._m_retrace.inc()

    def obs_snapshot(self):
        out = super().obs_snapshot()
        out.update(eager_frames=self.eager_frames, replays=self.replays,
                   captures=self.captures, qos_drops=self.qos_drops)
        out.update(self._window.snapshot())
        if self._m_retrace is not None:
            out["retraces"] = int(self._m_retrace.value)
        return out

    def _drop_graphs(self) -> None:
        if self._graphs:
            # a replay may still run on the card: the graphs' memory pool
            # must outlive it (no graph was captured where CUDA never
            # started)
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self._graphs = {}

    def invalidate(self) -> None:
        """Drop the built stages and the captured graphs; the next frame
        re-pulls member stages (and captures anew on the card). A property
        edit, a custom event, a model reload and ``degrade`` come here."""
        self._compiled = None
        # outstanding dispatches belong to the old stages
        self._window.drain()
        self._drop_graphs()

    def start(self):
        super().start()
        if self._dead:
            return
        # members were restarted (backends re-opened, possibly with changed
        # properties): rebuild the stages. _build keeps the captured graphs
        # only when every new stage key and storage pin equals the last
        # build's and none is None, as the JAX region keeps its trace: the
        # pin holds the addresses of the consts the graph replays (the
        # torch backend's module's parameters and buffers, the decoder's
        # consts), so a plain restart replays instead of capturing again
        # and a rebound weight captures anew
        self._compiled = None
        self._window.drain()  # stop() drained it: nothing crosses a restart
        try:
            self._build()
        except FlowError:
            # a member stopped being fusible (properties changed while the
            # pipeline was NULL) — fall back to the original element links
            self.unsplice()

    # -- negotiation ---------------------------------------------------------
    def transform_caps(self, pad, caps):
        for m in self.members:
            out = m.transform_caps(m.sinkpads[0], caps)
            if out is None:
                return None
            caps = out
        return caps

    # -- hot path ------------------------------------------------------------
    def chain(self, pad, buf):
        if pad is self.internal_pad:
            raise FlowError(f"{self.name}: buffer on internal event pad")
        if self._qos_throttled():
            # downstream-rate QoS drop, before any copy or replay; the
            # frame never reaches a fence
            self.qos_drops += 1
            release_shed_payload(buf)
            return None
        seq = buf.meta.get(_timeline.TRACE_SEQ_META)
        # the device span starts before the chaos hook: an injected
        # filter.invoke stall models a slow dispatch
        t_dev0 = time.monotonic()
        tl = _timeline.ACTIVE
        if tl is not None and seq is not None:
            t_in = buf.meta.pop(_timeline.HANDOFF_META, None)
            if t_in is not None:
                # from the sender's hand-off; handed in a list, its wait
                # behind the frames before it
                tl.span("queue_wait", seq, t_in, t_dev0, track=self.name)
        fi = _faults.ACTIVE
        if fi is not None:
            # the fused members' filter.invoke site (the filter's chain
            # does not run while fused), before the stash pop and any
            # copy or replay: a retry re-enters with the buffer intact
            fi.check("filter.invoke", seq=seq)
        compiled = self._compiled
        if compiled is None:
            try:
                compiled = self._build()
            except FlowError:
                # a member stopped being fusible mid-stream — the unfused
                # pipeline's behavior resumes seamlessly
                return self._fallback(buf)
        consts, fn, finalize, device = compiled
        stash = buf.meta.pop(POOL_STASH_META, None)
        tensors = list(buf.tensors)
        sig = _signature(tensors)
        on_card = device is not None and device.type == "cuda"
        graph = self._graphs.get(sig) if on_card else None
        if graph is not None:
            with torch.cuda.device(device):
                out = graph.replay(tensors)
            self.replays += 1
        elif not on_card and sig in self._seen:
            out = fn(consts, tensors)
            self.eager_frames += 1
        else:
            try:
                out = self._first_frame(consts, fn, device, sig, tensors,
                                        on_card)
            except Exception as e:  # noqa: BLE001 — fusion is an
                # optimization, never a failure: a stage that will not
                # run, capture or finish its first frame falls back to the
                # member chain, whose own error handling is authoritative;
                # failures of later frames are pipeline errors like any
                # other
                log.warning("%s: fused stages failed (%s); falling back to "
                            "member chain", self.name, e)
                if stash:
                    buf.meta[POOL_STASH_META] = stash
                return self._fallback(buf)
        # bounded asynchronous dispatch: the event follows the output
        # copies on this stream; the oldest batch fences only when more
        # than `inflight` are outstanding, and this frame's staging
        # arrays recycle at its fence
        t_dev1 = None
        if tl is not None and seq is not None:
            t_dev1 = time.monotonic()
            tl.span("device", seq, t_dev0, t_dev1, track=self.name)
        self._window.admit(out, stash, frame=seq)
        out_buf = buf.with_tensors(out)
        if t_dev1 is not None:
            out_buf.meta[_timeline.HANDOFF_META] = t_dev1
        if finalize is not None:
            out_buf = out_buf.replace(finalize=finalize)
        if peer_device_capable(self.srcpad):
            # downstream forwards resident buffers — keep them resident
            out_buf = as_device_buffer(out_buf)
        return self.srcpad.push(out_buf)

    def _first_frame(self, consts, fn, device, sig, tensors, on_card):
        """The first frame of a new signature: through the composed stages
        and, on the card, captured."""
        if not on_card:
            out = fn(consts, tensors)
            self.eager_frames += 1
            self._seen.add(sig)
            self._count_retrace()
            return out
        with torch.cuda.device(device):
            out, self._graphs[sig] = self._run_and_capture(consts, fn,
                                                           device, tensors)
        return out

    def _capture_stream(self, device: torch.device):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream

    def _run_and_capture(self, consts, fn, device, tensors):
        """The eager first frame, on the capture stream and synchronised
        (its output is the frame's; it also builds and loads the kernel
        libraries and sets up cuBLAS and cuDNN for that stream outside the
        capture), then one capture of the same stages on static inputs."""
        stream = self._capture_stream(device)
        cur = torch.cuda.current_stream(device)
        ins = [as_torch(t, device, non_blocking=True) for t in tensors]
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            out = fn(consts, ins)
        for o in out:
            if not (isinstance(o, torch.Tensor) and o.device == device):
                raise FlowError(f"{self.name}: a stage output is not a "
                                f"tensor on {device}")
            o.record_stream(cur)
        cur.wait_stream(stream)
        stream.synchronize()
        self.eager_frames += 1
        static_in = [torch.empty(i.shape, dtype=i.dtype, device=device)
                     for i in ins]
        for s, i in zip(static_in, ins):
            s.copy_(i)
        graph = torch.cuda.CUDAGraph()
        # "thread_local": the pipeline's other threads (a queue worker, a
        # sink's fetch) keep calling CUDA while this thread captures
        with _counts.capture_tally() as tally, torch.cuda.graph(
                graph, pool=self._pool, stream=stream,
                capture_error_mode="thread_local"):
            static_out = fn(consts, static_in)
        self.captures += 1
        self._count_retrace()
        return out, _Graph(graph, static_in, list(static_out), dict(tally))

    def _fallback(self, buf):
        """Restore the original element links and replay ``buf`` (and all
        future buffers) through the member chain."""
        self.unsplice()
        first = self.members[0]
        return first._chain_entry(first.sinkpads[0], buf)

    def handle_eos(self):
        # every outstanding dispatch fences before EOS crosses downstream
        self._window.drain()

    def stop(self):
        self._window.drain(on_error="log")
        super().stop()

    # -- events --------------------------------------------------------------
    def src_event(self, pad: Pad, event: Event) -> None:
        if isinstance(event, QosEvent) and any(
                type(m).src_event is not Element.src_event
                for m in self.members):
            # a member consumes QoS (the filter): the event targets THIS
            # region's dispatch, since the members' chains don't run.
            # Delivered through the member chain too, so the members' QoS
            # state is right if the region later unsplices — and exactly
            # one throttle gates the stream
            self._qos_interval_s = event.target_interval_ns / 1e9
            last = self.members[-1]
            last._upstream_event_entry(last.srcpads[0], event)
            return
        # no consuming member: upstream past the region via the data sink
        # pad only (the base default would also loop the internal pad,
        # re-dispatching the event into the member chain)
        self.sinkpads[0].push_upstream_event(event)

    def sink_event(self, pad: Pad, event: Event) -> None:
        if pad is self.internal_pad:
            # an event the member chain chose to forward — pass it on
            self.srcpad.push_event(event)
            return
        if isinstance(event, CustomEvent):
            # deliver through the member chain; members that consume it
            # stop it there, others forward it to the internal pad which
            # sends it downstream
            self.members[0]._event_entry(self.members[0].sinkpads[0], event)
            self.invalidate()
            return
        if isinstance(event, EosEvent):
            # the internal event pad never sees EOS, so the base "all sink
            # pads at EOS" rule would deadlock — the data sink pad alone
            # decides here
            self.handle_eos()
            self.srcpad.push_event(event)
            return
        super().sink_event(pad, event)

    def __repr__(self):
        names = "+".join(m.name for m in self.members)
        return f"<FusedRegion [{names}]>"

    # -- splicing ------------------------------------------------------------
    def splice(self, pipe) -> None:
        self.pipeline = pipe
        for m in self.members:
            m._fused_region = self  # member-level property edits invalidate
        first, last = self.members[0], self.members[-1]
        up_src = first.sinkpads[0].peer
        down_sink = last.srcpads[0].peer
        if up_src is not None:
            up_src.unlink()
            up_src.link(self.sinkpad)
        if down_sink is not None:
            last.srcpads[0].unlink()
            self.srcpad.link(down_sink)
        # route member-chain event outflow back through this region
        last.srcpads[0].link(self.internal_pad)
        log.info("fused region: %s", self)

    def unsplice(self) -> None:
        """Restore the original element links (region becomes inert)."""
        # outstanding dispatches belong to the dying region: fence them so
        # the member chain can never overtake their results
        self._window.drain()
        first, last = self.members[0], self.members[-1]
        last.srcpads[0].unlink()  # internal pad
        up_src = self.sinkpad.peer
        down_sink = self.srcpad.peer
        if up_src is not None:
            up_src.unlink()
            up_src.link(first.sinkpads[0])
        if down_sink is not None:
            self.srcpad.unlink()
            last.srcpads[0].link(down_sink)
        for m in self.members:
            m._fused_region = None
        self._dead = True
        log.info("unspliced region: %s", self)


def fuse_pipeline(pipe) -> List[FusedRegion]:
    """Find maximal fusible runs and splice FusedRegions into the graph.

    Must run after non-source elements started (filter backends open their
    models in start(), and a backend is what makes a filter fusible) and
    before sources begin pushing. A run ends at a finalizing stage and at
    a stage on another device than the run's.
    """
    regions: List[FusedRegion] = []
    in_run = set()
    stage_cache: dict = {}

    def stage_of(el):
        if id(el) not in stage_cache:
            stage_cache[id(el)] = _stage_of(el)
        return stage_cache[id(el)]

    for el in pipe.elements:
        if id(el) in in_run or not _single_io(el):
            continue
        head_stage = stage_of(el)
        if head_stage is None:
            continue
        up = el.sinkpads[0].peer.element if el.sinkpads[0].peer else None
        if up is not None and _single_io(up):
            up_stage = stage_of(up)
            # upstream fusible and able to extend → el is not a run head;
            # a finalizing upstream (or one on another device) ends its
            # own run, so el IS a head
            if up_stage is not None and up_stage.finalize is None and \
                    _same_device(up_stage.device, head_stage.device):
                continue
        run = [el]
        device = head_stage.device
        cur = el
        while stage_of(cur).finalize is None:
            peer = cur.srcpads[0].peer
            nxt = peer.element if peer else None
            if nxt is None or not _single_io(nxt) or stage_of(nxt) is None \
                    or not _same_device(device, stage_of(nxt).device):
                break
            run.append(nxt)
            device = device or stage_of(nxt).device
            cur = nxt
        if len(run) < 2:
            continue
        for m in run:
            in_run.add(id(m))
        region = FusedRegion(run, name="+".join(m.name for m in run))
        region.splice(pipe)
        regions.append(region)
    return regions
