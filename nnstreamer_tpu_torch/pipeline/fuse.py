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

A torch backend's stage hands the region a ``hold``, its dispatch lock:
a weights swap or a reload waits for the dispatch that reads the weights,
and a dispatch that waited for a swap re-pulls the stages the swap
rebuilt. Under an HBM budget (``tensors/memory.py``) the hold also keeps
the stage's residency unit resident for the compute (downstream runs
after the hold is released) and reads the unit's load count. When the
count changed, the weights were evicted and loaded into new storage, so
the region drops its graphs (``rebinds``) and the frame captures anew. The JAX region is not
used under a budget (the JAX filter is not fusible then); the port keeps
the region and pays a capture per reload. A region that holds two weight
units needs both resident at once.

A member carrying a ``mesh=`` spec (``parallel/serve.py``) makes the
whole region sharded: every frame tensor is placed over the mesh
(``serve.place_batch``: a matched sharded input moves no byte) before
anything else, and each mesh device runs the composed stages on its
shard, with its own copy of the weights — on the card one CUDA graph per
device and signature, each launching its kernels once per shard. Mixed
specs in one run are a plan-time :class:`MeshShardingError`; the spec is
part of the region's key. :func:`verify_mesh_boundaries` checks, at
``Pipeline.start()``, that every device hand-off between sharded
invokers joins equal specs, and lets a producer whose consumers all match
hand its sharded outputs on as they are; any other sharded output is
gathered onto the mesh's first device.

What the JAX module has and this one does not: donation of the input slab
(``NNSTPU_DONATE``) has no counterpart, since the graph reads static input
buffers into which each frame is copied.

Disable globally with ``NNSTPU_FUSE=0`` or per pipeline with
``Pipeline(fuse=False)``.
"""

from __future__ import annotations

import contextlib
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
from nnstreamer_tpu_torch.parallel import serve as _serve
from nnstreamer_tpu_torch.pipeline import faults as _faults
from nnstreamer_tpu_torch.pipeline.element import (
    CustomEvent,
    Element,
    EosEvent,
    Event,
    FlowError,
    Pad,
    QosEvent,
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
    #: the serving-mesh spec the stage computes under; its ``consts`` are
    #: then one per mesh device (a copy of the weights each)
    mesh: Optional[str] = None
    #: ``hold() -> context manager`` keeping the consts' device storage
    #: in place and unchanged for one dispatch (the torch backend's
    #: dispatch lock and, under a budget, its weights' HBM residency
    #: unit, ``tensors/memory.py``); it yields a generation that changes
    #: whenever that storage was made anew (an evicted unit reloaded),
    #: which drops the region's graphs
    hold: Optional[Callable[[], Any]] = None


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


class _Pushed:
    """A frame the member chain already took (a region's fallback), with
    the chain's return value."""

    __slots__ = ("ret",)

    def __init__(self, ret):
        self.ret = ret


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
        #: (consts_list, composed fn, finalize, device, holds) — swapped
        #: atomically; readers take one local reference
        self._compiled = None
        #: the stages' storage generations the graphs were captured at
        self._generation: Optional[tuple] = None
        #: graph sets dropped because a stage's storage was made anew
        self.rebinds = 0
        #: stage keys of the last build; the CPU's signatures seen and
        #: the card's graphs belong to them
        self._keys: Optional[list] = None
        self._seen: set = set()
        self._graphs: Dict[tuple, _Graph] = {}
        #: per device: the capture stream and the graphs' shared memory
        #: pool (lazy; a sharded region captures on every mesh device)
        self._streams: Dict[torch.device, tuple] = {}
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
        #: serving MeshPlan adopted from the members' mesh= specs (set by
        #: _build); None = single-device region
        self._mesh_plan = None
        #: set by verify_mesh_boundaries: every consumer down the device
        #: hand-off is a matched sharded invoker (outputs stay sharded)
        self._mesh_handoff = False

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
        # mesh adoption: a member carrying a mesh= spec shards the WHOLE
        # region over that mesh. One region has one mesh — mixed specs
        # inside a run are a hard plan-time error (NOT a FlowError:
        # silently unsplicing to per-element dispatch would hide a
        # sharding contract violation)
        specs = sorted({st.mesh for st in stages if st.mesh is not None})
        if len(specs) > 1:
            raise _serve.MeshShardingError(
                f"fused region {self.name}: members carry mixed mesh specs "
                f"{specs}; align the mesh= properties or split the run "
                f"with a non-fusible element")
        plan = _serve.get_mesh_plan(specs[0]) \
            if specs and _serve.mesh_enabled() else None
        self._mesh_plan = plan
        if plan is not None:
            device = plan.mesh.device_list()[0].device
        # the device is part of what a graph computes: a stage key names
        # the computation, not where it runs; the storage pin names the
        # addresses its consts hold, which a graph replays
        keys = [None if st.key is None or pin is None else (st.key, pin)
                for st, pin in ((st, _storage_pin(st.consts))
                                for st in stages)]
        keys.append(("device", str(device)))
        # the same member stages run per shard on another mesh
        keys.append(("mesh", plan.spec if plan is not None else ""))
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

        holds = [st.hold for st in stages if st.hold is not None]
        consts = [st.consts for st in stages]
        if plan is not None:
            # one consts list per mesh device: a sharded stage's own copy
            # there, every other stage's consts as they are
            consts = [[st.consts[i] if st.mesh is not None else st.consts
                       for st in stages] for i in range(plan.shard_count)]
        compiled = (consts, composed, stages[-1].finalize, device, holds,
                    plan)
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
                   captures=self.captures, qos_drops=self.qos_drops,
                   rebinds=self.rebinds)
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

    def rebuild(self) -> None:
        """Re-pull the member stages at the next frame, keeping the
        graphs when every stage key and storage pin is unchanged (a
        weights-only swap copied in place); a rebound weight captures
        anew. ``Pipeline.swap_model`` comes here."""
        self._compiled = None
        self._window.drain()

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
        while True:
            compiled = self._compiled
            if compiled is None:
                try:
                    compiled = self._build()
                except FlowError:
                    # a member stopped being fusible mid-stream — the
                    # unfused pipeline's behavior resumes seamlessly
                    return self._fallback(buf)
            holds = compiled[4]
            if not holds:
                out = self._dispatch(buf, compiled, seq, t_dev0, tl)
                break
            with contextlib.ExitStack() as held:
                gen = tuple(held.enter_context(h()) for h in holds)
                if self._compiled is not compiled:
                    # a swap rebuilt the stages while this frame waited
                    # for the hold: dispatch on what it installed
                    continue
                if gen != self._generation:
                    if self._generation is not None and self._graphs:
                        # an evicted stage's storage was made anew: the
                        # graphs read the old addresses
                        self._drop_graphs()
                        self.rebinds += 1
                    self._generation = gen
                out = self._dispatch(buf, compiled, seq, t_dev0, tl)
            break
        # downstream runs outside the hold: a region further down the same
        # thread may need this region's weights evicted to load its own
        if isinstance(out, _Pushed):
            return out.ret
        return self.srcpad.push(out)

    def _dispatch(self, buf, compiled, seq, t_dev0, tl):
        """One frame through the replayed graph, or the composed stages
        (and a capture) for a new signature: the buffer to push, or
        :class:`_Pushed` when the member chain took the frame."""
        if compiled[5] is not None:
            return self._dispatch_mesh(buf, compiled, seq, t_dev0, tl)
        consts, fn, finalize, device, _holds, _plan = compiled
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
                return _Pushed(self._fallback(buf))
        return self._emit(buf, out, stash, finalize, seq, t_dev0, tl)

    def _emit(self, buf, out, stash, finalize, seq, t_dev0, tl):
        """The dispatched frame's output buffer, admitted to the dispatch
        window."""
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
        return out_buf

    def _dispatch_mesh(self, buf, compiled, seq, t_dev0, tl):
        """One frame of a sharded region: placed over the mesh, then each
        device's shard through the composed stages with that device's
        consts — a replay of the device's graph for a known signature on
        the card, else the stages (and, on the card, a capture)."""
        consts, fn, finalize, _device, _holds, plan = compiled
        stash = buf.meta.pop(POOL_STASH_META, None)
        # mesh placement first: an input already carrying the plan's
        # placement (the matched hand-off from an upstream sharded
        # invoker) passes through untouched — zero bytes,
        # nns_reshard_bytes_total unmoved; host arrays scatter over dp.
        # The placement is the frame's "shard" span; "device" starts after
        args = [_serve.place_batch(t, plan) for t in buf.tensors]
        if tl is not None and seq is not None:
            t_sh1 = time.monotonic()
            tl.span("shard", seq, t_dev0, t_sh1, track=self.name)
            t_dev0 = t_sh1
        per_device = []
        for i, md in enumerate(plan.mesh.device_list()):
            dev = md.device
            local = [a.shards[i] for a in args]
            sig = (i, _signature(local))
            on_card = dev.type == "cuda"
            graph = self._graphs.get(sig) if on_card else None
            if graph is not None:
                with torch.cuda.device(dev):
                    out = graph.replay(local)
                self.replays += 1
            elif not on_card and sig in self._seen:
                out = fn(consts[i], local)
                self.eager_frames += 1
            else:
                try:
                    out = self._first_frame(consts[i], fn, dev, sig, local,
                                            on_card)
                except Exception as e:  # noqa: BLE001 — as _dispatch
                    log.warning("%s: fused stages failed (%s); falling "
                                "back to member chain", self.name, e)
                    if stash:
                        buf.meta[POOL_STASH_META] = stash
                    return _Pushed(self._fallback(buf))
            per_device.append(out)
        out = _serve.shard_outputs(per_device, args, plan.mesh)
        if not self._mesh_handoff:
            # the mesh's egress: one tensor each on its first device
            out = [_serve.gather(x) for x in out]
        out_buf = self._emit(buf, out, stash, finalize, seq, t_dev0, tl)
        # the hand-off names the mesh this batch was computed on
        out_buf.meta[_serve.MESH_SPEC_META] = plan.spec
        return out_buf

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
        """``device``'s capture stream and graph memory pool."""
        if device not in self._streams:
            with torch.cuda.device(device):
                self._streams[device] = (torch.cuda.Stream(device),
                                         torch.cuda.graph_pool_handle())
        return self._streams[device]

    def _run_and_capture(self, consts, fn, device, tensors):
        """The eager first frame, on the capture stream and synchronised
        (its output is the frame's; it also builds and loads the kernel
        libraries and sets up cuBLAS and cuDNN for that stream outside the
        capture), then one capture of the same stages on static inputs."""
        stream, pool = self._capture_stream(device)
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
                graph, pool=pool, stream=stream,
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


# --------------------------------------------------------------------------
# plan-time matched-sharding verification (parallel/serve.py contract)
# --------------------------------------------------------------------------
def _element_plan(el):
    """The serving-mesh plan this element invokes under, or None: a
    sharded fused region's (``_mesh_plan`` from _build) or an UNFUSED
    tensor_filter's backend's."""
    plan = getattr(el, "_mesh_plan", None)
    if plan is None:
        plan = getattr(getattr(el, "fw", None), "_mesh_plan", None)
    return plan


def _element_mesh_spec(el) -> Optional[str]:
    plan = _element_plan(el)
    return plan.spec if plan is not None else None


def verify_mesh_boundaries(pipe) -> None:
    """PLAN-time check of the matched-sharding contract: every device-
    passthrough hand-off between two mesh-sharded invokers must carry
    identical mesh specs, so the producer's out-placement equals the
    consumer's in-placement and the hand-off moves ZERO bytes. A mismatch
    raises :class:`~nnstreamer_tpu_torch.parallel.serve.MeshShardingError`
    before any frame flows. (Hand-offs that cross a non-passthrough
    element materialize to host anyway and are exempt.)

    A producer all of whose hand-offs end at matched consumers keeps its
    outputs sharded (``_mesh_handoff``); every other sharded invoker
    gathers its outputs onto the mesh's first device.

    Runs in ``Pipeline.start()`` after regions build; inert when no
    element carries a mesh plan or ``NNSTPU_MESH=0``.
    """
    producers = []
    for el in _live_invokers(pipe):
        if hasattr(el, "_mesh_handoff"):
            el._mesh_handoff = False
        spec = _element_mesh_spec(el) if _serve.mesh_enabled() else None
        if spec is not None:
            producers.append((el, spec))
    for el, spec in producers:
        matched = [_walk_boundary(el, spec, pad, set()) for pad in el.srcpads]
        el._mesh_handoff = bool(matched) and all(matched)


def _live_invokers(pipe):
    """Pipeline elements buffers actually flow through: added elements
    minus fused members, plus the spliced regions themselves (regions
    live in ``pipe._regions``, not ``pipe.elements``)."""
    for el in getattr(pipe, "elements", []):
        if getattr(el, "_fused_region", None) is not None:
            continue  # fused member: its pads are re-routed
        yield el
    for r in (getattr(pipe, "_regions", None) or ()):
        if not getattr(r, "_dead", False):
            yield r


def pipeline_shard_count(pipe) -> int:
    """Largest serving-mesh fan-out any invoker in the pipeline runs
    under (1 = single device) — the SLO scheduler aligns its admission
    batch cap to a multiple of this so every admitted micro-batch splits
    evenly over dp shards."""
    n = 1
    for el in _live_invokers(pipe):
        plan = _element_plan(el)
        if plan is not None:
            n = max(n, int(plan.shard_count))
    return n


def _walk_boundary(producer, spec: str, pad: Pad, seen: set) -> bool:
    """Follow ``producer``'s device hand-off from ``pad``: raise on a
    consumer of another spec; True when every path ends at a consumer of
    the same spec."""
    peer = pad.peer
    if peer is None:
        return False
    el = peer.element
    if id(el) in seen:
        return True
    seen.add(id(el))
    consumer_spec = _element_mesh_spec(el)
    if consumer_spec is not None:
        if consumer_spec != spec:
            raise _serve.MeshShardingError(
                f"mesh boundary {producer.name} -> {el.name}: producer "
                f"shards over mesh={spec!r} but consumer expects "
                f"mesh={consumer_spec!r} — the hand-off would reshard "
                f"every frame; align the mesh= properties (or break "
                f"residency with a non-device-passthrough element to "
                f"make the host bounce explicit)")
        return True  # matched; the consumer's own outputs get their walk
    if not getattr(el, "DEVICE_PASSTHROUGH", False) or not el.srcpads:
        return False  # materializes to host — no device hand-off past here
    results = [_walk_boundary(producer, spec, p, seen) for p in el.srcpads]
    return all(results)
