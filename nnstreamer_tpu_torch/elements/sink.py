"""Sink elements: the application callback sink, file sink, fakesink.

Reference: ``tensor_sink`` (gst/nnstreamer/elements/gsttensorsink.c)
emits a ``new-data`` signal per buffer to the app. Here :meth:`connect`
registers callbacks, buffers are also stored (bounded by ``max-stored``)
for pull-style access, and :meth:`TensorSink.wait` blocks until N buffers
or EOS. With ``to-host=true`` (the default) the sink is the frame's fetch
point: device tensors come to the host here, and a decoder's deferred
finalize runs here. The end-to-end latency of each frame (source
``create()`` → host payload at the sink) is recorded, one sample per real
frame of an aggregated window (``meta["create_ts"]``). A padded partial
window (``meta["valid_frames"]``) is trimmed to its valid leading rows,
and staging arrays that reach the sink unclaimed (``meta["pool_stash"]``)
go back to the pool once the payload is on the host. Frames stamped by a
``stamp-admission`` queue (``meta["admitted_t"]``, or one stamp a frame of
a window in ``meta["admitted_ts"]``) also feed ``admitted_latencies``,
the served-traffic population behind ``latency_percentiles(
base="admitted")``, and in a pipeline with an SLO budget the scheduler's
completion feed (``serving/scheduler.py``). With a timeline active (the
flight recorder, by default) the sink records each frame's ``sink`` span,
carrying its end-to-end time for the ledger's reconciliation.

``filesink`` and ``fakesink`` are gst core's, used throughout the
reference's SSAT golden tests (dump, then byte-compare). Both take device
buffers as they come: ``filesink`` fetches a device payload through the
buffer's own ``to_host`` (its one D2H), ``fakesink`` never fetches one.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Callable, List

import numpy as np
import torch

from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.obs import timeline as _timeline
from nnstreamer_tpu_torch.pipeline.dispatch import POOL_STASH_META
from nnstreamer_tpu_torch.pipeline.element import Element, EosEvent, FlowReturn
from nnstreamer_tpu_torch.registry import ELEMENT, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensors.pool import get_pool


class LatencyReservoir:
    """Bounded latency sample population with exact percentiles up to
    ``cap`` and uniform reservoir sampling (Vitter's algorithm R) beyond.

    A ``deque(maxlen=N)`` is a sliding window: past N its percentiles
    describe only the most recent frames. A reservoir keeps every sample
    equally likely to be in the population whatever the stream's length,
    and below the cap the population is complete, so its percentiles are
    exact. The RNG is seeded, so a deterministic pipeline reports the same
    stats run after run. ``count`` is the number of samples offered;
    ``len()`` the number retained."""

    __slots__ = ("cap", "count", "_vals", "_rng")

    def __init__(self, cap: int = 65_536, seed: int = 0x5EED):
        self.cap = int(cap)
        self.count = 0
        self._vals: List[float] = []
        self._rng = random.Random(seed)

    def append(self, v: float) -> None:
        self.count += 1
        if len(self._vals) < self.cap:
            self._vals.append(v)
            return
        j = self._rng.randrange(self.count)
        if j < self.cap:
            self._vals[j] = v

    def __len__(self) -> int:
        return len(self._vals)

    def __iter__(self):
        return iter(self._vals)

    def clear(self) -> None:
        self.count = 0
        self._vals.clear()


@subplugin(ELEMENT, "tensor_sink")
class TensorSink(Element):
    """Terminal sink exposing buffers to the application."""

    # keeps a pending finalize lazy until chain(), which is this element's
    # materialization point
    HANDLES_DEFERRED = True
    DEVICE_PASSTHROUGH = True

    ELEMENT_NAME = "tensor_sink"
    PROPERTIES = {**Element.PROPERTIES, "sync": False, "max_stored": 4096,
                  "to_host": True}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.buffers: List[TensorBuffer] = []
        self._callbacks: List[Callable[[TensorBuffer], None]] = []
        self._cv = threading.Condition()
        self.eos = False
        #: end-to-end per-frame latencies in seconds (create_t → chain),
        #: ring-bounded so long-lived pipelines don't grow forever
        self.latencies: deque = deque(maxlen=100_000)
        #: admission-stamp → chain latencies of frames a stamp-admission
        #: queue accepted (the served population): a reservoir, so a long
        #: run keeps a uniform sample of the whole stream
        self.admitted_latencies = LatencyReservoir()
        self._m_e2e = None  # lazy: labels need the owning pipeline's name

    def _obs_e2e(self):
        if self._m_e2e is None:
            self._m_e2e = get_registry().histogram(
                "nns_sink_e2e_seconds",
                "End-to-end frame latency, source create() to sink",
                pipeline=getattr(self.pipeline, "name", "") or "",
                element=self.name)
        return self._m_e2e

    def obs_snapshot(self):
        out = super().obs_snapshot()
        pcts = self.latency_percentiles(50.0, 99.0)
        if pcts is not None:
            out["e2e_p50_ms"], out["e2e_p99_ms"] = pcts
        return out

    def connect(self, callback: Callable[[TensorBuffer], None]) -> None:
        """Register a per-buffer callback (reference ``new-data`` signal)."""
        self._callbacks.append(callback)

    def chain(self, pad, buf):
        # pooled staging arrays no dispatch window claimed: released once
        # materialization proves the device work that read them is done
        stash = buf.meta.pop(POOL_STASH_META, None)
        # a pending finalize is ALWAYS applied — even with to-host=false —
        # so the app sees the decoder's output (the fetch then covers only
        # the device half's small results, never full frames)
        if self.get_property("to_host") or buf.finalize is not None:
            buf = buf.to_host()
            # a latency-budget partial window (aggregator
            # latency-budget-ms) was padded to the full-window shape: trim
            # each tensor back to its k valid leading rows
            k = buf.meta.get("valid_frames")
            if k:
                buf = buf.with_tensors([
                    t[:k] if getattr(t, "ndim", 0) and t.shape[0] > k
                    else t for t in buf.tensors])
        # the sink span starts after materialization (the fetch is the
        # frame's d2h stage), at the sender's hand-off reading
        tl = _timeline.ACTIVE
        t_sink0 = 0.0
        if tl is not None:
            t_sink0 = buf.meta.pop(_timeline.HANDOFF_META, None) or \
                time.monotonic()
        e2e_s = e2e_adm_s = None
        # only a host payload counts as delivered: recording a device
        # handle's arrival would measure the enqueue, not the completion
        if not buf.on_device():
            if stash:
                get_pool().release_many(stash)
            now = time.monotonic()
            hist = self._obs_e2e()
            stamps = buf.create_stamps()
            for t in stamps:
                self.latencies.append(now - t)
                hist.observe(now - t)
            if tl is not None and stamps:
                # the ledger's frame: a window's first frame (its
                # aggregator stamps which), else the buffer's own
                base = buf.meta.get("tl_create_t")
                e2e_s = now - (base if base is not None
                               else sum(stamps) / len(stamps))
            # a window carries one admission stamp per frame; an
            # unaggregated buffer the one its queue wrote, counted once
            # per frame like `latencies`
            adm_list = buf.meta.get("admitted_ts")
            if adm_list is None:
                adm = buf.meta.get("admitted_t")
                if adm is not None:
                    adm_list = [adm] * max(len(stamps), 1)
            if adm_list:
                for t in adm_list:
                    self.admitted_latencies.append(now - t)
                if tl is not None:
                    e2e_adm_s = now - adm_list[0]
                sched = getattr(self.pipeline, "_slo_scheduler", None)
                if sched is not None:
                    # completion feed: the drain-rate estimate (covers a
                    # fused pipeline, whose filter chain never runs, and
                    # on the card the kernels an enqueue time misses) and
                    # the feedback controller's p99 — event-driven, the
                    # controller has no polling thread
                    sched.observe_completion(now - adm_list[0], now,
                                             frames=len(adm_list))
        with self._cv:
            if len(self.buffers) < int(self.get_property("max_stored")):
                self.buffers.append(buf)
            self._cv.notify_all()
        for cb in self._callbacks:
            cb(buf)
        if tl is not None:
            seq = buf.meta.get(_timeline.TRACE_SEQ_META)
            if seq is not None:
                extra = {}
                if e2e_s is not None:
                    extra["e2e_s"] = e2e_s
                    if e2e_adm_s is not None:
                        extra["e2e_adm_s"] = e2e_adm_s
                tl.span("sink", seq, t_sink0, time.monotonic(),
                        track=self.name, **extra)
        return FlowReturn.OK

    def latency_percentiles(self, *qs: float, skip: int = 0,
                            base: str = "create"):
        """End-to-end frame latency percentiles in ms (default p50, p99).
        ``base="create"`` measures from the source's capture stamp;
        ``base="admitted"`` from the upstream stamp-admission queue's
        accept point (served-traffic latency; None when no queue stamps).
        ``skip`` drops the first N frames (warm-up exclusion)."""
        if base not in ("create", "admitted"):
            raise ValueError(f"{self.name}: latency base must be 'create' "
                             f"or 'admitted', not {base!r}")
        pop = self.admitted_latencies if base == "admitted" \
            else self.latencies
        vals = list(pop)[skip:]
        if not vals:
            return None
        qs = qs or (50.0, 99.0)
        arr = np.asarray(vals, dtype=np.float64) * 1e3
        return tuple(float(np.percentile(arr, q)) for q in qs)

    def sink_event(self, pad, event):
        if isinstance(event, EosEvent):
            with self._cv:
                self.eos = True
                self._cv.notify_all()
        super().sink_event(pad, event)

    def wait(self, n: int = 1, timeout: float = 30.0) -> List[TensorBuffer]:
        """Block until at least ``n`` buffers arrived or EOS/timeout."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while len(self.buffers) < n and not self.eos:
                left = deadline - time.monotonic()
                if left <= 0 or not self._cv.wait(timeout=left):
                    break
            return list(self.buffers)


def tensor_bytes(t) -> bytes:
    """The raw bytes of a host tensor in row-major order (a ``bfloat16``
    CPU tensor included)."""
    if isinstance(t, torch.Tensor):
        return t.detach().contiguous().view(-1).view(torch.uint8) \
            .numpy().tobytes()
    return np.ascontiguousarray(t).tobytes()


@subplugin(ELEMENT, "filesink")
class FileSink(Element):
    """Dump raw tensor bytes to a file (gst filesink) — the SSAT
    golden-output pattern: run pipeline, byte-compare the dump."""

    ELEMENT_NAME = "filesink"
    DEVICE_PASSTHROUGH = True  # chain's own to_host is the fetch point
    PROPERTIES = {**Element.PROPERTIES, "location": None, "append": False}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self._fh = None

    def start(self):
        super().start()
        loc = self.get_property("location")
        if loc is None:
            raise ValueError("filesink: location not set")
        mode = "ab" if self.get_property("append") else "wb"
        self._fh = open(loc, mode)

    def chain(self, pad, buf):
        stash = buf.meta.pop(POOL_STASH_META, None)
        buf = buf.to_host()
        if stash:
            get_pool().release_many(stash)
        for t in buf.tensors:
            self._fh.write(tensor_bytes(t))
        return FlowReturn.OK

    def handle_eos(self):
        if self._fh:
            self._fh.flush()

    def stop(self):
        if self._fh:
            self._fh.close()
            self._fh = None
        super().stop()


@subplugin(ELEMENT, "fakesink")
class FakeSink(Element):
    """Discard buffers (gst fakesink); counts them for tests."""

    HANDLES_DEFERRED = True  # discards buffers; never forces the D2H
    DEVICE_PASSTHROUGH = True  # ditto for resident payloads

    ELEMENT_NAME = "fakesink"
    PROPERTIES = {**Element.PROPERTIES, "sync": False}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.count = 0

    def chain(self, pad, buf):
        self.count += 1
        return FlowReturn.OK
