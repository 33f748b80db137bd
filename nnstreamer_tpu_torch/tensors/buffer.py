"""TensorBuffer — one stream frame: N tensors + timing metadata.

The reference flows ``GstBuffer``s holding up to 16 ``GstMemory`` chunks
(one per tensor) with pts/dts/duration and attachable metas. Here a frame
is a list of host ``numpy.ndarray``s or ``torch.Tensor``s; a tensor on a
non-CPU device stays there as it flows between elements. Host/device
placement is explicit: :meth:`TensorBuffer.to_device` and
:meth:`TensorBuffer.to_host` use ``Tensor.to(device, non_blocking=...)``.

On the host a tensor is a numpy array, except ``bfloat16``, which numpy
cannot hold without an extension type: it stays a CPU ``torch.Tensor``.

:class:`DeviceBuffer` is a device-resident frame whose host copy is made
once and cached, or adopted from the host arrays it was uploaded from
(``host_view``). :func:`upload_many` and :func:`materialize_many` batch a
queue's drained run into one host→device copy from a pinned staging slab
(``tensors/pool.py``) and one device→host fetch with one synchronisation.

**Streams.** Every copy here runs on the calling thread's current stream.
The port sets no other current stream outside a CUDA-graph capture
(``pipeline/fuse.py``), so in every thread that is the device's default
stream, and an upload, the dispatch that reads it and the fetch of its
results run in the order the host enqueued them, whichever threads did.
A host→device copy from a pool slab records an event that the pool waits
for before it hands the slab out again (:func:`note_h2d`).

**Observability.** With a timeline active (``obs/timeline.py``) every
transfer records an ``h2d`` or ``d2h`` span for the frame it moves — each
frame of a batched upload or grouped fetch gets its own, over the whole
transfer — and the ``transfer.h2d`` / ``transfer.d2h`` fault hooks
(``pipeline/faults.py``) fire where the JAX module's do.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nnstreamer_tpu_torch.obs import timeline as _timeline
from nnstreamer_tpu_torch.tensors.pool import get_pool, note_copy, pinned_view
from nnstreamer_tpu_torch.tensors.types import (
    NNS_TENSOR_SIZE_LIMIT,
    TensorsInfo,
)

#: Sentinel for "no timestamp" (reference GST_CLOCK_TIME_NONE).
CLOCK_NONE: Optional[int] = None

#: meta key marking a buffer whose device payload an upload point created
#: for exactly one downstream consumer (a dropped frame's payload may then
#: be cleared at once, ``pipeline/dispatch.py``)
H2D_EXCLUSIVE_META = "h2d_exclusive"

# -- transfer accounting ------------------------------------------------------
# Process-wide tallies of host<->device copies; callers diff two
# transfer_snapshot()s for per-run numbers. The batched counters count one
# event per staged multi-frame copy (upload_many / materialize_many), which
# moves no per-frame event counter. d2h_syncs counts the host's waits for
# device->host copies: one per grouped fetch, one per tensor of a plain
# to_host, one per prefetched buffer.
_xfer_lock = threading.Lock()
_xfer: Dict[str, float] = {
    "h2d_bytes": 0.0, "h2d_events": 0.0,
    "d2h_bytes": 0.0, "d2h_events": 0.0,
    "h2d_batched_events": 0.0, "h2d_batched_frames": 0.0,
    "d2h_batched_events": 0.0, "d2h_batched_frames": 0.0,
    "d2h_syncs": 0.0,
}
_xfer_metrics: Optional[Dict[str, Any]] = None


def _xfer_obs() -> Dict[str, Any]:
    global _xfer_metrics
    if _xfer_metrics is None:
        from nnstreamer_tpu_torch.obs import get_registry

        reg = get_registry()
        _xfer_metrics = {
            "h2d": reg.counter(
                "nns_transfer_h2d_bytes_total",
                "Bytes explicitly uploaded host->device (to_device)"),
            "d2h": reg.counter(
                "nns_transfer_d2h_bytes_total",
                "Bytes explicitly materialized device->host (to_host)"),
            "h2d_batched": reg.counter(
                "nns_transfer_batched_h2d_total",
                "Staged multi-frame slab uploads: one copy carrying a "
                "whole drained run (upload_many)"),
            "d2h_batched": reg.counter(
                "nns_transfer_batched_d2h_total",
                "Grouped drain-side fetches: one synchronisation for a "
                "whole materialization run (materialize_many)"),
            "d2h_syncs": reg.counter(
                "nns_transfer_d2h_syncs_total",
                "Host waits for device->host copies"),
        }
    return _xfer_metrics


#: tally key → the registry counter that mirrors it
_MIRRORED = {"h2d_bytes": "h2d", "d2h_bytes": "d2h",
             "h2d_batched_events": "h2d_batched",
             "d2h_batched_events": "d2h_batched", "d2h_syncs": "d2h_syncs"}


def _tally(**counts: float) -> None:
    """Add to the transfer tallies (keys of ``_xfer``) and to the registry
    counters that mirror them."""
    obs = _xfer_obs()
    for key, n in counts.items():
        if n and key in _MIRRORED:
            obs[_MIRRORED[key]].inc(n)
    with _xfer_lock:
        for key, n in counts.items():
            _xfer[key] += n


def transfer_snapshot() -> Dict[str, float]:
    """Copy of the cumulative transfer tallies."""
    with _xfer_lock:
        return dict(_xfer)


def _tl_xfer_span(kind: str, metas, t0: float, nbytes: int = 0) -> None:
    """Record a transfer span (``h2d``/``d2h``) on the active timeline for
    each frame whose meta is in ``metas`` — one attribute read when
    tracing is off."""
    tl = _timeline.ACTIVE
    if tl is None:
        return
    t1 = time.monotonic()
    for meta in metas:
        seq = meta.get(_timeline.TRACE_SEQ_META)
        if seq is not None:
            tl.span(kind, seq, t0, t1, track="transfer", nbytes=nbytes)


def _fault_check(site: str, meta: Dict[str, Any]) -> None:
    """Transfer-site chaos hook (pipeline/faults.py), resolved through
    ``sys.modules`` so the tensors layer never imports the pipeline
    package (element.py imports this module). With injection off this is
    one dict lookup; an injector can only exist once its module is
    imported, so the lazy resolution never misses an active one."""
    faults = sys.modules.get("nnstreamer_tpu_torch.pipeline.faults")
    if faults is None or faults.ACTIVE is None:
        return
    faults.ACTIVE.check(site, seq=meta.get(_timeline.TRACE_SEQ_META))


def note_h2d(arr, device: torch.device) -> None:
    """After a host→device copy from ``arr`` was enqueued on ``device``'s
    current stream: if ``arr`` lies in a page-locked pool slab, record an
    event there that the pool waits for before it hands the slab out
    again (the copy reads the slab after this call returns)."""
    if device.type != "cuda" or pinned_view(arr) is None:
        return
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    note_copy(arr, event)


def tensor_nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    return int(np.asarray(t).nbytes)


def is_device_array(x) -> bool:
    """True if ``x`` is a torch tensor on a non-CPU device."""
    return isinstance(x, torch.Tensor) and x.device.type != "cpu"


def as_torch(x, device: Optional[torch.device] = None,
             non_blocking: bool = False) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``device`` (where it already
    is when None). A read-only numpy array is copied first: torch cannot
    wrap memory it must not write. An array in a page-locked pool slab
    becomes a view of the slab's tensor (``pool.pinned_view``), so a copy
    from it to a card is asynchronous and recorded (:func:`note_h2d`)."""
    arr = None
    if not isinstance(x, torch.Tensor):
        arr = np.asarray(x)
        pinned = pinned_view(arr)
        if pinned is not None:
            x = pinned
        else:
            if not arr.flags.writeable or not arr.flags.c_contiguous:
                arr = np.array(arr, order="C")
            x = torch.from_numpy(arr)
    if device is not None and x.device != device:
        x = x.to(device, non_blocking=non_blocking)
        if arr is not None:
            note_h2d(arr, x.device)
    return x


def copy_host_to(dst: torch.Tensor, src) -> None:
    """``dst.copy_(src, non_blocking=True)`` on the current stream, for a
    host array or any tensor; a copy from the host is tallied, and one
    from a pool slab recorded."""
    dst.copy_(as_torch(src), non_blocking=True)
    if not isinstance(src, torch.Tensor) and dst.device.type != "cpu":
        arr = np.asarray(src)
        note_h2d(arr, dst.device)
        _tally(h2d_bytes=arr.nbytes, h2d_events=1)


def upload_tensor(x, device: torch.device) -> torch.Tensor:
    """``x`` as a tensor on ``device`` that shares no memory with a host
    staging array: on a card the (asynchronous) copy, on the CPU a copy
    too, so releasing the staging slab never touches the payload."""
    t = as_torch(x, device, non_blocking=True)
    if device.type == "cpu" and not isinstance(x, torch.Tensor):
        t = t.clone()
    return t


def host_array(t):
    """A host copy of ``t``: numpy, or a CPU tensor for ``bfloat16``."""
    if isinstance(t, np.ndarray):
        return t
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return t if t.dtype is torch.bfloat16 else t.numpy()
    return np.asarray(t)


def host_float32(t) -> np.ndarray:
    """A float32 numpy array of ``t`` (a ``bfloat16`` tensor included)."""
    t = host_array(t)
    if isinstance(t, torch.Tensor):
        t = t.float().numpy()
    return np.asarray(t, np.float32)


@dataclasses.dataclass
class TensorBuffer:
    """One frame of a tensor stream.

    Attributes
    ----------
    tensors : list of numpy.ndarray or torch.Tensor
    pts, dts, duration : int nanoseconds, or None (unset)
    meta : free-form attachable metadata (GstMeta equivalent)
    finalize : deferred host-side completion ``fn(host_buf) -> TensorBuffer``
        applied by :meth:`to_host` after the tensors are on the host. A
        decoder keeps its math on the device and leaves its host-only part
        (label strings) to the sink's fetch point.
    """

    tensors: List[Any] = dataclasses.field(default_factory=list)
    pts: Optional[int] = None
    dts: Optional[int] = None
    duration: Optional[int] = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    finalize: Optional[Any] = None
    #: host copies already in flight (``prefetch_host``): (tensors, event)
    host_copy: Optional[Any] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if len(self.tensors) > NNS_TENSOR_SIZE_LIMIT:
            raise ValueError(
                f"{len(self.tensors)} tensors exceeds {NNS_TENSOR_SIZE_LIMIT}"
            )

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_arrays(cls, arrays: Sequence, pts: Optional[int] = None, **kw):
        return cls(tensors=list(arrays), pts=pts, **kw)

    @classmethod
    def wall_clock_pts(cls) -> int:
        return time.monotonic_ns()

    # -- container protocol --------------------------------------------------
    def __len__(self):
        return len(self.tensors)

    def __getitem__(self, i):
        return self.tensors[i]

    def __iter__(self):
        return iter(self.tensors)

    # -- derived -------------------------------------------------------------
    @property
    def num_tensors(self) -> int:
        return len(self.tensors)

    def tensors_info(self) -> TensorsInfo:
        return TensorsInfo.from_arrays(self.tensors)

    def nbytes(self) -> int:
        return sum(tensor_nbytes(t) for t in self.tensors)

    def create_stamps(self):
        """Capture timestamps carried in meta for end-to-end latency: the
        plural ``create_ts`` or the singular ``create_t`` a source
        stamped. Returns a (possibly empty) list."""
        stamps = self.meta.get("create_ts")
        if stamps:
            return list(stamps)
        if "create_t" in self.meta:
            return [self.meta["create_t"]]
        return []

    def on_device(self) -> bool:
        return bool(self.tensors) and all(is_device_array(t)
                                          for t in self.tensors)

    # -- placement -----------------------------------------------------------
    def prefetch_host(self) -> "TensorBuffer":
        """Start the device→host copies now, into pinned host memory, on
        the current stream; :meth:`to_host` then waits for them instead of
        issuing a blocking copy. No-op without CUDA tensors."""
        dev = [t for t in self.tensors if is_device_array(t)]
        if self.host_copy is not None or not dev or \
                any(t.device != dev[0].device for t in dev) or \
                dev[0].device.type != "cuda":
            return self
        copies = []
        for t in self.tensors:
            if is_device_array(t):
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                copies.append(h)
            else:
                copies.append(t)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev[0].device))
        return self.replace(host_copy=(copies, event))

    def _host_tensors(self) -> List[Any]:
        dev = [t for t in self.tensors if is_device_array(t)]
        if self.host_copy is not None:
            copies, event = self.host_copy
            event.synchronize()
            src, syncs = copies, 1
        else:
            src, syncs = self.tensors, len(dev)
        if dev:
            _tally(d2h_bytes=sum(tensor_nbytes(t) for t in dev),
                   d2h_events=1, d2h_syncs=syncs)
        return [host_array(t) for t in src]

    def to_host(self) -> "TensorBuffer":
        """Materialize all tensors on the host (blocking D2H if needed),
        then apply the deferred ``finalize`` hook if one is attached. A
        traced fetch's ``d2h`` span starts at the sender's hand-off
        reading and its end is the host buffer's hand-off."""
        t0 = time.monotonic()
        host = self._host_tensors()
        moved = sum(tensor_nbytes(t) for t in self.tensors
                    if is_device_array(t))
        t1 = None
        if moved:
            _fault_check("transfer.d2h", self.meta)
            if _timeline.ACTIVE is not None and \
                    _timeline.TRACE_SEQ_META in self.meta:
                t0 = self.meta.pop(_timeline.HANDOFF_META, None) or t0
                _tl_xfer_span("d2h", (self.meta,), t0, nbytes=moved)
                t1 = time.monotonic()
        buf = TensorBuffer(tensors=host, pts=self.pts,
                           dts=self.dts, duration=self.duration,
                           meta=dict(self.meta))
        if t1 is not None:
            buf.meta[_timeline.HANDOFF_META] = t1
        if self.finalize is not None:
            buf = self.finalize(buf)
        return buf

    def to_device(self, device: torch.device) -> "TensorBuffer":
        """Move all tensors onto ``device`` (:func:`upload_tensor`: host
        arrays are copied, asynchronously from a page-locked slab)."""
        device = torch.device(device)
        t0 = time.monotonic()
        moved = sum(tensor_nbytes(t) for t in self.tensors
                    if not isinstance(t, torch.Tensor))
        out = [upload_tensor(t, device) for t in self.tensors]
        if moved and device.type != "cpu":
            _tally(h2d_bytes=moved, h2d_events=1)
        if moved:
            _fault_check("transfer.h2d", self.meta)
            _tl_xfer_span("h2d", (self.meta,), t0, nbytes=moved)
        return self.replace(tensors=out)

    def pad_rows_device(self) -> "TensorBuffer":
        """Apply a deferred partial-window pad (aggregator ``pad-device``):
        ``meta["pad_rows"]`` zero rows concatenated onto the leading axis
        of each tensor where it lies, so the rows never cross the H2D link
        and the consumer keeps its full-window shape. No-op without the
        meta key."""
        r = self.meta.get("pad_rows")
        if not r:
            return self
        out = [torch.cat([t, t.new_zeros((int(r),) + tuple(t.shape[1:]))])
               for t in self.tensors]
        meta = dict(self.meta)
        del meta["pad_rows"]
        return self.replace(tensors=out, meta=meta)

    # -- functional update ----------------------------------------------------
    def replace(self, **kw) -> "TensorBuffer":
        """Copy with replaced fields; tensors list is shallow-copied, meta is
        copied (buffers are treated as immutable once pushed)."""
        fields = dict(
            tensors=list(self.tensors),
            pts=self.pts,
            dts=self.dts,
            duration=self.duration,
            meta=dict(self.meta),
            finalize=self.finalize,
            host_copy=self.host_copy if "tensors" not in kw else None,
        )
        fields.update(kw)
        return TensorBuffer(**fields)

    def with_tensors(self, tensors: Sequence) -> "TensorBuffer":
        """New buffer with the same timing/meta but different payload."""
        return self.replace(tensors=list(tensors))

    def __repr__(self):
        shapes = ",".join(
            f"{tuple(t.shape)}:{str(t.dtype).split('.')[-1]}"
            for t in self.tensors)
        dev = "dev" if self.on_device() else "host"
        return f"TensorBuffer([{shapes}] {dev} pts={self.pts})"


def _unpin_tokens(tokens) -> None:
    """weakref.finalize target for a dead DeviceBuffer's pinned host-view
    arrays (module-level so the finalizer holds no reference to it)."""
    pool = get_pool()
    for t in tokens:
        pool.unpin(t)


class DeviceBuffer(TensorBuffer):
    """A device-resident frame: tensors that cross pad boundaries without
    touching the host. Elements that declare ``DEVICE_PASSTHROUGH``
    forward it untouched; everything else gets a host copy at pad entry
    (``Element._chain_entry``). The first :meth:`to_host` materializes
    once, applies ``finalize``, and caches the result for every later
    caller. A ``host_view`` — the host arrays the payload was uploaded
    from — makes that first call a zero-copy re-wrap; pool-owned ones are
    pinned so no explicit ``BufferPool.release`` recycles a slab the cache
    still reads (the pin lifts when this buffer dies)."""

    def __init__(self, tensors=None, pts=None, dts=None, duration=None,
                 meta=None, finalize=None, host_copy=None, host_view=None):
        super().__init__(tensors=list(tensors or []), pts=pts, dts=dts,
                         duration=duration, meta=dict(meta or {}),
                         finalize=finalize, host_copy=host_copy)
        self._host_cache: Optional[TensorBuffer] = None
        self._host_src: Optional[List[Any]] = None
        if host_view is not None and len(host_view) == len(self.tensors):
            self._adopt_host_view(list(host_view))

    def _adopt_host_view(self, host: List[Any]) -> None:
        self._host_src = host
        pool = get_pool()
        tokens = tuple(id(a) for a in host if pool.pin(a))
        if tokens:
            weakref.finalize(self, _unpin_tokens, tokens)

    def to_host(self) -> TensorBuffer:
        if self._host_cache is None:
            if self._host_src is not None:
                buf = TensorBuffer(tensors=list(self._host_src),
                                   pts=self.pts, dts=self.dts,
                                   duration=self.duration,
                                   meta=dict(self.meta))
                if self.finalize is not None:
                    buf = self.finalize(buf)
                self._host_cache = buf
            else:
                self._host_cache = super().to_host()
        return self._host_cache

    def replace(self, **kw) -> TensorBuffer:
        """Stays a :class:`DeviceBuffer` while the payload stays on the
        device; an unchanged payload keeps the adopted host view. The host
        cache is never carried over."""
        buf = super().replace(**kw)
        if buf.on_device():
            host_view = self._host_src if "tensors" not in kw else None
            return DeviceBuffer(host_view=host_view,
                                **{f.name: getattr(buf, f.name)
                                   for f in dataclasses.fields(buf)})
        return buf

    def __repr__(self):
        state = ("view" if self._host_src is not None else
                 "cached" if self._host_cache is not None else "lazy")
        return super().__repr__().replace(
            "TensorBuffer(", f"DeviceBuffer(host={state} ", 1)


def as_device_buffer(buf: TensorBuffer, host_view=None) -> TensorBuffer:
    """Wrap an all-device buffer as a :class:`DeviceBuffer` (adopting
    ``host_view``); returns the input unchanged when the payload is not
    fully on a device or it is already wrapped."""
    if isinstance(buf, DeviceBuffer) or not buf.on_device():
        return buf
    return DeviceBuffer(tensors=buf.tensors, pts=buf.pts, dts=buf.dts,
                        duration=buf.duration, meta=buf.meta,
                        finalize=buf.finalize, host_copy=buf.host_copy,
                        host_view=host_view)


# -- staged multi-frame transfers ---------------------------------------------
def upload_many(bufs: List[TensorBuffer], device: torch.device
                ) -> Tuple[List[TensorBuffer], List[np.ndarray]]:
    """One drained run's H2D copies as a single staged slab upload.

    For each tensor index the run's frames are assembled into ONE
    contiguous ``(k,) + shape`` host view — zero-copy when they already
    are consecutive slots of one slab (``pool.contiguous_window_view``),
    else copied into a fresh page-locked pool window slab — and cross to
    ``device`` as ONE ``to(device, non_blocking=True)`` on the current
    stream. Per-frame device tensors are views sliced from it. Returns
    ``(device_buffers, window_slabs)``: the caller stamps the slabs into
    the LAST buffer's pool stash, so the dispatch window
    (``pipeline/dispatch.py``) releases them only after every dispatch
    that read the upload has fenced.

    ``bufs`` are ≥1 host buffers with identical tensor signatures; order
    and per-buffer meta/finalize are preserved, so results equal
    per-buffer ``to_device()``.
    """
    from nnstreamer_tpu_torch.tensors.pool import contiguous_window_view

    k = len(bufs)
    pool = get_pool()
    t0 = time.monotonic()
    _fault_check("transfer.h2d", bufs[0].meta)
    slabs: List[np.ndarray] = []
    devs: List[torch.Tensor] = []
    moved = 0
    for j in range(len(bufs[0].tensors)):
        frames = [np.asarray(b.tensors[j]) for b in bufs]
        stacked = contiguous_window_view(frames) if k > 1 else None
        if stacked is None:
            stacked = pool.acquire_window(k, frames[0].shape,
                                          frames[0].dtype)
            for i, f in enumerate(frames):
                np.copyto(stacked[i], f)
            slabs.append(stacked)
        moved += stacked.nbytes
        devs.append(upload_tensor(stacked, device))
    if device.type != "cpu":
        _tally(h2d_bytes=moved, h2d_batched_events=1,
               h2d_batched_frames=k)
    _tl_xfer_span("h2d", [b.meta for b in bufs], t0, nbytes=moved)
    out: List[TensorBuffer] = []
    for i, b in enumerate(bufs):
        nb = b.with_tensors([d[i] for d in devs])
        nb.meta[H2D_EXCLUSIVE_META] = True
        # the pre-upload host arrays become the zero-copy host view
        out.append(as_device_buffer(nb, host_view=list(b.tensors)))
    return out, slabs


def materialize_many(bufs: List[TensorBuffer],
                     t0: Optional[float] = None) -> List[TensorBuffer]:
    """Drain-side grouped materialization: every CUDA tensor of the run is
    copied into page-locked host memory with ``non_blocking=True`` on the
    current stream, then the host waits ONCE for the run (that stream,
    per device), not once per frame. Results equal per-buffer ``to_host()``:
    finalize hooks run in order on the host payloads, DeviceBuffer host
    caches are honoured and filled.

    With a timeline active each traced frame's time from ``t0`` (the
    caller's reading where the frames' queue residency paused; now if
    None) to its own turn is its ``d2h`` (fetched) or ``queue_wait``
    (nothing to fetch), its finalize starts at that turn, and its
    residency resumes where the finalize ended."""
    fetched: Dict[Tuple[int, int], Any] = {}
    devices = set()
    moved = 0
    if t0 is None:
        t0 = time.monotonic()
    if any(is_device_array(t) for b in bufs for t in b.tensors):
        _fault_check("transfer.d2h", bufs[0].meta)
    for i, b in enumerate(bufs):
        if isinstance(b, DeviceBuffer) and (
                b._host_cache is not None or b._host_src is not None):
            continue  # cached or zero-copy: to_host() is free
        for j, t in enumerate(b.tensors):
            if is_device_array(t) and t.device.type == "cuda":
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                fetched[(i, j)] = h
                moved += tensor_nbytes(t)
                devices.add(t.device)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    if fetched:
        _tally(d2h_bytes=moved, d2h_batched_events=1,
               d2h_batched_frames=len(bufs), d2h_syncs=len(devices))
    tl = _timeline.ACTIVE
    out: List[TensorBuffer] = []
    for i, b in enumerate(bufs):
        was_fetched = any((i, j) in fetched for j in range(len(b.tensors)))
        seq = b.meta.get(_timeline.TRACE_SEQ_META)
        t_turn = None
        if tl is not None and seq is not None:
            # the frame's turn: a fetched frame's d2h runs from the
            # copies' enqueue (the run's synchronisation included), an
            # unfetched one waited behind the run's earlier frames; its
            # finalize starts at this same reading
            t_turn = time.monotonic()
            if was_fetched:
                tl.span("d2h", seq, t0, t_turn, track="transfer",
                        nbytes=moved)
            else:
                tl.span("queue_wait", seq, t0, t_turn, track="transfer")
            b.meta[_timeline.HANDOFF_META] = t_turn
        if not was_fetched:
            hb = b.to_host()  # cached view or host payload
        else:
            host = [host_array(fetched.get((i, j), t))
                    for j, t in enumerate(b.tensors)]
            hb = TensorBuffer(tensors=host, pts=b.pts, dts=b.dts,
                              duration=b.duration, meta=dict(b.meta))
            if b.finalize is not None:
                hb = b.finalize(hb)
            if isinstance(b, DeviceBuffer):
                b._host_cache = hb  # later to_host() callers share this
        if t_turn is not None:
            # back in its queue, behind the run's earlier frames, from
            # where its finalize ended: the queue's hand-off ends this
            # wait (``Queue._tl_depart``)
            b.meta.pop(_timeline.HANDOFF_META, None)
            hb.meta["tl_q_t"] = hb.meta.pop(_timeline.HANDOFF_META,
                                            None) or t_turn
        out.append(hb)
    return out
