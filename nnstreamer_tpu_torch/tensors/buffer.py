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
once and cached (the JAX package's residency wrapper, without its staging
pool and tallies, which wait for a later slice).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from nnstreamer_tpu_torch.tensors.types import (
    NNS_TENSOR_SIZE_LIMIT,
    TensorsInfo,
)

#: Sentinel for "no timestamp" (reference GST_CLOCK_TIME_NONE).
CLOCK_NONE: Optional[int] = None

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
        }
    return _xfer_metrics


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
    wrap memory it must not write."""
    if not isinstance(x, torch.Tensor):
        arr = np.asarray(x)
        if not arr.flags.writeable or not arr.flags.c_contiguous:
            arr = np.array(arr, order="C")
        x = torch.from_numpy(arr)
    if device is not None and x.device != device:
        x = x.to(device, non_blocking=non_blocking)
    return x


def host_array(t):
    """A host copy of ``t``: numpy, or a CPU tensor for ``bfloat16``."""
    if isinstance(t, np.ndarray):
        return t
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return t if t.dtype is torch.bfloat16 else t.numpy()
    return np.asarray(t)


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
        if self.host_copy is not None:
            copies, event = self.host_copy
            event.synchronize()
            src = copies
        else:
            src = self.tensors
        moved = sum(tensor_nbytes(t) for t in self.tensors
                    if is_device_array(t))
        if moved:
            _xfer_obs()["d2h"].inc(moved)
        return [host_array(t) for t in src]

    def to_host(self) -> "TensorBuffer":
        """Materialize all tensors on the host (blocking D2H if needed),
        then apply the deferred ``finalize`` hook if one is attached."""
        buf = TensorBuffer(tensors=self._host_tensors(), pts=self.pts,
                           dts=self.dts, duration=self.duration,
                           meta=dict(self.meta))
        if self.finalize is not None:
            buf = self.finalize(buf)
        return buf

    def to_device(self, device: torch.device,
                  non_blocking: bool = True) -> "TensorBuffer":
        """Move all tensors onto ``device``."""
        moved = sum(tensor_nbytes(t) for t in self.tensors
                    if not is_device_array(t))
        out = [as_torch(t, device, non_blocking) for t in self.tensors]
        if moved and torch.device(device).type != "cpu":
            _xfer_obs()["h2d"].inc(moved)
        return self.replace(tensors=out)

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


class DeviceBuffer(TensorBuffer):
    """A device-resident frame: tensors that cross pad boundaries without
    touching the host. Elements that declare ``DEVICE_PASSTHROUGH``
    forward it untouched; everything else gets a host copy at pad entry
    (``Element._chain_entry``). The first :meth:`to_host` materializes
    once, applies ``finalize``, and caches the result for every later
    caller."""

    def __init__(self, tensors=None, pts=None, dts=None, duration=None,
                 meta=None, finalize=None, host_copy=None):
        super().__init__(tensors=list(tensors or []), pts=pts, dts=dts,
                         duration=duration, meta=dict(meta or {}),
                         finalize=finalize, host_copy=host_copy)
        self._host_cache: Optional[TensorBuffer] = None

    def to_host(self) -> TensorBuffer:
        if self._host_cache is None:
            self._host_cache = super().to_host()
        return self._host_cache

    def replace(self, **kw) -> TensorBuffer:
        """Stays a :class:`DeviceBuffer` while the payload stays on the
        device; the host cache is never carried over."""
        buf = super().replace(**kw)
        if buf.on_device():
            return DeviceBuffer(**{f.name: getattr(buf, f.name)
                                   for f in dataclasses.fields(buf)})
        return buf

    def __repr__(self):
        state = "cached" if self._host_cache is not None else "lazy"
        return super().__repr__().replace(
            "TensorBuffer(", f"DeviceBuffer(host={state} ", 1)


def as_device_buffer(buf: TensorBuffer) -> TensorBuffer:
    """Wrap an all-device buffer as a :class:`DeviceBuffer`; returns the
    input unchanged when the payload is not fully on a device or it is
    already wrapped."""
    if isinstance(buf, DeviceBuffer) or not buf.on_device():
        return buf
    return DeviceBuffer(tensors=buf.tensors, pts=buf.pts, dts=buf.dts,
                        duration=buf.duration, meta=buf.meta,
                        finalize=buf.finalize, host_copy=buf.host_copy)
