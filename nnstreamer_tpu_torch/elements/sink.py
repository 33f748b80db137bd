"""tensor_sink — the application callback sink.

Reference: ``tensor_sink`` (gst/nnstreamer/elements/gsttensorsink.c)
emits a ``new-data`` signal per buffer to the app. Here :meth:`connect`
registers callbacks, buffers are also stored (bounded by ``max-stored``)
for pull-style access, and :meth:`TensorSink.wait` blocks until N buffers
or EOS. With ``to-host=true`` (the default) the sink is the frame's fetch
point: device tensors come to the host here, and a decoder's deferred
finalize runs here. The end-to-end latency of each frame (source
``create()`` → host payload at the sink) is recorded.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List

import numpy as np

from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.pipeline.element import Element, EosEvent, FlowReturn
from nnstreamer_tpu_torch.registry import ELEMENT, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer


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
        # a pending finalize is ALWAYS applied — even with to-host=false —
        # so the app sees the decoder's output (the fetch then covers only
        # the device half's small results, never full frames)
        if self.get_property("to_host") or buf.finalize is not None:
            buf = buf.to_host()
        # only a host payload counts as delivered: recording a device
        # handle's arrival would measure the enqueue, not the completion
        if not buf.on_device():
            now = time.monotonic()
            hist = self._obs_e2e()
            for t in buf.create_stamps():
                self.latencies.append(now - t)
                hist.observe(now - t)
        with self._cv:
            if len(self.buffers) < int(self.get_property("max_stored")):
                self.buffers.append(buf)
            self._cv.notify_all()
        for cb in self._callbacks:
            cb(buf)
        return FlowReturn.OK

    def latency_percentiles(self, *qs: float, skip: int = 0):
        """End-to-end frame latency percentiles in ms (default p50, p99);
        ``skip`` drops the first N frames (warm-up exclusion)."""
        vals = list(self.latencies)[skip:]
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
