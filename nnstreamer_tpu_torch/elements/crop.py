"""tensor_crop — crop raw-tensor regions using a second "info" pad.

Port of ``nnstreamer_tpu/elements/crop.py``. Reference: ``gst/nnstreamer/tensor_crop/tensor_crop.c`` (820 LoC): the
``raw`` sink pad carries data tensors, the ``info`` pad carries crop
coordinates (x, y, w, h per region, e.g. from a detection model); output
is a flexible-format stream of cropped regions (shapes vary per frame).

Parity points:

- **every data tensor is cropped** per region (multi-tensor raw frames;
  output is region-major: all tensors of region 0, then region 1, ...).
- ``lateness`` (ms, default -1 = disabled, tensor_crop.c:734-759): when
  raw and info timestamps differ by more than this, the older buffer is
  dropped and the newer kept for the next pairing.

The pairing (``CollectPads``, policy ``slowest``) and the crops run on
the host, as in the JAX package: the element is not
``DEVICE_PASSTHROUGH``, so a device payload on either pad arrives fetched
(one counted D2H, ``TensorBuffer.to_host``). Each crop is a contiguous
numpy copy of its region.
"""

from __future__ import annotations

import numpy as np

from nnstreamer_tpu_torch.elements.collect import CollectPads
from nnstreamer_tpu_torch.pipeline.element import CapsEvent, Element, EosEvent, FlowReturn
from nnstreamer_tpu_torch.registry import ELEMENT, subplugin
from nnstreamer_tpu_torch.tensors.buffer import is_device_array
from nnstreamer_tpu_torch.tensors.data import host_numpy
from nnstreamer_tpu_torch.tensors.types import TensorFormat, TensorsConfig


@subplugin(ELEMENT, "tensor_crop")
class TensorCrop(Element):
    ELEMENT_NAME = "tensor_crop"
    PROPERTIES = {**Element.PROPERTIES, "lateness": -1}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.raw_pad = self.add_sink_pad("raw")
        self.info_pad = self.add_sink_pad("info")
        self.add_src_pad("src")
        self._collect = CollectPads(num_pads=2, policy="slowest",
                                    on_ready=self._emit)

    def chain(self, pad, buf):
        if any(is_device_array(t) for t in buf.tensors):
            # a device payload no resident wrapper carried (a resident one
            # was fetched at pad entry): the same one counted fetch
            buf = buf.to_host()
        self._collect.push(0 if pad is self.raw_pad else 1, buf)
        return FlowReturn.OK

    def _late(self, raw, info) -> bool:
        """Reject the pairing when timestamps diverge beyond ``lateness``
        (tensor_crop.c:734-759: drop the older, keep the newer)."""
        lateness_ms = int(self.get_property("lateness"))
        if lateness_ms < 0 or raw.pts is None or info.pts is None:
            return False
        if abs(raw.pts - info.pts) <= lateness_ms * 1_000_000:
            return False
        if raw.pts > info.pts:
            self._collect.requeue_front(0, raw)   # info was old: drop it
        else:
            self._collect.requeue_front(1, info)  # raw was old: drop it
        self.log.debug("lateness: dropped old buffer (raw pts %s, info "
                       "pts %s)", raw.pts, info.pts)
        # the kept buffer may already have a partner queued — pair it now
        # rather than waiting for (possibly never-coming) next arrival
        self._collect.recheck()
        return True

    def _emit(self, frame):
        by_pad = dict(frame)
        raw, info = by_pad.get(0), by_pad.get(1)
        if raw is None or info is None:
            return
        if self._late(raw, info):
            return
        datas = []
        for t in raw.tensors:
            data = host_numpy(t)
            if data.ndim == 4 and data.shape[0] == 1:
                data = data[0]  # (H, W, C)
            datas.append(data)
        regions = host_numpy(info.tensors[0]).reshape(-1, 4).astype(int)
        crops = []
        # region-major: all data tensors cropped at region 0, then 1, ...
        for x, y, w, h in regions:
            x0, y0 = max(0, x), max(0, y)
            for data in datas:
                crop = data[y0:y0 + h, x0:x0 + w]
                crops.append(np.ascontiguousarray(crop))
        if self.srcpad.caps is None:
            cfg = TensorsConfig(format=TensorFormat.FLEXIBLE)
            self.srcpad.set_caps(cfg.to_caps())
        self.srcpad.push(raw.with_tensors(crops).replace(
            meta={**raw.meta, "crop_regions": regions.tolist(),
                  "crop_num_tensors": len(datas)}
        ))

    def sink_event(self, pad, event):
        if isinstance(event, CapsEvent):
            return
        if isinstance(event, EosEvent):
            all_eos = self._collect.set_eos(0 if pad is self.raw_pad else 1)
            if all_eos:
                self._collect.recheck()  # emit any ready leftover pairing
                self.srcpad.push_event(event)
            return
        super().sink_event(pad, event)
