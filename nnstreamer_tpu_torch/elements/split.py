"""tensor_split — one tensor → N tensors by size spec along a dimension.

Port of ``nnstreamer_tpu/elements/split.py``. Reference: ``gst/nnstreamer/elements/gsttensorsplit.c`` (706 LoC):
``tensorseg`` gives per-output sizes along ``dimension`` (innermost-first
index), e.g. ``tensorseg=1:100,1:100,1:56 dimension=1``.

The parts are views of the input (numpy or torch), so a device payload
stays on the card and nothing is copied here. A part cut along an inner
dimension is not contiguous: the consumers on the card take such views
(the transform's kernel B1 wrapper makes its input contiguous, a fused
region copies into its static inputs, a module takes strided inputs, a
host fetch copies).
"""

from __future__ import annotations

import itertools
from typing import List, Optional

from nnstreamer_tpu_torch.pipeline.element import CapsEvent, Element, FlowReturn
from nnstreamer_tpu_torch.registry import ELEMENT, subplugin
from nnstreamer_tpu_torch.tensors.types import TensorsConfig


@subplugin(ELEMENT, "tensor_split")
class TensorSplit(Element):
    ELEMENT_NAME = "tensor_split"
    DEVICE_PASSTHROUGH = True  # parts are views, on the device too
    PROPERTIES = {**Element.PROPERTIES, "tensorseg": None, "dimension": 0}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self._sizes: Optional[List[int]] = None

    def _get_sizes(self) -> List[int]:
        if self._sizes is None:
            spec = self.get_property("tensorseg")
            if spec is None:
                raise ValueError("tensor_split: tensorseg not set")
            # accept "100,100,56" or reference-style "1:100,1:100" (use the
            # split-dim component)
            dim_idx = int(self.get_property("dimension"))
            sizes = []
            for seg in str(spec).split(","):
                parts = [int(p) for p in seg.split(":")]
                sizes.append(parts[dim_idx] if len(parts) > dim_idx
                             else parts[-1] if len(parts) > 1 else parts[0])
            self._sizes = sizes
        return self._sizes

    def _ensure_pads(self, n: int):
        while len(self.srcpads) < n:
            self.add_src_pad(f"src_{len(self.srcpads)}")

    def request_src_pad(self):
        return self.add_src_pad(f"src_{len(self.srcpads)}")

    def link(self, downstream):
        # src pads are request-style: allocate one per link if all are taken
        if all(p.peer is not None for p in self.srcpads):
            self.request_src_pad()
        return super().link(downstream)

    def chain(self, pad, buf):
        sizes = self._get_sizes()
        self._ensure_pads(len(sizes))
        arr = buf.tensors[0]
        dim_idx = int(self.get_property("dimension"))
        axis = arr.ndim - 1 - dim_idx
        # plain ints: offsets come from the element's own sizes property,
        # never from a device array, and slice() takes them directly
        offsets = list(itertools.accumulate([0] + sizes))
        if offsets[-1] != arr.shape[axis]:
            raise ValueError(
                f"tensor_split: tensorseg sums to {offsets[-1]} but dim "
                f"{dim_idx} is {arr.shape[axis]}"
            )
        ret = FlowReturn.OK
        for i, sp in enumerate(self.srcpads[:len(sizes)]):
            sl = [slice(None)] * arr.ndim
            sl[axis] = slice(offsets[i], offsets[i + 1])
            part = arr[tuple(sl)]
            if sp.caps is None:
                sp.set_caps(TensorsConfig.from_arrays([part]).to_caps())
            r = sp.push(buf.with_tensors([part]))
            if r is FlowReturn.EOS:
                ret = r
        return ret

    def sink_event(self, pad, event):
        if isinstance(event, CapsEvent):
            return
        super().sink_event(pad, event)
