"""tensor_demux — one multi-tensor frame → N streams.

Port of ``nnstreamer_tpu/elements/demux.py``. Reference: ``gst/nnstreamer/elements/gsttensordemux.c`` (658 LoC).
``tensorpick`` selects which tensors go to which src pad
(e.g. ``tensorpick=0,1:2`` → pad0 gets tensor 0, pad1 gets tensors 1+2).
Tensors are routed by reference: a device payload stays on the card, and a
resident buffer stays resident on every branch.
"""

from __future__ import annotations

from typing import List, Optional

from nnstreamer_tpu_torch.pipeline.element import CapsEvent, Element, FlowReturn
from nnstreamer_tpu_torch.registry import ELEMENT, subplugin
from nnstreamer_tpu_torch.tensors.types import TensorsConfig, TensorsInfo


@subplugin(ELEMENT, "tensor_demux")
class TensorDemux(Element):
    ELEMENT_NAME = "tensor_demux"
    DEVICE_PASSTHROUGH = True  # routes tensor subsets by reference
    PROPERTIES = {**Element.PROPERTIES, "tensorpick": None}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self._pick: Optional[List[List[int]]] = None
        self._in_cfg = None

    def _get_pick(self, num_tensors: int) -> List[List[int]]:
        if self._pick is None:
            spec = self.get_property("tensorpick")
            if spec:
                self._pick = [
                    [int(i) for i in group.split(":")]
                    for group in str(spec).split(",")
                ]
            else:
                self._pick = [[i] for i in range(num_tensors)]
        return self._pick

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
        pick = self._get_pick(buf.num_tensors)
        self._ensure_pads(len(pick))
        ret = FlowReturn.OK
        for pad_i, idxs in enumerate(pick):
            sp = self.srcpads[pad_i]
            if sp.caps is None and self._in_cfg is not None and \
                    self._in_cfg.info.is_valid():
                infos = TensorsInfo([self._in_cfg.info[i] for i in idxs])
                sp.set_caps(TensorsConfig(info=infos,
                                          rate=self._in_cfg.rate).to_caps())
            out = buf.with_tensors([buf.tensors[i] for i in idxs])
            r = sp.push(out)
            if r is FlowReturn.EOS:
                ret = r
        return ret

    def sink_event(self, pad, event):
        if isinstance(event, CapsEvent):
            self._in_cfg = TensorsConfig.from_caps(event.caps)
            if self._in_cfg.info.is_valid():
                pick = self._get_pick(len(self._in_cfg.info))
                self._ensure_pads(len(pick))
            return
        super().sink_event(pad, event)
