"""tensor_mux — N tensor streams → one multi-tensor frame.

Port of ``nnstreamer_tpu/elements/mux.py``. Reference:
``gst/nnstreamer/elements/gsttensormux.c``: collects one buffer per sink
pad (up to ``NNS_TENSOR_SIZE_LIMIT``) under a sync policy
(``elements/collect.py``) and outputs a single ``other/tensors`` frame
whose tensors are the concatenation of all pads' tensors. On the card this
is the batching primitive: mux N sources, then a filter takes the N
tensors as one batched invoke (bench.py's ``pose4``). Tensors are routed
by reference; a CUDA payload stays where it is.
"""

from __future__ import annotations

from typing import Optional

from nnstreamer_tpu_torch.elements.collect import CollectPads
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.pipeline.element import (
    CapsEvent,
    Element,
    EosEvent,
    FlowReturn,
)
from nnstreamer_tpu_torch.registry import ELEMENT, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensors.types import (
    NNS_TENSOR_SIZE_LIMIT,
    TensorsConfig,
    TensorsInfo,
)


@subplugin(ELEMENT, "tensor_mux")
class TensorMux(Element):
    ELEMENT_NAME = "tensor_mux"
    DEVICE_PASSTHROUGH = True  # collects/merges tensor lists by reference
    PROPERTIES = {**Element.PROPERTIES, "sync_mode": "slowest",
                  "sync_option": ""}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_src_pad("src")
        self._collect: Optional[CollectPads] = None
        self._pad_index = {}
        self._pad_caps = {}

    def request_sink_pad(self):
        if len(self.sinkpads) >= NNS_TENSOR_SIZE_LIMIT:
            raise ValueError(f"tensor_mux: max {NNS_TENSOR_SIZE_LIMIT} pads")
        pad = self.add_sink_pad(f"sink_{len(self.sinkpads)}")
        self._pad_index[pad] = len(self.sinkpads) - 1
        return pad

    def _get_collect(self) -> CollectPads:
        if self._collect is None:
            hist = get_registry().histogram(
                "nns_tensor_mux_sync_wait_seconds",
                "Frame-set assembly wait under the pad-sync policy",
                **self._obs_labels())
            self._collect = CollectPads(
                num_pads=len(self.sinkpads),
                policy=self.get_property("sync_mode"),
                option=self.get_property("sync_option"),
                on_ready=self._emit,
                observe_wait=hist.observe,
            )
        return self._collect

    def start(self):
        super().start()
        # a restarted pipeline streams again (Pipeline.start() clears every
        # pad's EOS): collect anew, without the last run's EOS marks and
        # leftovers
        self._collect = None

    def chain(self, pad, buf):
        self._get_collect().push(self._pad_index[pad], buf)
        return FlowReturn.OK

    def _emit(self, frame):
        tensors = []
        pts = None
        create_ts = []
        for _, buf in frame:
            tensors.extend(buf.tensors)
            if buf.pts is not None:
                pts = max(pts, buf.pts) if pts is not None else buf.pts
            # keep every constituent frame's stamp (singular from plain
            # sources, plural from upstream aggregators/muxes)
            create_ts.extend(buf.create_stamps())
        if self.srcpad.caps is None:
            self._announce_caps(frame)
        meta = {"create_ts": create_ts} if create_ts else {}
        self.srcpad.push(TensorBuffer(tensors[:NNS_TENSOR_SIZE_LIMIT],
                                      pts=pts, meta=meta))

    def _announce_caps(self, frame):
        cfgs = []
        for i, _ in frame:
            caps = self._pad_caps.get(i)
            if caps is not None:
                cfgs.append(TensorsConfig.from_caps(caps))
        if cfgs and all(c.info.is_valid() for c in cfgs):
            infos = TensorsInfo(
                [info for c in cfgs for info in c.info.infos]
            )
            self.srcpad.set_caps(
                TensorsConfig(info=infos, rate=cfgs[0].rate).to_caps()
            )
        else:
            self.srcpad.set_caps(
                TensorsConfig.from_arrays(
                    [t for _, b in frame for t in b.tensors]
                ).to_caps()
            )

    def sink_event(self, pad, event):
        if isinstance(event, CapsEvent):
            self._pad_caps[self._pad_index[pad]] = event.caps
            return  # output caps derived at first frame-set
        if isinstance(event, EosEvent):
            if self._collect is not None:
                all_eos = self._collect.set_eos(self._pad_index[pad])
                if all_eos:
                    for frame in self._collect.flush_remaining():
                        self._emit(frame)
                    self.srcpad.push_event(event)
            elif all(p.eos for p in self.sinkpads):
                self.srcpad.push_event(event)
            return
        super().sink_event(pad, event)
