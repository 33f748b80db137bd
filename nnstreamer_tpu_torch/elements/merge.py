"""tensor_merge — N single tensors → ONE tensor along a dimension.

Port of ``nnstreamer_tpu/elements/merge.py``. Reference:
``gst/nnstreamer/elements/gsttensormerge.c``, mode ``linear`` with option
= the dim index to concatenate along (innermost-first dim order), under
the shared sync policies (``elements/collect.py``). Host arrays
concatenate with numpy; as soon as one input is a torch tensor, every
input joins it on that tensor's device and ``torch.cat`` concatenates
there, so a CUDA payload stays on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nnstreamer_tpu_torch.elements.collect import CollectPads
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.pipeline.element import (
    CapsEvent,
    Element,
    EosEvent,
    FlowReturn,
)
from nnstreamer_tpu_torch.registry import ELEMENT, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer, as_torch
from nnstreamer_tpu_torch.tensors.types import TensorsConfig


def merge_tensors(arrays, dim_idx: int):
    """``arrays`` concatenated along nnstreamer dim ``dim_idx`` (counted
    innermost first)."""
    axis = arrays[0].ndim - 1 - dim_idx  # dim order → row-major axis
    tensors = [a for a in arrays if isinstance(a, torch.Tensor)]
    if tensors:
        device = tensors[0].device
        return torch.cat([as_torch(a, device) for a in arrays], dim=axis)
    return np.concatenate(arrays, axis=axis)


@subplugin(ELEMENT, "tensor_merge")
class TensorMerge(Element):
    ELEMENT_NAME = "tensor_merge"
    PROPERTIES = {**Element.PROPERTIES, "mode": "linear", "option": "0",
                  "sync_mode": "slowest", "sync_option": ""}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_src_pad("src")
        self._collect: Optional[CollectPads] = None
        self._pad_index = {}

    def request_sink_pad(self):
        pad = self.add_sink_pad(f"sink_{len(self.sinkpads)}")
        self._pad_index[pad] = len(self.sinkpads) - 1
        return pad

    def _get_collect(self):
        if self._collect is None:
            hist = get_registry().histogram(
                "nns_tensor_merge_sync_wait_seconds",
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
        merged = merge_tensors([buf.tensors[0] for _, buf in frame],
                               int(self.get_property("option")))
        pts = max((b.pts or 0) for _, b in frame)
        if self.srcpad.caps is None:
            self.srcpad.set_caps(TensorsConfig.from_arrays([merged]).to_caps())
        self.srcpad.push(TensorBuffer([merged], pts=pts))

    def sink_event(self, pad, event):
        if isinstance(event, CapsEvent):
            return  # output caps derived from first merged frame
        if isinstance(event, EosEvent):
            if self._collect is not None and \
                    self._collect.set_eos(self._pad_index[pad]):
                self.srcpad.push_event(event)
            elif self._collect is None and all(p.eos for p in self.sinkpads):
                self.srcpad.push_event(event)
            return
        super().sink_event(pad, event)
