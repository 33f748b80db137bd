"""join — forward whichever input arrives first (many-to-one switch).

Port of ``nnstreamer_tpu/elements/join.py``. Reference: ``gst/join/gstjoin.c`` (829 LoC): unlike mux, join performs no
synchronization — buffers from all sink pads are forwarded in arrival
order on one src pad (used to reunite exclusive branches, e.g. after
tensor_if PASSTHROUGH/SKIP paths). Payloads pass by reference, a device
one included.
"""

from __future__ import annotations

import threading

from nnstreamer_tpu_torch.pipeline.element import CapsEvent, Element, EosEvent
from nnstreamer_tpu_torch.registry import ELEMENT, subplugin


@subplugin(ELEMENT, "join")
class Join(Element):
    ELEMENT_NAME = "join"
    DEVICE_PASSTHROUGH = True  # first-arrival selection, payload untouched

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_src_pad("src")
        self._push_lock = threading.Lock()

    def request_sink_pad(self):
        return self.add_sink_pad(f"sink_{len(self.sinkpads)}")

    def chain(self, pad, buf):
        with self._push_lock:  # serialize concurrent branches
            if self.srcpad.caps is None and pad.caps is not None:
                self.srcpad.set_caps(pad.caps)
            return self.srcpad.push(buf)

    def sink_event(self, pad, event):
        if isinstance(event, CapsEvent):
            with self._push_lock:
                if self.srcpad.caps is None:
                    self.srcpad.set_caps(event.caps)
            return
        if isinstance(event, EosEvent):
            if all(p.eos for p in self.sinkpads):
                self.srcpad.push_event(event)
            return
        super().sink_event(pad, event)
