"""tee — 1-to-N stream fan-out (gst core ``tee``).

Port of ``nnstreamer_tpu/elements/tee.py``. Used throughout the
reference's composite-model pipelines (one camera, N models) and by the
repo loop (``tensor_reposrc ! filter ! tee ! tensor_reposink``). Buffers
are pushed to every src pad; payload tensors are shared (buffers are
immutable by convention), so fan-out of CUDA tensors copies nothing.
"""

from __future__ import annotations

from nnstreamer_tpu_torch.pipeline.dispatch import POOL_STASH_META
from nnstreamer_tpu_torch.pipeline.element import Element, FlowReturn
from nnstreamer_tpu_torch.registry import ELEMENT, subplugin
from nnstreamer_tpu_torch.tensors.buffer import H2D_EXCLUSIVE_META


@subplugin(ELEMENT, "tee")
class Tee(Element):
    ELEMENT_NAME = "tee"
    DEVICE_PASSTHROUGH = True  # pure fan-out: never reads tensor bytes

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")

    def request_src_pad(self):
        return self.add_src_pad(f"src_{len(self.srcpads)}")

    def link(self, downstream):
        # allocate a new src pad per link
        src = self.request_src_pad()
        sink = next((p for p in downstream.sinkpads if p.peer is None), None)
        if sink is None:
            sink = downstream.request_sink_pad()
        src.link(sink)
        # replay caps already seen
        if self.sinkpads[0].caps is not None:
            src.set_caps(self.sinkpads[0].caps)
        return downstream

    def chain(self, pad, buf):
        if POOL_STASH_META in buf.meta or H2D_EXCLUSIVE_META in buf.meta:
            # fan-out would duplicate the staging-buffer release claim:
            # one branch's explicit release could recycle memory another
            # branch's in-flight device work still reads. Drop the claim
            # — the pool's GC fallback recycles once every branch is done.
            # The exclusivity marker goes with it: a fanned-out payload
            # has N readers, so no branch may clear it on a drop.
            buf = buf.replace()
            buf.meta.pop(POOL_STASH_META, None)
            buf.meta.pop(H2D_EXCLUSIVE_META, None)
        ret = FlowReturn.OK
        for sp in self.srcpads:
            r = sp.push(buf)
            if r is FlowReturn.EOS:
                ret = r
        return ret
