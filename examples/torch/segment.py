"""Semantic segmentation on the port — per-pixel argmax on the card.

The fused region runs normalize → encoder-decoder FCN → argmax as one
CUDA graph; an [H, W] int32 class map crosses to the host, where the
image_segment decoder colours it RGBA.

Runs on cuda:0; NNSTPU_TORCH_DEVICE=cpu runs it on the CPU.
Run: python examples/torch/segment.py
"""

import numpy as np
import torch

import nnstreamer_tpu_torch as nt
from nnstreamer_tpu_torch.filters.torch_backend import register_torch_model
from nnstreamer_tpu_torch.models.segmenter import segmenter

SIZE = 256
seg, _, _ = segmenter(num_classes=21, image_size=SIZE)


class Net(torch.nn.Module):
    """uint8 frames normalised in the model, as the JAX example's ``net``."""

    def __init__(self, seg):
        super().__init__()
        self.seg = seg

    def forward(self, x):
        return self.seg((x.to(torch.float32) - 127.5) / 127.5)


register_torch_model("seg", Net(seg))

pipe = nt.parse_launch(
    f"videotestsrc num-buffers=30 width={SIZE} height={SIZE} "
    "pattern=smpte ! tensor_converter ! queue max-size-buffers=8 ! "
    "tensor_filter framework=jax model=seg name=net ! "
    "tensor_decoder mode=image_segment ! "
    "queue max-size-buffers=32 prefetch-host=true ! "
    "tensor_sink name=out to-host=true")
pipe.get("out").connect(
    lambda buf: print(
        f"frame pts={buf.pts}: classes present="
        f"{sorted(np.unique(buf.meta['segment_labels']).tolist())}"))
msg = pipe.run(timeout=300)
assert msg is not None and msg.kind == "eos", msg
print(f"done: {msg.kind}; invoke latency "
      f"{pipe.get('net').get_property('latency')} us")
