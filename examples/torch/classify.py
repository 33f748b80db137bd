"""MobileNetV2 classification — the flagship fused pipeline, on the
PyTorch/CUDA port.

uint8 frame → normalize (kernel B1) → MobileNetV2 → argmax runs as one
fused region (one CUDA graph on the card); only the label index and score
cross back per frame.

Runs on cuda:0; NNSTPU_TORCH_DEVICE=cpu runs it on the CPU.
Run: python examples/torch/classify.py
"""

import nnstreamer_tpu_torch as nt
from nnstreamer_tpu_torch.filters.torch_backend import register_torch_model
from nnstreamer_tpu_torch.models.mobilenet_v2 import mobilenet_v2

register_torch_model("mnv2", *mobilenet_v2(image_size=224))

pipe = nt.parse_launch(
    "videotestsrc num-buffers=30 width=224 height=224 pattern=gradient ! "
    "tensor_converter ! queue max-size-buffers=8 ! "
    "tensor_transform mode=arithmetic "
    "option=typecast:float32,add:-127.5,div:127.5 ! "
    "tensor_filter framework=jax model=mnv2 name=net ! "
    "tensor_decoder mode=image_labeling ! "
    "queue max-size-buffers=32 prefetch-host=true ! "
    "tensor_sink name=out to-host=true")
pipe.get("out").connect(
    lambda buf: print(f"label={buf.meta['label']} "
                      f"score={buf.meta['score']:.3f}"))
msg = pipe.run(timeout=300)
assert msg is not None and msg.kind == "eos", msg
print(f"done: {msg.kind}; invoke latency "
      f"{pipe.get('net').get_property('latency')} us")
