"""SSD-MobileNet detection on the port — anchor decode and per-class NMS
in the fused region on the card; only [100, 6] box rows leave it per
frame.

Runs on cuda:0; NNSTPU_TORCH_DEVICE=cpu runs it on the CPU.
Run: python examples/torch/detect.py
"""

import nnstreamer_tpu_torch as nt
from nnstreamer_tpu_torch.filters.torch_backend import register_torch_model
from nnstreamer_tpu_torch.models.ssd_mobilenet import ssd_mobilenet

register_torch_model("ssd", *ssd_mobilenet(image_size=300))

pipe = nt.parse_launch(
    "videotestsrc num-buffers=10 width=300 height=300 pattern=gradient ! "
    "tensor_converter ! queue max-size-buffers=8 ! "
    "tensor_transform mode=arithmetic "
    "option=typecast:float32,add:-127.5,div:127.5 ! "
    "tensor_filter framework=jax model=ssd ! "
    "tensor_decoder mode=bounding_boxes option1=mobilenet-ssd "
    "option4=300:300 option7=meta ! "
    "queue max-size-buffers=16 prefetch-host=true ! "
    "tensor_sink name=out to-host=true")
pipe.get("out").connect(
    lambda buf: print(f"{len(buf.meta['detections'])} detections:",
                      [(d['class'], round(d['score'], 2))
                       for d in buf.meta['detections'][:5]]))
msg = pipe.run(timeout=300)
assert msg is not None and msg.kind == "eos", msg
print("run:", msg.kind)
