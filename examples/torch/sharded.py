"""Sharded invoke on the port — ``mesh=dp-1`` shards the filter's batch
dimension over every visible device (each card runs its rows on its own
copy of the weights).

On the CPU the mesh spans ``set_host_device_count(n)`` logical devices.

Runs on cuda:0 (and every other card); NNSTPU_TORCH_DEVICE=cpu runs it on
the CPU.
Run: python examples/torch/sharded.py
"""

import numpy as np
import torch

import nnstreamer_tpu_torch as nt
from nnstreamer_tpu_torch.device import mesh_devices
from nnstreamer_tpu_torch.filters.torch_backend import register_torch_model

n_dev = len(mesh_devices())
print(f"devices: {n_dev} x {mesh_devices()[0].type}")


class Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("w", torch.full((3, 8), 0.5))

    def forward(self, x):
        return x.to(torch.float32) @ self.w


register_torch_model("lin", Linear())

# the sharded batch dim splits over the devices — push device-count-sized
# batches of frames [n_dev, H, W, 3]
pipe = nt.parse_launch(
    "appsrc name=src ! tensor_transform mode=typecast option=float32 ! "
    "tensor_filter framework=jax model=lin mesh=dp-1 ! "
    "tensor_sink name=out to-host=true")
pipe.get("out").connect(lambda buf: print("out", buf))
src = pipe.get("src")
pipe.start()
for i in range(5):
    src.push([np.full((n_dev, 8, 4, 3), i, np.uint8)])
src.end_of_stream()
msg = pipe.wait(timeout=120)
pipe.stop()
assert msg is not None and msg.kind == "eos", msg
print("run:", msg.kind)
