"""Latency-budget adaptive batching on the port — bound a live stream's
per-frame latency while keeping the batched dispatch.

A micro-batched pipeline (aggregator frames-out=8) makes a 30 fps frame
wait up to 267 ms for its batch window. ``latency-budget-ms=50`` flushes
a partial window once its oldest frame has waited 50 ms, padded ON THE
DEVICE to the batch shape (``pad-device=true``, so only real frames cross
the host→device link) and trimmed back at the sink.

Runs on cuda:0; NNSTPU_TORCH_DEVICE=cpu runs it on the CPU.
Run: python examples/torch/low_latency.py
"""

import torch

import nnstreamer_tpu_torch as nt
from nnstreamer_tpu_torch.filters.torch_backend import register_torch_model


class Classify(torch.nn.Module):
    """[8, 64, 64, 3] → [8, 10] pseudo-logits."""

    def forward(self, x):
        xf = (x.to(torch.float32) - 127.5) / 127.5
        return torch.stack([xf.sum(dim=(1, 2, 3))] * 10, dim=1)


register_torch_model("demo_classify8", Classify())

pipe = nt.parse_launch(
    "videotestsrc num-buffers=90 is-live=true framerate=30/1 "
    "width=64 height=64 pattern=gradient ! tensor_converter ! "
    "tensor_aggregator frames-in=1 frames-out=8 frames-flush=8 "
    "frames-dim=3 concat=true latency-budget-ms=50 pad-device=true ! "
    "queue max-size-buffers=4 prefetch-device=true ! "
    "tensor_filter framework=jax model=demo_classify8 ! "
    "queue max-size-buffers=4 materialize-host=true ! "
    "tensor_sink name=out to-host=true")
msg = pipe.run(timeout=60)
assert msg is not None and msg.kind == "eos", msg

sink = pipe.get("out")
frames = sum(
    b.meta.get("valid_frames", b.tensors[0].shape[0]) for b in sink.buffers)
lat = sink.latency_percentiles(50, 99, skip=16)
print(f"{len(sink.buffers)} dispatches carried {frames} frames")
if lat:
    print(f"end-to-end latency p50={lat[0]:.1f} ms p99={lat[1]:.1f} ms "
          f"(full batch window would be ~267 ms at 30 fps)")
