"""Reference-wire offload on the port — speak the NNStreamer
tensor_query protocol byte for byte (``wire=nnstreamer``).

The server below is reachable by an unmodified reference
tensor_query_client (i32 commands, the 176-byte TensorQueryDataInfo
struct, two ports, caps-string handshake), and the client element speaks
the same wire to reference servers. The wire carries no per-tensor meta,
so the serversrc's ``caps=`` declares how raw memories become typed
tensors.

Runs on cuda:0; NNSTPU_TORCH_DEVICE=cpu runs it on the CPU.
Run: python examples/torch/refwire_offload.py
"""

import torch

import nnstreamer_tpu_torch as nt
from nnstreamer_tpu_torch.filters.torch_backend import register_torch_model

CAPS = ("other/tensors,format=static,num_tensors=1,"
        "dimensions=3:64:64:1,types=uint8")


class Invert(torch.nn.Module):
    def forward(self, x):
        return 255 - x


register_torch_model("invert_u8", Invert())

server = nt.parse_launch(
    f"tensor_query_serversrc name=ssrc port=0 wire=nnstreamer caps={CAPS} ! "
    "tensor_filter framework=jax model=invert_u8 ! "
    "queue max-size-buffers=8 materialize-host=true ! "
    "tensor_query_serversink")
server.start()
ssrc = server.get("ssrc")  # start() is synchronous: server is bound
print(f"reference-wire server: src port {ssrc.port}, "
      f"sink (results) port {ssrc.result_port}")

client = nt.parse_launch(
    "videotestsrc num-buffers=20 width=64 height=64 ! tensor_converter ! "
    f"tensor_query_client dest-host=127.0.0.1 dest-port={ssrc.port} "
    f"sink-port={ssrc.result_port} wire=nnstreamer ! "
    "tensor_sink name=out to-host=true")
msg = client.run(timeout=60)
assert msg is not None and msg.kind == "eos", msg
out = client.get("out").buffers
print(f"{len(out)} inverted frames returned over the reference wire; "
      f"first frame dtype={out[0].tensors[0].dtype} "
      f"shape={tuple(out[0].tensors[0].shape)}")
server.stop()
