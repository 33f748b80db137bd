"""Distributed offload on the port — a client pipeline sends frames over
the framed TCP query protocol to a server pipeline; max-in-flight
pipelines the round trips.

Runs on cuda:0; NNSTPU_TORCH_DEVICE=cpu runs it on the CPU.
Run: python examples/torch/offload.py
"""

import nnstreamer_tpu_torch as nt
from nnstreamer_tpu_torch.filters import register_custom_easy
from nnstreamer_tpu_torch.tensors.types import TensorsInfo

info = TensorsInfo.from_str("3:64:64:1", "uint8")
register_custom_easy("invert", lambda ins: [255 - ins[0]], info, info)

server = nt.parse_launch(
    "tensor_query_serversrc name=ssrc port=0 ! "
    "tensor_filter framework=custom-easy model=invert ! "
    "tensor_query_serversink")
server.start()
port = server.get("ssrc").port
print(f"server listening on 127.0.0.1:{port}")

client = nt.parse_launch(
    "videotestsrc num-buffers=20 width=64 height=64 ! tensor_converter ! "
    f"tensor_query_client dest-host=127.0.0.1 dest-port={port} "
    "max-in-flight=8 ! tensor_sink name=out to-host=true")
client.get("out").connect(lambda buf: print("got", buf))
msg = client.run(timeout=120)
assert msg is not None and msg.kind == "eos", msg
print("client:", msg.kind)
server.stop()
