"""Autoregressive LM token streaming through a tensor_repo loop, on the
port.

Each pipeline iteration is one cached decode step
(``models.transformer.greedy_stream_model``, one CUDA graph on the card);
the KV cache circulates through the repo slot as a device tensor, and
only the sampled token ids reach the host. The weights are the JAX
package's ``init_params`` draw, bit for bit, so the tokens are the JAX
example's.

Runs on cuda:0; NNSTPU_TORCH_DEVICE=cpu runs it on the CPU.
Run: python examples/torch/llm_stream.py
"""

import numpy as np
import torch

import nnstreamer_tpu_torch as nt
from nnstreamer_tpu_torch.device import resolve_device
from nnstreamer_tpu_torch.elements.repo import GLOBAL_REPO
from nnstreamer_tpu_torch.filters.torch_backend import register_torch_model
from nnstreamer_tpu_torch.models.transformer import (
    TransformerConfig,
    build_prefill,
    greedy_stream_model,
    init_params,
    prepare_params,
)
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

N_TOKENS = 16
cfg = TransformerConfig(vocab=256, d_model=64, n_heads=4, n_layers=2,
                        d_ff=128, max_seq=64, dtype=torch.float32)
params = init_params(cfg)
register_torch_model("lm_decode", greedy_stream_model(cfg, params))

# serving flow: prefill the prompt in ONE full-sequence pass, then stream.
# The warmed cache enters the loop on the device and stays there.
device = resolve_device()
prompt = torch.tensor([[7, 42, 3, 99]], dtype=torch.int32, device=device)
with torch.inference_mode():
    logits, cache = build_prefill(cfg)(prepare_params(params, cfg, device),
                                       prompt)
first = torch.argmax(logits, dim=-1).to(torch.int32)
GLOBAL_REPO.set("lm", TensorBuffer(
    [first.cpu().numpy(), cache.values,
     np.asarray(prompt.shape[1], np.int32)], pts=0))

pipe = nt.parse_launch(
    f"tensor_reposrc slot=lm num-buffers={N_TOKENS} timeout=30 ! "
    "tensor_filter framework=jax model=lm_decode name=f ! "
    "tee name=t  t. ! tensor_reposink slot=lm  "
    "t. ! tensor_sink name=out to-host=false")

tokens = []
pipe.get("out").connect(
    lambda b: tokens.append(int(np.asarray(b[0].cpu()).reshape(-1)[0])))
msg = pipe.run(timeout=300)
assert msg is not None and msg.kind == "eos", msg
print(f"prompt {prompt.tolist()[0]} → first sampled {int(first[0])}")
print(f"streamed {len(tokens)} tokens: {tokens}")
print(f"decode-step latency: {pipe.get('f').get_property('latency')} µs")
