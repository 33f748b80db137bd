"""Recurrence on the port — the LSTM hidden and cell state circulates
through a tensor_repo slot as device tensors (it never leaves the card
between steps).

Runs on cuda:0; NNSTPU_TORCH_DEVICE=cpu runs it on the CPU.
Run: python examples/torch/recurrence.py
"""

import numpy as np
import torch

import nnstreamer_tpu_torch as nt
from nnstreamer_tpu_torch.filters.torch_backend import register_torch_model
from nnstreamer_tpu_torch.models.lstm import lstm_cell

hidden = 32
cell, _, _ = lstm_cell(input_dim=hidden, hidden=hidden)


class Step(torch.nn.Module):
    """One LSTM step over the slot's state ``[h, c]`` (2 × hidden)."""

    def __init__(self, cell):
        super().__init__()
        self.cell = cell

    def forward(self, state):
        s = state.reshape(1, 2 * hidden).to(torch.float32)
        h, c = s[:, :hidden], s[:, hidden:]
        _, h2, c2 = self.cell(h, h, c)
        return torch.cat([h2, c2], dim=1).reshape(2 * hidden)


register_torch_model("lstm_step", Step(cell))

pipe = nt.parse_launch(
    "tensor_reposrc slot=state num-buffers=10 "
    f"initial-dim={2 * hidden} initial-type=float32 initial-value=0.01 "
    "timeout=10 ! "
    "tensor_filter framework=jax model=lstm_step ! "
    "tee name=t  t. ! tensor_reposink slot=state  "
    "t. ! tensor_sink name=out to-host=true")
pipe.get("out").connect(
    lambda buf: print("step norm:",
                      round(float(np.linalg.norm(np.asarray(buf[0]))), 4)))
msg = pipe.run(timeout=120)
assert msg is not None and msg.kind == "eos", msg
print("run:", msg.kind)
