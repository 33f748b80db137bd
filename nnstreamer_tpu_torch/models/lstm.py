"""LSTM cell — the recurrent model for tensor_repo loops (benchmark
config #5), as an ``nn.Module``.

Port of ``nnstreamer_tpu/models/lstm.py``: one dense layer over ``[x, h]``
to the four gates in the order ``i, f, g, o``, a forget bias of +1.0
added before the sigmoid, and the outputs ``(y, h', c')`` in float32
(``y`` is ``h'``). Shaped for the repo loop: one invoke per frame, the
hidden and cell state flowing through repo slots as CUDA tensors.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from nnstreamer_tpu_torch.models.mobilenet_v2 import (
    init_weights,
    jax_dense,
    to_state_dict,
)
from nnstreamer_tpu_torch.tensors.types import TensorsInfo


class LSTMCellModel(nn.Module):
    def __init__(self, input_dim: int = 128, hidden: int = 128):
        super().__init__()
        self.hidden = hidden
        self.dense = nn.Linear(input_dim + hidden, 4 * hidden)

    def forward(self, x, h, c):
        dt = self.dense.weight.dtype
        gates = self.dense(torch.cat([x, h], dim=-1).to(dt))
        i, f, g, o = torch.split(gates, self.hidden, dim=-1)
        c2 = torch.sigmoid(f + 1.0) * c + \
            torch.sigmoid(i) * torch.tanh(g)
        h2 = torch.sigmoid(o) * torch.tanh(c2)
        return h2.float(), h2.float(), c2.float()


def lstm_cell(input_dim: int = 128, hidden: int = 128, batch: int = 1,
              dtype: torch.dtype = torch.float32, seed: int = 0, device=None
              ) -> Tuple[LSTMCellModel, TensorsInfo, TensorsInfo]:
    """Factory: ``(module, in_info, out_info)``; ``module(x, h, c) -> (y,
    h', c')``."""
    module = LSTMCellModel(input_dim=input_dim, hidden=hidden)
    init_weights(module, torch.Generator().manual_seed(seed))
    module = module.to(device=device, dtype=dtype).eval()  # nns-lint: disable=NNS113 -- weights: a filter that serves the module registers them as its residency unit at open() (torch_backend._register_resident)
    in_info = TensorsInfo.from_str(
        f"{input_dim}:{batch},{hidden}:{batch},{hidden}:{batch}",
        "float32,float32,float32")
    out_info = TensorsInfo.from_str(
        f"{hidden}:{batch},{hidden}:{batch},{hidden}:{batch}",
        "float32,float32,float32")
    return module, in_info, out_info


def params_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's LSTMCellModel variables (``Dense_0``, leaves as
    numpy arrays) → this module's ``state_dict``."""
    out: Dict[str, np.ndarray] = {}
    jax_dense(out, "dense", variables["params"]["Dense_0"])
    return to_state_dict(out)


def args_from_state(state: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """``input_dim`` and ``hidden`` from the gate layer's ``(4 hidden,
    input_dim + hidden)`` weight."""
    out_dim, in_dim = state["dense.weight"].shape
    hidden = int(out_dim) // 4
    return {"input_dim": int(in_dim) - hidden, "hidden": hidden}
