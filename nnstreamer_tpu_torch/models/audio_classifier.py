"""1-D conv audio classifier — the audio model family, as an ``nn.Module``.

Port of ``nnstreamer_tpu/models/audio_classifier.py``: a compact
keyword-spotting network over a mono window — four convolutions (kernel
9, strides 4, 4, 2, 2, widths w, w, 2w, 2w, each with a bias and a ReLU),
a mean over time, ``Dense(2w)`` with a ReLU and ``Dense(classes)``.

- The JAX layers pad ``SAME`` with a stride, which ``nn.Conv1d`` does not
  offer: each convolution pads explicitly, the low side taking ``total //
  2`` where ``total = max((ceil(n/s) - 1)·s + k - n, 0)``
  (``mobilenet_v2.same_pads``).
- The activations are ``[B, C, L]`` here and ``[B, L, C]`` in the JAX
  model; a window arrives ``[L, C]`` (the converter's audio layout) or
  ``[B, L, C]``.
- The compute dtype is the convolutions' (bfloat16 by default): the
  convolutions, the mean over time and the first dense layer run in it;
  the last dense layer keeps float32 weights and takes its input in
  float32, as the JAX layer promotes it; the logits are float32.
- The factory fills the weights as the JAX package's seeded
  ``models/_init.py::fast_init`` does (numpy, one stream per variable
  path), so a seed gives the JAX model's weights; :func:`params_from_jax`
  maps any JAX variables onto this module's ``state_dict``.

Pipeline shape::

  audiotestsrc ! tensor_converter ! tensor_aggregator frames-in=1600
  frames-out=16000 frames-flush=8000 frames-dim=1 concat=true !
  tensor_transform mode=arithmetic option=typecast:float32,div:32768 !
  tensor_filter framework=jax model=kws ! tensor_decoder mode=image_labeling

The convolutions are cuDNN's: the JAX package's are XLA's and reach no
Pallas kernel. Kernel B1 runs the transform before it.
"""

from __future__ import annotations

import zlib
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from nnstreamer_tpu_torch.models.mobilenet_v2 import (
    jax_dense,
    same_pads,
    to_state_dict,
)
from nnstreamer_tpu_torch.tensors.types import TensorsInfo

KERNEL = 9
STRIDES = (4, 4, 2, 2)


class AudioClassifier(nn.Module):
    """Conv1D keyword-spotting classifier over a mono window."""

    def __init__(self, num_classes: int = 12, width: int = 64,
                 channels: int = 1):
        super().__init__()
        widths = [width * (1 + i // 2) for i in range(len(STRIDES))]
        cins = [channels] + widths[:-1]
        self.convs = nn.ModuleList(
            nn.Conv1d(cin, cout, KERNEL, stride=s)
            for cin, cout, s in zip(cins, widths, STRIDES))
        self.dense0 = nn.Linear(widths[-1], width * 2)
        self.dense1 = nn.Linear(width * 2, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 2:  # the converter's [samples, ch]: add the batch
            x = x[None]
        dt = self.convs[0].weight.dtype
        h = x.to(torch.float32).to(dt).transpose(1, 2)
        for conv, stride in zip(self.convs, STRIDES):
            h = F.pad(h, same_pads(h.shape[-1], KERNEL, stride))
            h = F.relu(conv(h))
        h = h.mean(dim=2)  # global average pool over time, in dt
        h = F.relu(self.dense0(h))
        return self.dense1(h.to(self.dense1.weight.dtype))


def _jax_paths(module: AudioClassifier) -> Dict[str, str]:
    """This module's parameter name → the JAX model's variable path."""
    paths = {}
    for i in range(len(module.convs)):
        paths[f"convs.{i}.weight"] = f"params/Conv_{i}/kernel"
        paths[f"convs.{i}.bias"] = f"params/Conv_{i}/bias"
    for i in range(2):
        paths[f"dense{i}.weight"] = f"params/Dense_{i}/kernel"
        paths[f"dense{i}.bias"] = f"params/Dense_{i}/bias"
    return paths


def _fast_init_leaf(path: str, shape, seed: int) -> np.ndarray:
    """One variable as the JAX package's ``fast_init`` fills it: biases
    zero, kernels N(0, 1/sqrt(fan_in)) from a numpy stream keyed by (seed,
    crc32 of the path), fan_in the product of all dims but the last."""
    if path.rsplit("/", 1)[-1] == "bias":
        return np.zeros(shape, np.float32)
    fan_in = int(np.prod(shape[:-1]))
    rng = np.random.default_rng([seed, zlib.crc32(path.encode())])
    return rng.normal(0.0, 1.0 / np.sqrt(max(fan_in, 1)),
                      size=shape).astype(np.float32)


def init_weights(module: AudioClassifier, seed: int) -> None:
    """The JAX package's seeded weights for the same configuration."""
    variables: dict = {"params": {}}
    for name, path in _jax_paths(module).items():
        p = dict(module.named_parameters())[name]
        _, layer, leaf = path.split("/")
        if leaf == "bias":
            shape = tuple(p.shape)
        elif p.ndim == 3:  # (out, in, k) ← (k, in, out)
            shape = (p.shape[2], p.shape[1], p.shape[0])
        else:  # (out, in) ← (in, out)
            shape = (p.shape[1], p.shape[0])
        variables["params"].setdefault(layer, {})[leaf] = \
            _fast_init_leaf(path, shape, seed)
    module.load_state_dict(params_from_jax(variables))


def audio_classifier(samples: int = 16000, channels: int = 1,
                     num_classes: int = 12, batch: int = 1,
                     dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                     device=None
                     ) -> Tuple[AudioClassifier, TensorsInfo, TensorsInfo]:
    """Factory: ``(module, in_info, out_info)``, the arguments
    ``register_torch_model(name, ...)`` takes after the name.

    ``in_info`` matches the converter's audio layout (samples × channels a
    window, float32); ``out_info`` is the class-logit vector the
    image_labeling decoder consumes. ``batch`` is the JAX factory's
    argument: the model takes any batch."""
    del batch
    module = AudioClassifier(num_classes=num_classes, channels=channels)
    init_weights(module, seed)
    module = module.to(device=device, dtype=dtype).eval()
    module.dense1.float()  # the JAX model's Dense(dtype=float32)
    in_info = TensorsInfo.from_str(f"{channels}:{samples}", "float32")
    out_info = TensorsInfo.from_str(f"{num_classes}:1", "float32")
    return module, in_info, out_info


def params_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's AudioClassifier variables (``Conv_0..3``,
    ``Dense_0..1``, leaves as numpy arrays) → this module's
    ``state_dict`` (float32 CPU tensors)."""
    params = variables["params"]
    out: Dict[str, np.ndarray] = {}
    i = 0
    while f"Conv_{i}" in params:
        conv = params[f"Conv_{i}"]
        # the JAX layout (k, in, out) → torch (out, in, k)
        out[f"convs.{i}.weight"] = np.ascontiguousarray(
            np.asarray(conv["kernel"]).transpose(2, 1, 0))
        out[f"convs.{i}.bias"] = np.asarray(conv["bias"])
        i += 1
    jax_dense(out, "dense0", params["Dense_0"])
    jax_dense(out, "dense1", params["Dense_1"])
    return to_state_dict(out)
