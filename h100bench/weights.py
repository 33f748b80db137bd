"""Seeded weights and frames, made on the device in a few large calls.

A reference names its parameters as ``(name, shape, init)``, where
``init`` is ``("normal", std)``, ``("uniform", low, high)`` or
``("const", value)``. :func:`make` draws every normal from one
``randn`` and every uniform from one ``rand`` of a generator on the
device, seeded with ``seed``, and returns the leaves in the dtype they
are served in. The same seed gives the same weights; both the port and
the reference are handed them."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], tuple]

#: frames and weights come from generators seeded apart, so a traffic
#: mix's pool size does not move the weights
_FRAMES_STREAM = 0x9E3779B97F4A7C15


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 64))


def make(specs: List[Spec], seed: int, device, dtype: torch.dtype
         ) -> Dict[str, torch.Tensor]:
    """The leaves of ``specs`` from ``seed``, in ``dtype`` on ``device``
    (``("const", v)`` leaves of an integer name such as
    ``num_batches_tracked`` are int64)."""
    g = generator(seed, device)
    n_norm = sum(math.prod(s) for _, s, init in specs if init[0] == "normal")
    n_unif = sum(math.prod(s) for _, s, init in specs if init[0] == "uniform")
    norm = torch.randn(n_norm, generator=g, device=device,
                       dtype=torch.float32)
    unif = torch.rand(n_unif, generator=g, device=device,
                      dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    i = j = 0
    for name, shape, init in specs:
        n = math.prod(shape)
        if init[0] == "normal":
            leaf = norm[i:i + n].view(shape) * float(init[1])
            i += n
        elif init[0] == "uniform":
            lo, hi = float(init[1]), float(init[2])
            leaf = unif[j:j + n].view(shape) * (hi - lo) + lo
            j += n
        elif init[0] == "const":
            if name.endswith("num_batches_tracked"):
                out[name] = torch.full(shape, int(init[1]),
                                       dtype=torch.int64, device=device)
                continue
            leaf = torch.full(shape, float(init[1]), device=device)
        else:
            raise ValueError(f"{name}: unknown init {init!r}")
        out[name] = leaf.to(dtype)
    return out


def frames(seed: int, count: int, height: int, width: int, channels: int,
           device) -> torch.Tensor:
    """``count`` uint8 frames ``[count, height, width, channels]`` from
    ``seed``, on ``device``: uniform noise under a contrast and a colour
    of each frame's own (``noise × scale + offset`` a channel), so that
    frames differ after a network's global pool and an answer served for
    the wrong frame shows."""
    g = generator(int(seed) ^ _FRAMES_STREAM, device)
    noise = torch.rand((count, height, width, channels), generator=g,
                       device=device)
    scale = torch.rand((count, 1, 1, 1), generator=g, device=device)
    scale = 0.2 + 0.8 * scale
    offset = torch.rand((count, 1, 1, channels), generator=g, device=device)
    x = (noise * scale + offset * (1.0 - scale)) * 255.0
    return x.round().clamp(0, 255).to(torch.uint8)
