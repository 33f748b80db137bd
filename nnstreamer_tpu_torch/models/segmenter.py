"""Semantic segmentation model — feeds the image_segment decoder, as an
``nn.Module``.

Port of ``nnstreamer_tpu/models/segmenter.py``: an FCN/U-Net-style
encoder-decoder (three /2 encoder stages of 3×3 conv + BatchNorm + ReLU
and a 2×2 max pool, a bottleneck block, three ×2 decoder stages of
nearest upsampling, a 1×1 conv, concatenation with the skip and a block,
then 1×1 class logits). NHWC at the boundary: float32 images in,
per-pixel logits ``[B, H, W, classes]`` out.

The JAX model upsamples with ``jax.image.resize(..., "nearest")`` to the
skip's size, an exact factor of 2: output pixel ``i`` reads input pixel
``i // 2``. :func:`upsample2` picks the same pixel by broadcasting.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from nnstreamer_tpu_torch.models.mobilenet_v2 import (
    BN_EPS,
    SameConv2d,
    jax_bn,
    jax_conv,
    to_state_dict,
)
from nnstreamer_tpu_torch.models.ssd_mobilenet import _build
from nnstreamer_tpu_torch.tensors.types import TensorsInfo


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2× upsampling of NCHW ``x``: ``out[..., i, j] = x[...,
    i // 2, j // 2]``."""
    n, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2).reshape(
        n, c, 2 * h, 2 * w)


class ConvBlock(nn.Module):
    """3×3 SAME conv (no bias) → eval BatchNorm → ReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = SameConv2d(cin, cout, 3)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class Segmenter(nn.Module):
    """Encoder-decoder FCN with skip connections (U-Net shape, sized for
    streaming video)."""

    def __init__(self, num_classes: int = 21, base: int = 32):
        super().__init__()
        enc, ch, cin = [], base, 3
        for _ in range(3):
            enc.append(ConvBlock(cin, ch))
            cin, ch = ch, ch * 2
        self.encoder = nn.ModuleList(enc)
        self.bottleneck = ConvBlock(cin, ch)
        ups, dec = [], []
        for _ in range(3):
            ups.append(SameConv2d(ch, ch // 2, 1))
            dec.append(ConvBlock(ch, ch // 2))  # [up, skip] → ch // 2
            ch //= 2
        self.ups = nn.ModuleList(ups)
        self.decoder = nn.ModuleList(dec)
        self.classifier = SameConv2d(ch, num_classes, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: NHWC images; returns float32 logits ``[B, H, W, C]``."""
        x = x.to(self.classifier.weight.dtype).permute(0, 3, 1, 2)
        skips = []
        for block in self.encoder:
            x = block(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = self.bottleneck(x)
        for up, block, skip in zip(self.ups, self.decoder, reversed(skips)):
            x = up(upsample2(x))
            x = block(torch.cat([x, skip], dim=1))
        x = self.classifier(x).float().permute(0, 2, 3, 1)
        return x.contiguous()


def segmenter(num_classes: int = 21, base: int = 32, image_size: int = 256,
              batch: int = 1, dtype: torch.dtype = torch.bfloat16,
              seed: int = 0, device=None
              ) -> Tuple[Segmenter, TensorsInfo, TensorsInfo]:
    """Factory: ``(module, in_info, out_info)``. ``image_size`` must be
    divisible by 8 (three /2 encoder stages)."""
    if image_size % 8:
        raise ValueError(
            f"segmenter: image_size must be divisible by 8, got "
            f"{image_size}")
    module = _build(Segmenter(num_classes=num_classes, base=base), seed,
                    dtype, device)
    in_info = TensorsInfo.from_str(
        f"3:{image_size}:{image_size}:{batch}", "float32")
    out_info = TensorsInfo.from_str(
        f"{num_classes}:{image_size}:{image_size}:{batch}", "float32")
    return module, in_info, out_info


def params_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's Segmenter variables (leaves as numpy arrays) →
    this module's ``state_dict``. The JAX model names the blocks ``_ConvBlock_0``…
    ``_ConvBlock_6`` (three encoder stages, the bottleneck, three decoder
    stages) and the convolutions ``Conv_0``…``Conv_2`` (the decoder's 1×1)
    and ``Conv_3`` (the classifier), in creation order."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, np.ndarray] = {}

    def block(dst: str, i: int):
        name = f"_ConvBlock_{i}"
        jax_conv(out, f"{dst}.conv", params[name]["Conv_0"])
        jax_bn(out, f"{dst}.bn", params[name]["BatchNorm_0"],
               stats[name]["BatchNorm_0"])

    for i in range(3):
        block(f"encoder.{i}", i)
    block("bottleneck", 3)
    for i in range(3):
        jax_conv(out, f"ups.{i}", params[f"Conv_{i}"])
        block(f"decoder.{i}", 4 + i)
    jax_conv(out, "classifier", params["Conv_3"])
    return to_state_dict(out)
