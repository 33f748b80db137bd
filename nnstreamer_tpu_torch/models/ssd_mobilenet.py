"""SSD-MobileNet detector (benchmark config #2), as an ``nn.Module``.

Port of ``nnstreamer_tpu/models/ssd_mobilenet.py``: a reduced MobileNetV2
backbone keeping two feature scales (stride 16 after the 96-channel
stage, stride 32 after the 320-channel one), each with a 3×3 box head
(``k·4`` channels) and a 3×3 class head (``k·C``). It gives the
``bounding_boxes option1=mobilenet-ssd`` contract: box encodings
``[N, A, 4]`` and class logits ``[N, A, C]``, float32, plus the anchor
grid (:func:`anchor_grid`) the decoder reads them against.

- NHWC at the public boundary; the heads' NCHW outputs are permuted to
  NHWC before they are flattened, so the flat anchor index is the JAX
  model's, cell-major with the anchor innermost: ``(h·W + w)·k + a``.
- :func:`anchor_grid` is the JAX function's copy, and it orders the
  anchors anchor-major with the cell innermost (``a·cells² + cell``): not
  the model's order. Both count 2,766 anchors at 300×300, so the decoder's
  count check passes; the port reproduces the JAX package's pairing
  exactly (ROADMAP.md queue C records the mismatch).
- Stride-2 convolutions pad ``SAME`` asymmetrically (``same_pads``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from nnstreamer_tpu_torch.models.mobilenet_v2 import (
    BN_EPS,
    InvertedResidual,
    SameConv2d,
    init_weights,
    jax_blocks,
    jax_bn,
    jax_conv,
    to_state_dict,
)
from nnstreamer_tpu_torch.tensors.types import TensorsInfo


class MobileNetStem(nn.Module):
    """3×3 stride-2 convolution to 32 channels, BatchNorm, ReLU6, then
    inverted residual stages ``(expand, out_ch, repeats, stride)``: the
    backbone shape the JAX package's SSD, YOLO and PoseNet share."""

    def __init__(self, cfg):
        super().__init__()
        self.stem = SameConv2d(3, 32, 3, 2)
        self.stem_bn = nn.BatchNorm2d(32, eps=BN_EPS)
        blocks: List[nn.Module] = []
        ch = 32
        self.stage_ends: List[int] = []
        for expand, out_ch, repeats, stride in cfg:
            for i in range(repeats):
                blocks.append(InvertedResidual(ch, out_ch,
                                               stride if i == 0 else 1,
                                               expand))
                ch = out_ch
            self.stage_ends.append(len(blocks))
        self.blocks = nn.ModuleList(blocks)
        self.out_channels = ch

    def stem_forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images → the stem's output (NCHW view of channels_last
        strides, in the weights' dtype)."""
        x = x.to(self.stem.weight.dtype).permute(0, 3, 1, 2)
        return F.relu6(self.stem_bn(self.stem(x)))


def nhwc_rows(x: torch.Tensor, width: int) -> torch.Tensor:
    """An NCHW head output as the JAX model's NHWC ``reshape(n, -1,
    width)``: rows cell-major, channel groups of ``width`` innermost."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, width)


class SSDMobileNet(MobileNetStem):
    # (expand, out_ch, repeats, stride); the stride-16 map ends stage 4
    CFG = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 3, 2),
           (6, 96, 2, 1), (6, 160, 2, 2), (6, 320, 1, 1)]
    FEATURE_STAGES = (4, 6)

    def __init__(self, num_classes: int = 91, num_anchors_per_cell: int = 6):
        super().__init__(self.CFG)
        self.num_classes = num_classes
        k = num_anchors_per_cell
        chans = [self.CFG[s][1] for s in self.FEATURE_STAGES]
        self.box_heads = nn.ModuleList(SameConv2d(c, k * 4, 3, bias=True)
                                       for c in chans)
        self.cls_heads = nn.ModuleList(
            SameConv2d(c, k * num_classes, 3, bias=True) for c in chans)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``x``: NHWC images; returns float32 ``(boxes [N, A, 4],
        scores [N, A, C])``."""
        x = self.stem_forward(x)
        feats = []
        ends = [self.stage_ends[s] for s in self.FEATURE_STAGES]
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i + 1 in ends:
                feats.append(x)
        boxes = [nhwc_rows(h(f), 4) for h, f in zip(self.box_heads, feats)]
        scores = [nhwc_rows(h(f), self.num_classes)
                  for h, f in zip(self.cls_heads, feats)]
        return torch.cat(boxes, 1).float(), torch.cat(scores, 1).float()


def anchor_grid(image_size: int = 300, strides=(16, 32),
                num_anchors_per_cell: int = 6) -> np.ndarray:
    """Anchor centers/sizes [anchors, 4] as (cy, cx, h, w) in [0,1] —
    consumed by the bounding_boxes decoder. The JAX function's arithmetic
    and order (anchor-major, cell innermost), in numpy."""
    anchors = []
    scales = np.linspace(0.2, 0.9, len(strides) * num_anchors_per_cell)
    si = 0
    for stride in strides:
        # SAME-padded stride-s convs produce ceil(size/s) cells — the grid
        # must match the model's feature-map geometry exactly
        cells = -(-image_size // stride)
        for a in range(num_anchors_per_cell):
            s = scales[si]
            si += 1
            ratio = [1.0, 2.0, 0.5, 3.0, 1.0 / 3.0, 1.0][a % 6]
            h, w = s / np.sqrt(ratio), s * np.sqrt(ratio)
            ys, xs = np.meshgrid(
                (np.arange(cells) + 0.5) / cells,
                (np.arange(cells) + 0.5) / cells, indexing="ij",
            )
            grid = np.stack(
                [ys.ravel(), xs.ravel(),
                 np.full(cells * cells, h), np.full(cells * cells, w)],
                axis=1,
            )
            anchors.append(grid)
    return np.concatenate(anchors, axis=0).astype(np.float32)


def _build(module: nn.Module, seed: int, dtype, device) -> nn.Module:
    """Seeded weights (``mobilenet_v2.init_weights``) in float32 on the
    CPU, then ``dtype``, channels_last, eval mode, on ``device``."""
    init_weights(module, torch.Generator().manual_seed(seed))
    return module.to(device=device, dtype=dtype,  # nns-lint: disable=NNS113 -- weights: a filter that serves the module registers them as its residency unit at open() (torch_backend._register_resident)
                     memory_format=torch.channels_last).eval()


def ssd_mobilenet(num_classes: int = 91, image_size: int = 300,
                  batch: int = 1, dtype: torch.dtype = torch.bfloat16,
                  seed: int = 0, device=None
                  ) -> Tuple[SSDMobileNet, TensorsInfo, TensorsInfo]:
    """Factory: ``(module, in_info, out_info)`` for
    ``register_torch_model``. Input float32 NHWC (preprocessing belongs to
    tensor_transform)."""
    module = _build(SSDMobileNet(num_classes=num_classes), seed, dtype,
                    device)
    num_anchors = anchor_grid(image_size).shape[0]
    in_info = TensorsInfo.from_str(
        f"3:{image_size}:{image_size}:{batch}", "float32")
    out_info = TensorsInfo.from_str(
        f"4:{num_anchors}:{batch},{num_classes}:{num_anchors}:{batch}",
        "float32,float32")
    return module, in_info, out_info


def stem_from_jax(out: Dict[str, np.ndarray], params, stats) -> None:
    """``Conv_0``/``BatchNorm_0`` and the inverted residuals of a JAX
    :class:`MobileNetStem`-shaped model."""
    jax_conv(out, "stem", params["Conv_0"])
    jax_bn(out, "stem_bn", params["BatchNorm_0"], stats["BatchNorm_0"])
    jax_blocks(out, params, stats)


def params_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's SSDMobileNet variables (leaves as numpy arrays)
    → this module's ``state_dict``. The heads are ``Conv_1``…``Conv_4`` in
    creation order: box then class head of each feature map."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, np.ndarray] = {}
    stem_from_jax(out, params, stats)
    for f in range(2):
        jax_conv(out, f"box_heads.{f}", params[f"Conv_{1 + 2 * f}"])
        jax_conv(out, f"cls_heads.{f}", params[f"Conv_{2 + 2 * f}"])
    return to_state_dict(out)


def args_from_state(state: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """The class count a converted checkpoint's class head fixes (6
    anchors a cell)."""
    return {"num_classes": int(state["cls_heads.0.weight"].shape[0]) // 6}
