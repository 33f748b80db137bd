"""YOLO-style single-head detector, as an ``nn.Module`` — pairs with the
bounding_boxes decoder's ``option1=yolov5`` mode.

Port of ``nnstreamer_tpu/models/yolo.py``: a MobileNet-style backbone to
stride 16 and one 1×1 head of ``k·(5+C)`` channels, whose rows are
``(cx, cy, w, h, objectness, class logits…)`` with the box already in
[0, 1] (cell offset + sigmoid for the centre, sigmoid for the size) and
objectness and classes left as logits for the decoder.

The head's NCHW output is permuted to NHWC before it is flattened, so
row ``(h·W + w)·k + a`` is the JAX model's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from nnstreamer_tpu_torch.models.mobilenet_v2 import (
    SameConv2d,
    jax_conv,
    to_state_dict,
)
from nnstreamer_tpu_torch.models.ssd_mobilenet import (
    MobileNetStem,
    _build,
    nhwc_rows,
    stem_from_jax,
)
from nnstreamer_tpu_torch.tensors.types import TensorsInfo


class YoloDetector(MobileNetStem):
    CFG = [(1, 16, 1, 1), (6, 32, 2, 2), (6, 64, 2, 2), (6, 128, 3, 2)]

    def __init__(self, num_classes: int = 80, anchors_per_cell: int = 3):
        super().__init__(self.CFG)
        self.num_classes = num_classes
        self.anchors_per_cell = anchors_per_cell
        self.head = SameConv2d(self.out_channels,
                               anchors_per_cell * (5 + num_classes), 1,
                               bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: NHWC images; returns float32 ``[N, A, 5 + C]``."""
        x = self.stem_forward(x)
        for block in self.blocks:
            x = block(x)
        k, c = self.anchors_per_cell, self.num_classes
        ch, cw = x.shape[2], x.shape[3]
        pred = nhwc_rows(self.head(x), 5 + c).float()
        # each cell's column and row, repeated for its k anchors (no
        # repeat_interleave: on the card it may wait for the device)
        cell = torch.arange(ch * cw, device=pred.device)[:, None]
        gx = (cell % cw).expand(-1, k).reshape(-1).to(torch.float32)
        gy = (cell // cw).expand(-1, k).reshape(-1).to(torch.float32)
        cx = (torch.sigmoid(pred[:, :, 0]) + gx) / cw
        cy = (torch.sigmoid(pred[:, :, 1]) + gy) / ch
        w = torch.sigmoid(pred[:, :, 2])
        h = torch.sigmoid(pred[:, :, 3])
        return torch.cat([torch.stack([cx, cy, w, h], dim=2), pred[:, :, 4:]],
                         dim=2)


def yolo_detector(num_classes: int = 80, image_size: int = 320,
                  batch: int = 1, dtype: torch.dtype = torch.float32,
                  seed: int = 0, device=None
                  ) -> Tuple[YoloDetector, TensorsInfo, TensorsInfo]:
    """Factory: ``(module, in_info, out_info)``; the output is ``[N, A,
    5 + C]`` in the bounding_boxes yolov5 decoder contract."""
    module = _build(YoloDetector(num_classes=num_classes), seed, dtype,
                    device)
    cells = -(-image_size // 16)
    anchors = cells * cells * module.anchors_per_cell
    in_info = TensorsInfo.from_str(
        f"3:{image_size}:{image_size}:{batch}", "float32")
    out_info = TensorsInfo.from_str(
        f"{5 + num_classes}:{anchors}:{batch}", "float32")
    return module, in_info, out_info


def params_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's YoloDetector variables (leaves as numpy arrays)
    → this module's ``state_dict``; the head is ``Conv_1``."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, np.ndarray] = {}
    stem_from_jax(out, params, stats)
    jax_conv(out, "head", params["Conv_1"])
    return to_state_dict(out)
