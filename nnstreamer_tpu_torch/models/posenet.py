"""PoseNet — keypoint heatmap model (benchmark config #3), as an
``nn.Module``.

Port of ``nnstreamer_tpu/models/posenet.py``: a MobileNet-style backbone
to stride 16 and two 1×1 heads, 17 keypoint heatmaps (sigmoid) and 2·17
short-range offsets, both float32 NHWC (``[B, H, W, K]`` and ``[B, H, W,
2K]``), the ``pose_estimation`` decoder's layout.
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
    stem_from_jax,
)
from nnstreamer_tpu_torch.tensors.types import TensorsInfo

NUM_KEYPOINTS = 17


class PoseNet(MobileNetStem):
    CFG = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 2, 2), (6, 64, 2, 2)]

    def __init__(self, num_keypoints: int = NUM_KEYPOINTS):
        super().__init__(self.CFG)
        self.heat = SameConv2d(self.out_channels, num_keypoints, 1,
                               bias=True)
        self.offs = SameConv2d(self.out_channels, 2 * num_keypoints, 1,
                               bias=True)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``x``: NHWC images; returns float32 NHWC ``(heatmaps,
        offsets)``."""
        x = self.stem_forward(x)
        for block in self.blocks:
            x = block(x)
        heat = torch.sigmoid(self.heat(x)).float().permute(0, 2, 3, 1)
        offs = self.offs(x).float().permute(0, 2, 3, 1)
        return heat.contiguous(), offs.contiguous()


def posenet(image_size: int = 257, batch: int = 1,
            dtype: torch.dtype = torch.bfloat16, seed: int = 0, device=None
            ) -> Tuple[PoseNet, TensorsInfo, TensorsInfo]:
    """Factory: ``(module, in_info, out_info)``."""
    module = _build(PoseNet(), seed, dtype, device)
    hw = image_size
    for stride in (2, 2, 2, 2):  # the stem and the three stride-2 stages
        hw = -(-hw // stride)
    k = NUM_KEYPOINTS
    in_info = TensorsInfo.from_str(
        f"3:{image_size}:{image_size}:{batch}", "float32")
    out_info = TensorsInfo.from_str(
        f"{k}:{hw}:{hw}:{batch},{2 * k}:{hw}:{hw}:{batch}",
        "float32,float32")
    return module, in_info, out_info


def params_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's PoseNet variables (leaves as numpy arrays) → this
    module's ``state_dict``; the heads are ``Conv_1`` (heatmaps) and
    ``Conv_2`` (offsets)."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, np.ndarray] = {}
    stem_from_jax(out, params, stats)
    jax_conv(out, "heat", params["Conv_1"])
    jax_conv(out, "offs", params["Conv_2"])
    return to_state_dict(out)


def args_from_state(state: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """PoseNet's shapes take no factory argument."""
    return {}
