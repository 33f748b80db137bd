"""direct_video decoder — tensor → raw video frames.

Port of ``nnstreamer_tpu/decoders/direct_video.py``. Reference:
``ext/nnstreamer/tensor_decoder/tensordec-directvideo.c``: reinterpret a
uint8 tensor of dim (C,W,H,N) as ``video/x-raw`` frames. A host-only
mode: the decoder element fetches a device payload first (one D2H).
"""

from __future__ import annotations

import numpy as np
import torch

from nnstreamer_tpu_torch.pipeline.caps import Caps
from nnstreamer_tpu_torch.registry import DECODER, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer, host_float32

_FMT = {1: "GRAY8", 3: "RGB", 4: "RGBA"}


@subplugin(DECODER, "direct_video")
class DirectVideo:
    def out_caps(self, config, options) -> Caps:
        fields = {}
        if config is not None and config.info.is_valid():
            dim = config.info[0].dim  # (C, W, H, N)
            ch = dim[0]
            if ch not in _FMT:
                raise ValueError(f"direct_video: {ch} channels unsupported")
            fields = {
                "format": options.get("option1", _FMT[ch]).upper() or _FMT[ch],
                "width": dim[1] if len(dim) > 1 else 1,
                "height": dim[2] if len(dim) > 2 else 1,
            }
            if config.rate.num > 0:
                fields["framerate"] = str(config.rate)
        return Caps("video/x-raw", fields)

    def decode(self, buf: TensorBuffer, config, options) -> TensorBuffer:
        arr = buf[0]  # shape (N,H,W,C)
        # a host payload is numpy, but a bfloat16 one stays a CPU tensor
        arr = host_float32(arr) if isinstance(arr, torch.Tensor) \
            else np.asarray(arr)
        if arr.ndim == 4 and arr.shape[0] == 1:
            arr = arr[0]
        return buf.with_tensors([np.ascontiguousarray(arr.astype(np.uint8))])
