"""image_segment decoder — segmentation logits → class-colored video.

Port of ``nnstreamer_tpu/decoders/image_segment.py``. Reference:
``ext/nnstreamer/tensor_decoder/tensordec-imagesegment.c``: per-pixel
argmax over class maps → colored RGBA frame (tflite-deeplab mode). The
device half is the argmax (first maximum, as ``np.argmax``): an
``[H, W]`` int32 class map leaves the device instead of ``[H, W, C]``
logits; the palette and alpha stay on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from nnstreamer_tpu_torch.pipeline.caps import Caps
from nnstreamer_tpu_torch.registry import DECODER, subplugin
from nnstreamer_tpu_torch.tensors.buffer import (
    TensorBuffer,
    host_array,
    host_float32,
)


def _palette(n: int) -> np.ndarray:
    """Deterministic label colors (the PASCAL-VOC bit-twiddling palette)."""
    pal = np.zeros((n, 3), np.uint8)
    for i in range(n):
        c, r, g, b = i, 0, 0, 0
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        pal[i] = (r, g, b)
    return pal


@subplugin(DECODER, "image_segment")
class ImageSegment:
    def out_caps(self, config, options) -> Caps:
        fields = {"format": "RGBA"}
        if config is not None and config.info.is_valid():
            dim = config.info[0].dim  # (C, W, H, N)
            fields.update(width=dim[1], height=dim[2])
        return Caps("video/x-raw", fields)

    def decode(self, buf: TensorBuffer, config, options) -> TensorBuffer:
        seg = host_float32(buf[0])
        if seg.ndim == 4:
            seg = seg[0]               # (H, W, C)
        if seg.ndim == 3 and seg.shape[2] > 1:
            labels = seg.argmax(axis=2)
        else:
            labels = seg.reshape(seg.shape[0], seg.shape[1]).astype(int)
        return self._emit(buf, labels)

    def _emit(self, buf: TensorBuffer, labels: np.ndarray) -> TensorBuffer:
        pal = _palette(int(labels.max()) + 1)
        rgb = pal[labels]
        alpha = np.where(labels > 0, 192, 0).astype(np.uint8)[..., None]
        return buf.with_tensors(
            [np.concatenate([rgb, alpha], axis=2)]
        ).replace(meta={**buf.meta, "segment_labels": labels})

    # -- device/host split (elements/decoder.py, pipeline/fuse.py) -----------
    def device_kernel(self, options):
        """Device half: per-pixel argmax where the logits lie."""

        def fn(consts, tensors):
            seg = tensors[0]
            if seg.ndim == 4:
                seg = seg[0]
            if seg.ndim == 3 and seg.shape[2] > 1:
                labels = torch.argmax(seg, dim=2)
            else:
                labels = seg.reshape(seg.shape[0], seg.shape[1])
            return [labels.to(torch.int32)]

        return None, fn

    def host_finalize(self, host_buf: TensorBuffer, config, options
                      ) -> TensorBuffer:
        labels = np.asarray(host_array(host_buf[0])).astype(int)
        return self._emit(host_buf, labels)
