"""tensor_converter — media streams → ``other/tensors``.

Reference: ``gst/nnstreamer/elements/gsttensorconverter.c``. The port
converts ``video/x-raw`` frames (``(H, W, C)`` → tensor shape
``(N, H, W, C)``, dim ``(C, W, H, N)``, with ``frames-per-tensor``
batching, stacked into a staging slab of ``tensors/pool.py``) and passes
static tensor streams through. Audio, octet/text
re-chunking and custom converter subplugins are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from nnstreamer_tpu_torch.pipeline.caps import Caps
from nnstreamer_tpu_torch.pipeline.element import Element, not_ported
from nnstreamer_tpu_torch.registry import ELEMENT, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensors.pool import get_pool
from nnstreamer_tpu_torch.tensors.types import (
    Fraction,
    TensorFormat,
    TensorInfo,
    TensorsConfig,
    TensorsInfo,
    TensorType,
)

_VIDEO_CHANNELS = {"RGB": 3, "BGR": 3, "RGBA": 4, "BGRA": 4, "GRAY8": 1}
_OTHER_MEDIA = "A.17 tensor_converter's other media"


@subplugin(ELEMENT, "tensor_converter")
class TensorConverter(Element):
    ELEMENT_NAME = "tensor_converter"
    PROPERTIES = {
        **Element.PROPERTIES,
        "frames_per_tensor": 1,
        "set_timestamp": True,
    }
    UNPORTED_PROPERTIES = {
        "input_dim": _OTHER_MEDIA,
        "input_type": _OTHER_MEDIA,
        "format": _OTHER_MEDIA,
        "mode": _OTHER_MEDIA,
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        self._in_caps: Optional[Caps] = None
        self._out_config: Optional[TensorsConfig] = None
        self._frame_acc: list = []   # adapter for frames-per-tensor batching
        self._frame_idx = 0

    def reorder_safe(self):
        # frames_per_tensor=1 maps each input buffer to exactly one output
        # with no cross-frame state (_frame_acc stays empty, _frame_idx is
        # unused when the source stamps pts) — replicable across lanes;
        # batching folds several frames and must see the stream in order
        return int(self.get_property("frames_per_tensor") or 1) <= 1

    # -- negotiation ---------------------------------------------------------
    def transform_caps(self, pad, caps):
        self._in_caps = caps
        self._out_config = self._derive_config(caps)
        return self._out_config.to_caps()

    def _derive_config(self, caps: Caps) -> TensorsConfig:
        rate = Fraction.parse(caps.get("framerate", "0/1"))
        fpt = int(self.get_property("frames_per_tensor"))
        if caps.name == "video/x-raw":
            ch = _VIDEO_CHANNELS[caps.get("format", "RGB")]
            w, h = int(caps["width"]), int(caps["height"])
            info = TensorInfo(dim=(ch, w, h, fpt), type=TensorType.UINT8)
            return TensorsConfig(info=TensorsInfo([info]), rate=rate)
        if caps.name in ("other/tensor", "other/tensors"):
            cfg = TensorsConfig.from_caps(caps)
            if cfg.format is TensorFormat.STATIC:
                return cfg
        raise not_ported(f"tensor_converter input {caps!r}", _OTHER_MEDIA)

    # -- dataflow ------------------------------------------------------------
    def chain(self, pad, buf):
        if self._in_caps is not None and self._in_caps.name == "video/x-raw":
            return self._chain_video(buf)
        return self._emit(buf)  # static tensor passthrough

    def _emit(self, buf: TensorBuffer):
        if self.get_property("set_timestamp") and buf.pts is None:
            rate = self._out_config.rate if self._out_config else Fraction(0, 1)
            dur = rate.frame_duration_ns
            buf = buf.replace(pts=self._frame_idx * dur if dur else
                              TensorBuffer.wall_clock_pts())
        self._frame_idx += 1
        return self.srcpad.push(buf)

    def _chain_video(self, buf):
        """video frame (H,W,C) → tensor shape (N,H,W,C) == dim (C,W,H,N)."""
        frame = np.asarray(buf[0])
        if frame.ndim == 2:
            frame = frame[:, :, None]
        fpt = int(self.get_property("frames_per_tensor"))
        if fpt <= 1:
            return self._emit(buf.with_tensors([frame[None]]))
        self._frame_acc.append((frame, buf))
        if len(self._frame_acc) < fpt:
            return None
        acc = [f for f, _ in self._frame_acc]
        if all(f.shape == acc[0].shape and f.dtype == acc[0].dtype
               for f in acc):
            # the converter's one per-output host allocation on the
            # batched ingest path: a recycled staging slab
            frames = get_pool().acquire((len(acc),) + acc[0].shape,
                                        acc[0].dtype)
            np.stack(acc, axis=0, out=frames)
        else:
            frames = np.stack(acc, axis=0)
        first = self._frame_acc[0][1]
        self._frame_acc.clear()
        return self._emit(first.with_tensors([frames]))

    def handle_eos(self):
        self._frame_acc.clear()
