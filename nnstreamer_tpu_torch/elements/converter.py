"""tensor_converter — media streams → ``other/tensors``.

Port of ``nnstreamer_tpu/elements/converter.py``. Reference:
``gst/nnstreamer/elements/gsttensorconverter.c``: converts
video/audio/text/octet/flexible streams into typed tensor frames,
re-chunking with a GstAdapter (``_gst_tensor_converter_chain_chunk``),
handling ``frames-per-tensor`` batching, and delegating other media types
to converter subplugins (``registerExternalConverter``; here
``mode=custom-code:<name>``, ``converters/``).

Only converter (and decoder) know media semantics — every other element is
semantics-agnostic. Dim conventions match the reference: video → (C, W, H,
N-frames), stacked into a staging slab of ``tensors/pool.py`` when batched;
audio → (channels, samples), re-chunked to ``frames-per-tensor`` samples;
text/octet → per ``input-dim``/``input-type``, re-chunked across buffer
boundaries (without ``input-dim`` an octet buffer is one flat tensor and
the output caps are announced from the first buffer). Every regime works
on host arrays: the sources before a converter make them.

The audio adapter stamps every chunk it emits with the pts of the first
input buffer it holds, the chunks cut from a carried-over remainder
included, as the JAX package does (ROADMAP.md C.30).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from nnstreamer_tpu_torch.pipeline.caps import Caps
from nnstreamer_tpu_torch.pipeline.element import Element
from nnstreamer_tpu_torch.registry import CONVERTER, ELEMENT, get_subplugin, subplugin
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
_AUDIO_TYPES = {"S8": "int8", "U8": "uint8", "S16LE": "int16",
                "U16LE": "uint16", "S32LE": "int32", "U32LE": "uint32",
                "F32LE": "float32", "F64LE": "float64"}
_OCTET_MEDIA = ("application/octet-stream", "text/x-raw")


@subplugin(ELEMENT, "tensor_converter")
class TensorConverter(Element):
    ELEMENT_NAME = "tensor_converter"
    PROPERTIES = {
        **Element.PROPERTIES,
        "frames_per_tensor": 1,
        "input_dim": None,   # for octet/text streams: e.g. "3:224:224:1"
        "input_type": None,  # e.g. "uint8"
        "format": "static",  # output format: static | flexible
        "mode": None,        # "custom-code:<registered-converter-name>"
        "set_timestamp": True,
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        self._in_caps: Optional[Caps] = None
        self._out_config: Optional[TensorsConfig] = None
        self._pending = bytearray()  # adapter for octet re-chunking
        self._frame_acc: list = []   # adapter for frames-per-tensor batching
        self._custom = None
        self._frame_idx = 0

    def reorder_safe(self):
        # frames_per_tensor=1 with no octet re-chunking (input_dim) and no
        # custom converter maps each input buffer to exactly one output
        # with no cross-frame state (_pending/_frame_acc stay empty,
        # _frame_idx is unused when the source stamps pts) — replicable
        # across lanes; the batching and re-chunking regimes fold several
        # buffers and must see the stream in order
        return (int(self.get_property("frames_per_tensor") or 1) <= 1
                and not self.get_property("mode")
                and not self.get_property("input_dim"))

    # -- negotiation ---------------------------------------------------------
    def transform_caps(self, pad, caps):
        self._in_caps = caps
        self._out_config = self._derive_config(caps)
        if self._out_config is None:
            return None  # flexible/custom: announce on first buffer
        return self._out_config.to_caps()

    def _derive_config(self, caps: Caps) -> Optional[TensorsConfig]:
        mode = self.get_property("mode")
        if mode:  # the converter subplugin owns the output config
            name = mode.split(":", 1)[1] if ":" in mode else mode
            impl = get_subplugin(CONVERTER, name)
            if impl is None:
                raise ValueError(f"tensor_converter: no converter subplugin "
                                 f"{name!r}")
            self._custom = impl() if isinstance(impl, type) else impl
            return getattr(self._custom, "get_out_config",
                           lambda c: None)(caps)
        rate = Fraction.parse(caps.get("framerate", "0/1"))
        fpt = int(self.get_property("frames_per_tensor"))
        if caps.name == "video/x-raw":
            ch = _VIDEO_CHANNELS[caps.get("format", "RGB")]
            w, h = int(caps["width"]), int(caps["height"])
            info = TensorInfo(dim=(ch, w, h, fpt), type=TensorType.UINT8)
            return TensorsConfig(info=TensorsInfo([info]), rate=rate)
        if caps.name == "audio/x-raw":
            t = TensorType(_AUDIO_TYPES[caps.get("format", "S16LE")])
            ch = int(caps.get("channels", 1))
            info = TensorInfo(dim=(ch, fpt), type=t)
            return TensorsConfig(info=TensorsInfo([info]), rate=rate)
        if caps.name in _OCTET_MEDIA:
            dim = self.get_property("input_dim")
            typ = self.get_property("input_type") or "uint8"
            if caps.name == "text/x-raw" and dim is None:
                raise ValueError(
                    "tensor_converter: text streams need input-dim "
                    "(the reference requires 'input-dim' for text)")
            if dim is None:
                return None  # per-buffer shape → announced from the first
            info = TensorInfo.from_str(dim, typ)
            return TensorsConfig(info=TensorsInfo([info]), rate=rate)
        if caps.name in ("other/tensor", "other/tensors"):
            cfg = TensorsConfig.from_caps(caps)
            if cfg.format is not TensorFormat.STATIC:
                return None  # flexible input: emit static per-buffer
            return cfg
        raise ValueError(f"tensor_converter: unsupported media {caps.name!r} "
                         f"(use mode=custom-code:<name>)")

    # -- dataflow ------------------------------------------------------------
    def chain(self, pad, buf):
        if self._custom is not None:
            return self._emit(self._custom.convert(buf, self._in_caps))
        caps_name = self._in_caps.name if self._in_caps else MEDIA_DEFAULT
        if caps_name == "video/x-raw":
            return self._chain_video(buf)
        if caps_name == "audio/x-raw":
            return self._chain_audio(buf)
        if caps_name in _OCTET_MEDIA:
            return self._chain_octet(buf)
        return self._emit(buf)  # tensor passthrough (possibly flex→static)

    def _emit(self, buf: TensorBuffer):
        if self.srcpad.caps is None:
            cfg = TensorsConfig.from_arrays(buf.tensors)
            if self.get_property("format") == "flexible":
                cfg = TensorsConfig(format=TensorFormat.FLEXIBLE)
            self.srcpad.set_caps(cfg.to_caps())
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

    def _chain_audio(self, buf):
        """(samples, channels) chunks re-cut to ``frames-per-tensor``
        samples (each buffer as it comes when that is 1)."""
        samples = np.asarray(buf[0])
        if samples.ndim == 1:
            samples = samples[:, None]
        fpt = int(self.get_property("frames_per_tensor"))
        want = fpt if fpt > 1 else samples.shape[0]
        self._frame_acc.append((samples, buf))
        total = sum(s.shape[0] for s, _ in self._frame_acc)
        if total < want:
            return None
        cat = np.concatenate([s for s, _ in self._frame_acc], axis=0)
        # every chunk, the carried-over remainder's too, keeps the first
        # held buffer's timing (C.30: both packages)
        first = self._frame_acc[0][1]
        self._frame_acc.clear()
        ret = None
        while cat.shape[0] >= want:
            chunk, cat = cat[:want], cat[want:]
            ret = self._emit(first.with_tensors([chunk]))
        if cat.shape[0]:
            self._frame_acc.append((cat, first))
        return ret

    def _chain_octet(self, buf):
        """Bytes → tensors of ``input-dim``/``input-type``, re-chunked
        across buffer boundaries; without ``input-dim`` one flat tensor a
        buffer."""
        dim = self.get_property("input_dim")
        typ = TensorType.from_any(self.get_property("input_type") or "uint8")
        raw = np.ascontiguousarray(np.asarray(buf[0])).tobytes()
        if dim is None:
            arr = np.frombuffer(raw, dtype=typ.np_dtype)
            return self._emit(buf.with_tensors([arr]))
        info = TensorInfo.from_str(dim, typ.value)
        self._pending.extend(raw)
        frame_size = info.size
        ret = None
        while len(self._pending) >= frame_size:
            chunk = bytes(self._pending[:frame_size])
            del self._pending[:frame_size]
            arr = np.frombuffer(chunk, dtype=typ.np_dtype).reshape(info.shape)
            ret = self._emit(buf.with_tensors([arr]))
        return ret

    def handle_eos(self):
        self._pending.clear()
        self._frame_acc.clear()


MEDIA_DEFAULT = "application/octet-stream"
