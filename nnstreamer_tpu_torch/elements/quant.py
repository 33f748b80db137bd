"""tensor_quant_enc / tensor_quant_dec — int8 stream transcoding.

The dense-activation peer of the sparse pair: where ``tensor_sparse_enc``
saves bandwidth on mostly-zero tensors (reference
``gsttensorsparseenc.c``), this pair ships DENSE float tensors as
per-tensor absmax int8 (+ float32 scale) — 4× fewer bytes over the query
transport.

Wire layout per tensor: TensorMetaInfo header carrying the ORIGINAL
dtype/dims (format=flexible), then u32 magic 'NQT1' (discriminates quant
blobs from other flexible payloads), float32 scale, int8[num_elements].

A host payload is encoded by the JAX package's numpy code. A CUDA payload
is quantized on the card by kernel B3 in its nearest mode
(``ops/quantize.py``), and only the int8 values and the scale cross to the
host; the blob is byte-identical to the host encoding of the same values
(for a NaN in the input, the scale is the default quiet NaN 0x7fc00000,
which the host writes for ``np.nan``; another NaN payload the host keeps).
Decoding runs on the host, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from nnstreamer_tpu_torch.ops.quantize import quantize_int8
from nnstreamer_tpu_torch.pipeline.element import Element
from nnstreamer_tpu_torch.registry import ELEMENT, subplugin
from nnstreamer_tpu_torch.tensors.buffer import host_array, is_device_array
from nnstreamer_tpu_torch.tensors.meta import HEADER_SIZE, TensorMetaInfo
from nnstreamer_tpu_torch.tensors.types import (
    TensorFormat,
    TensorInfo,
    TensorsConfig,
    TensorType,
)

#: discriminates quant blobs from other flexible-format payloads
_QUANT_MAGIC = b"NQT1"


def _header(arr) -> bytes:
    meta = TensorMetaInfo.from_info(
        TensorInfo.from_array(arr), format=TensorFormat.FLEXIBLE)
    return meta.pack() + _QUANT_MAGIC


def _encode_device(t: torch.Tensor) -> bytes:
    q, scale = quantize_int8(t, force="reference")
    hq = torch.empty(q.shape, dtype=torch.int8, pin_memory=True)
    hs = torch.empty(1, dtype=torch.float32, pin_memory=True)
    hq.copy_(q, non_blocking=True)
    hs.copy_(scale, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return _header(t) + hs.numpy().tobytes() + hq.numpy().tobytes()


def quant_encode(arr) -> bytes:
    """One tensor → quant blob. ``arr`` is a numpy array, a CPU tensor or
    a CUDA tensor (quantized on the card)."""
    if is_device_array(arr):
        return _encode_device(arr)
    arr = host_array(arr)
    if isinstance(arr, torch.Tensor):  # bfloat16 on the host
        xf = arr.to(torch.float32).numpy()
    else:
        arr = np.ascontiguousarray(np.asarray(arr))
        xf = arr.astype(np.float32)
    scale = float(np.max(np.abs(xf))) / 127.0 if xf.size else 0.0
    scale = max(scale, 1e-30)
    q = np.clip(np.round(xf / scale), -127, 127).astype(np.int8)
    return _header(arr) + np.float32(scale).tobytes() + q.tobytes()


def quant_decode(blob: bytes, offset: int = 0):
    """Quant blob at ``offset`` → ``(array, next_offset)``: a numpy array
    of the original dtype and shape, or a CPU tensor for ``bfloat16``."""
    meta = TensorMetaInfo.unpack(blob[offset:offset + HEADER_SIZE])
    info = meta.to_info()
    p = offset + HEADER_SIZE
    if blob[p:p + 4] != _QUANT_MAGIC:
        raise ValueError("quant_decode: not a quant payload (bad magic)")
    p += 4
    need = p + 4 + info.num_elements
    if len(blob) < need:
        raise ValueError(
            f"quant_decode: truncated payload ({len(blob)} < {need} bytes)")
    scale = np.frombuffer(blob[p:p + 4], np.float32)[0]
    p += 4
    q = np.frombuffer(blob[p:p + info.num_elements], np.int8)
    p += info.num_elements
    xf = q.astype(np.float32) * scale
    if info.type is TensorType.BFLOAT16:
        return torch.from_numpy(xf).to(torch.bfloat16).reshape(info.shape), p
    dt = info.type.np_dtype
    if np.dtype(dt).kind in "iu":
        xf = np.rint(xf)  # nearest, not truncate-toward-zero
    return xf.astype(dt).reshape(info.shape), p


@subplugin(ELEMENT, "tensor_quant_enc")
class TensorQuantEnc(Element):
    ELEMENT_NAME = "tensor_quant_enc"
    #: a CUDA payload is quantized where it lies; only int8 leaves the card
    DEVICE_PASSTHROUGH = True

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.add_src_pad("src")

    def transform_caps(self, pad, caps):
        return TensorsConfig(format=TensorFormat.FLEXIBLE).to_caps()

    def chain(self, pad, buf):
        blobs = [np.frombuffer(quant_encode(t), np.uint8)
                 for t in buf.tensors]
        return self.srcpad.push(buf.with_tensors(blobs))


@subplugin(ELEMENT, "tensor_quant_dec")
class TensorQuantDec(Element):
    ELEMENT_NAME = "tensor_quant_dec"

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.add_src_pad("src")

    def transform_caps(self, pad, caps):
        return None  # static caps derive from the first decoded frame

    def chain(self, pad, buf):
        host = buf.to_host()
        outs = []
        for t in host.tensors:
            dense, _ = quant_decode(
                np.ascontiguousarray(host_array(t)).tobytes())
            outs.append(dense)
        if self.srcpad.caps is None:
            self.srcpad.set_caps(TensorsConfig.from_arrays(outs).to_caps())
        return self.srcpad.push(host.with_tensors(outs))
