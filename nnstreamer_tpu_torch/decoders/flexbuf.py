"""flexbuf decoder — tensors → FlexBuffers byte stream (reference wire
format).

Reference: ``ext/nnstreamer/tensor_decoder/tensordec-flexbuf.cc:26-35``
documents the layout and :138-167 builds it::

    Map {
      "num_tensors" : UInt   | number of tensors
      "rate_n"      : Int    | framerate numerator
      "rate_d"      : Int    | framerate denominator
      "format"      : Int    | tensor_format (static=0/flexible=1/sparse=2)
      "tensor_#"    : Vector | [ name   : String,
                                 type   : Int  (reference tensor_type enum),
                                 dim    : TypedVector of
                                          NNS_TENSOR_RANK_LIMIT(=4) ints,
                                 data   : Blob ]
    }

``encode_flexbuf``/``decode_flexbuf`` speak exactly that, via
``flatbuffers.flexbuffers`` — a reference flexbuf peer
(tensor_converter mode=flexbuf / tensor_decoder mode=flexbuf) can
exchange streams with us; ``tests/test_codecs.py`` cross-proves it the
way the protobuf suite does.

Wire constraints inherited from the reference (same as the protobuf
codec): exactly 4 dimension entries, 1-padded, innermost-first
(tensor_converter_flexbuf.cc:131-134 reads exactly
NNS_TENSOR_RANK_LIMIT back); the reference tensor_type enum
(tensor_typedef.h:154-166) has no fp16/bf16, so those are refused.

The framework's own compact framing (u32 count, i64 pts, per-tensor
flex header + payload — supports rank>4, fp16/bf16, and carries pts) is
kept under mode ``nnstpu-flex``; the query protocol and gRPC bridge
ride it (``encode_flex``/``decode_flex``).

A copy of the JAX package's module. ``flatbuffers`` is imported at first
use; without it the codec raises an ``ImportError`` naming the package.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from nnstreamer_tpu_torch.pipeline.caps import Caps
from nnstreamer_tpu_torch.registry import DECODER, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensors.meta import pack_tensor, unpack_tensor
from nnstreamer_tpu_torch.tensors.types import (
    Fraction,
    TensorFormat,
    TensorInfo,
)
from nnstreamer_tpu_torch.tensors import wire


def encode_flexbuf(buf: TensorBuffer, rate: Optional[Fraction] = None,
                   fmt: TensorFormat = TensorFormat.STATIC) -> bytes:
    """Serialize a frame the way tensordec-flexbuf.cc:138-168 does —
    same map keys, same per-tensor vector slot order, 4 dims 1-padded."""
    flexbuffers = wire.require("flatbuffers.flexbuffers", "flatbuffers",
                               "flexbuf")

    host = buf.to_host()
    names = buf.meta.get("tensor_names") or []
    rate_n, rate_d = wire.rate_pair(rate)
    fbb = flexbuffers.Builder()
    with fbb.Map():
        fbb.Key("num_tensors")
        fbb.UInt(host.num_tensors)
        fbb.Key("rate_n")
        fbb.Int(rate_n)
        fbb.Key("rate_d")
        fbb.Int(rate_d)
        fbb.Key("format")
        fbb.Int(wire.ref_format_index(fmt))
        for i, t in enumerate(host.tensors):
            info = TensorInfo.from_array(t)
            type_idx = wire.ref_type_index(info, "flexbuf",
                                           "mode=nnstpu-flex")
            dims = wire.ref_dims(info, "flexbuf", "mode=nnstpu-flex")
            fbb.Key(f"tensor_{i}")
            with fbb.Vector():
                fbb.String(str(names[i])
                           if i < len(names) and names[i] else "")
                fbb.Int(type_idx)
                fbb.TypedVectorFromElements(dims)
                fbb.Blob(np.ascontiguousarray(t).tobytes())
    return bytes(fbb.Finish())


def decode_flexbuf(blob: bytes) -> TensorBuffer:
    """Parse a reference-format flexbuf payload the way
    tensor_converter_flexbuf.cc:107-141 does. Shapes keep the rank-4
    wire dims; framerate / format / tensor names land in ``buf.meta``."""
    flexbuffers = wire.require("flatbuffers.flexbuffers", "flatbuffers",
                               "flexbuf")

    root = flexbuffers.GetRoot(bytes(blob))
    if not root.IsMap:
        raise ValueError("flexbuf codec: payload root is not a map")
    m = root.AsMap
    num = m["num_tensors"].AsInt
    if not 0 < num <= wire.REF_SIZE_LIMIT:
        raise ValueError(f"flexbuf codec: num_tensors {num} outside the "
                         f"reference range [1, {wire.REF_SIZE_LIMIT}]")
    rate_n = m["rate_n"].AsInt
    rate_d = m["rate_d"].AsInt
    fmt = wire.ref_format_from_index(m["format"].AsInt, "flexbuf")
    tensors, names = [], []
    for i in range(num):
        vec = m[f"tensor_{i}"].AsVector
        name = vec[0].AsString
        ttype = wire.ref_type_from_index(vec[1].AsInt, "flexbuf")
        dims = [d.AsInt for d in vec[2].AsTypedVector]
        data = bytes(vec[3].AsBlob)
        shape = tuple(reversed(dims))
        tensors.append(np.frombuffer(data, ttype.np_dtype).reshape(shape))
        names.append(name or None)
    meta = {"format": fmt.value}
    if rate_n:
        meta["framerate"] = Fraction(rate_n, rate_d or 1)
    if any(names):
        meta["tensor_names"] = names
    return TensorBuffer(tensors, meta=meta)


# ---------------------------------------------------------------------------
# Framework-native compact framing ("nnstpu-flex")
# ---------------------------------------------------------------------------

_HDR = struct.Struct("<Iq")


def encode_flex(buf: TensorBuffer) -> bytes:
    """Framework-native framing: u32 num_tensors, i64 pts, then
    per-tensor flex header (``tensors.meta``) + payload. Unlike the
    reference flexbuf format it carries pts and supports rank>4 and
    fp16/bf16 — the query protocol and gRPC bridge use it."""
    host = buf.to_host()
    parts = [_HDR.pack(host.num_tensors,
                       -1 if buf.pts is None else buf.pts)]
    parts += [pack_tensor(t) for t in host.tensors]
    return b"".join(parts)


def decode_flex(blob: bytes) -> TensorBuffer:
    n, pts = _HDR.unpack_from(blob)
    offset = _HDR.size
    tensors = []
    for _ in range(n):
        arr, offset = unpack_tensor(blob, offset)
        tensors.append(arr)
    return TensorBuffer(tensors, pts=None if pts < 0 else pts)


@subplugin(DECODER, "flexbuf")
class FlexBufDecoder:
    """tensors → reference-format FlexBuffers byte stream."""

    def out_caps(self, config, options) -> Caps:
        return Caps("application/octet-stream", {"encoding": "flexbuf"})

    def decode(self, buf: TensorBuffer, config, options) -> TensorBuffer:
        rate = config.rate if config is not None and config.rate.num else None
        fmt = config.format if config is not None else TensorFormat.STATIC
        blob = encode_flexbuf(buf, rate=rate, fmt=fmt)
        return buf.with_tensors([np.frombuffer(blob, np.uint8)])


@subplugin(DECODER, "nnstpu-flex")
class NnstpuFlexDecoder:
    """tensors → framework-native compact flex framing."""

    def out_caps(self, config, options) -> Caps:
        return Caps("application/octet-stream", {"encoding": "nnstpu-flex"})

    def decode(self, buf: TensorBuffer, config, options) -> TensorBuffer:
        blob = encode_flex(buf)
        return buf.with_tensors([np.frombuffer(blob, np.uint8)])
