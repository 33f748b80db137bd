"""flatbuf decoder/codec — tensors ↔ FlatBuffers ``Tensors`` tables.

Reference: ``ext/nnstreamer/tensor_decoder/tensordec-flatbuf.cc`` (211 LoC)
/ ``tensor_converter_flatbuf.cc`` (168 LoC) with the schema from
``ext/nnstreamer/include/nnstreamer.fbs``:

    table Tensor  { name:string; type:Tensor_type = NNS_END;
                    dimension:[uint32]; data:[ubyte]; }
    table Tensors { num_tensor:int; fr:frame_rate(struct);
                    tensor:[Tensor]; format:Tensor_format; }

Built directly with the ``flatbuffers`` runtime Builder/Table APIs — no
flatc-generated code is shipped; slot numbers follow schema declaration
order (field n ↦ vtable offset 4+2n). ``tests/test_codecs.py`` cross-
checks the slot ids, enum order, and defaults against the reference's
own ``.fbs`` text (and against flatc-generated accessors when flatc is
installed).

Invariants a reference peer relies on (tensor_converter_flatbuf.cc:
89-125 dereferences them unconditionally): ``fr`` and per-tensor
``name`` are always present, and ``dimension`` has exactly
``NNS_TENSOR_RANK_LIMIT == 4`` entries (tensordec-flatbuf.cc:126 writes
all four; the converter reads all four back). Reference wire
constraints (type enum without fp16/bf16, rank-4 1-padded dims) come
from ``tensors.wire`` like the protobuf/flexbuf codecs.

A copy of the JAX package's module. ``flatbuffers`` is imported at first
use (the JAX module imports it with the module): without it the codec
raises an ``ImportError`` naming the package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from nnstreamer_tpu_torch.pipeline.caps import Caps
from nnstreamer_tpu_torch.registry import CONVERTER, DECODER, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensors import wire
from nnstreamer_tpu_torch.tensors.types import (
    Fraction,
    TensorFormat,
    TensorInfo,
)

#: schema default for Tensor.type is NNS_END (nnstreamer.fbs:41) — the
#: value right past the last real dtype, i.e. "absent/invalid".
_TYPE_DEFAULT = wire.REF_TYPE_COUNT

def _require():
    """(the ``flatbuffers`` module, its ``number_types``), imported at
    first use."""
    return (wire.require("flatbuffers", "flatbuffers", "flatbuf"),
            wire.require("flatbuffers.number_types", "flatbuffers",
                         "flatbuf"))


def encode_flatbuf(buf: TensorBuffer, rate: Optional[Fraction] = None,
                   fmt: TensorFormat = TensorFormat.STATIC) -> bytes:
    """Serialize a frame the way tensordec-flatbuf.cc:115-149 does:
    per-tensor [name ""-defaulted, type, 4 wire dims, data], then the
    root table with fr always present (0/1 when the rate is unknown)."""
    flatbuffers, _N = _require()
    b = flatbuffers.Builder(1024)
    host = buf.to_host()
    names = buf.meta.get("tensor_names") or []
    tensor_offs = []
    for i, t in enumerate(host.tensors):
        info = TensorInfo.from_array(t)
        type_idx = wire.ref_type_index(info, "flatbuf", "mode=nnstpu-flex")
        dims = wire.ref_dims(info, "flatbuf", "mode=nnstpu-flex")
        data_off = b.CreateByteVector(np.ascontiguousarray(t).tobytes())
        b.StartVector(4, len(dims), 4)
        for d in reversed(dims):
            b.PrependUint32(d)
        dim_off = b.EndVector()
        name_off = b.CreateString(str(names[i])
                                  if i < len(names) and names[i] else "")
        b.StartObject(4)
        b.PrependUOffsetTRelativeSlot(0, name_off, 0)
        b.PrependInt32Slot(1, type_idx, _TYPE_DEFAULT)
        b.PrependUOffsetTRelativeSlot(2, dim_off, 0)
        b.PrependUOffsetTRelativeSlot(3, data_off, 0)
        tensor_offs.append(b.EndObject())
    b.StartVector(4, len(tensor_offs), 4)
    for off in reversed(tensor_offs):
        b.PrependUOffsetTRelative(off)
    vec_off = b.EndVector()
    rate_n, rate_d = wire.rate_pair(rate)
    b.StartObject(4)
    b.PrependInt32Slot(0, host.num_tensors, 0)
    # frame_rate struct is stored inline in the table and is always
    # present — the reference converter dereferences fr() blindly
    b.Prep(4, 8)
    b.PrependInt32(rate_d)
    b.PrependInt32(rate_n)
    b.PrependStructSlot(1, b.Offset(), 0)
    b.PrependUOffsetTRelativeSlot(2, vec_off, 0)
    b.PrependInt32Slot(3, wire.ref_format_index(fmt), 0)
    b.Finish(b.EndObject())
    return bytes(b.Output())


def decode_flatbuf(blob: bytes) -> TensorBuffer:
    """Parse a reference-format ``Tensors`` flatbuffer the way
    tensor_converter_flatbuf.cc:89-125 does (num_tensor-driven loop,
    4 wire dims kept as rank-4 shapes); framerate / format / names land
    in ``buf.meta``."""
    flatbuffers, _N = _require()
    data = bytearray(blob)
    root = flatbuffers.encode.Get(_N.UOffsetTFlags.packer_type, data, 0)
    tab = flatbuffers.Table(data, root)
    n_off = tab.Offset(4)  # slot 0: num_tensor
    num = tab.Get(_N.Int32Flags, n_off + tab.Pos) if n_off else 0
    if not 0 < num <= wire.REF_SIZE_LIMIT:
        raise ValueError(f"flatbuf codec: num_tensor {num} outside the "
                         f"reference range [1, {wire.REF_SIZE_LIMIT}]")
    f_off = tab.Offset(10)  # slot 3: format
    fmt_idx = tab.Get(_N.Int32Flags, f_off + tab.Pos) if f_off else 0
    fmt = wire.ref_format_from_index(fmt_idx, "flatbuf")
    meta = {"format": fmt.value}
    fr_off = tab.Offset(6)  # slot 1: frame_rate struct (inline)
    if fr_off:
        rate_n = tab.Get(_N.Int32Flags, fr_off + tab.Pos)
        rate_d = tab.Get(_N.Int32Flags, fr_off + tab.Pos + 4)
        if rate_n:
            meta["framerate"] = Fraction(rate_n, rate_d or 1)
    tensors, names = [], []
    vec = tab.Offset(8)  # slot 2: tensor vector
    if not vec or tab.VectorLen(vec) < num:
        raise ValueError("flatbuf codec: tensor vector shorter than "
                         "num_tensor")
    base = tab.Vector(vec)
    for i in range(num):
        sub_pos = tab.Indirect(base + i * 4)
        sub = flatbuffers.Table(data, sub_pos)
        name_off = sub.Offset(4)  # slot 0: name
        name = sub.String(name_off + sub.Pos).decode() if name_off else ""
        t_off = sub.Offset(6)  # slot 1: type
        # an absent field means the schema default NNS_END — invalid,
        # same as any other out-of-range value
        type_idx = sub.Get(_N.Int32Flags, t_off + sub.Pos) if t_off \
            else _TYPE_DEFAULT
        ttype = wire.ref_type_from_index(type_idx, "flatbuf")
        d_off = sub.Offset(8)  # slot 2: dimension
        dims = []
        if d_off:
            dn = sub.VectorLen(d_off)
            dbase = sub.Vector(d_off)
            dims = [sub.Get(_N.Uint32Flags, dbase + j * 4)
                    for j in range(dn)]
        b_off = sub.Offset(10)  # slot 3: data
        if b_off:
            start = sub.Vector(b_off)
            length = sub.VectorLen(b_off)
            raw = bytes(data[start:start + length])
        else:
            raw = b""
        shape = tuple(reversed(dims))
        tensors.append(np.frombuffer(raw, ttype.np_dtype).reshape(shape))
        names.append(name or None)
    if any(names):
        meta["tensor_names"] = names
    return TensorBuffer(tensors, meta=meta)


@subplugin(DECODER, "flatbuf")
class FlatbufDecoder:
    """tensors → serialized flatbuffer (other/flatbuf-tensor stream)."""

    def out_caps(self, config, options) -> Caps:
        return Caps("other/flatbuf-tensor")

    def decode(self, buf: TensorBuffer, config, options) -> TensorBuffer:
        rate = config.rate if config is not None and config.rate.num else None
        fmt = config.format if config is not None else TensorFormat.STATIC
        blob = encode_flatbuf(buf, rate=rate, fmt=fmt)
        return buf.with_tensors(
            [np.frombuffer(blob, np.uint8)])


@subplugin(CONVERTER, "flatbuf")
class FlatbufConverter:
    """serialized flatbuffer stream → other/tensors."""

    def get_out_config(self, caps):
        return None

    def convert(self, buf: TensorBuffer, in_caps) -> TensorBuffer:
        blob = np.ascontiguousarray(buf.to_host()[0]).tobytes()
        out = decode_flatbuf(blob)
        return out.replace(pts=buf.pts, meta={**out.meta, **buf.meta})
