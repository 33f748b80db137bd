"""protobuf decoder — tensors → serialized protobuf messages.

Reference: ``ext/nnstreamer/extra/nnstreamer_protobuf.cc`` with the
``Tensors`` message from ``ext/nnstreamer/include/nnstreamer.proto:26-41``.
The message classes are built dynamically with ``google.protobuf``
(descriptor_pb2) so no generated code is shipped, but the schema is
**byte-for-byte wire compatible** with the reference's::

    message Tensor  { string name=1; Tensor_type type=2;
                      repeated uint32 dimension=3; bytes data=4; }
    message Tensors { uint32 num_tensor=1; frame_rate fr=2
                      {int32 rate_n=1; int32 rate_d=2};
                      repeated Tensor tensor=3; Tensor_format format=4; }

(enums ride as varints, so declaring them int32 here is wire-identical;
``tests/test_codecs.py`` proves both directions against pb2 code protoc
generates from the reference's own .proto.)

Wire-format constraints inherited from the reference:

- **rank-4 normalizing**: the reference writes exactly
  ``NNS_TENSOR_RANK_LIMIT == 4`` dimension entries, 1-padded
  (nnstreamer_protobuf.cc:95-97, tensor_common.c:1294-1295), and its
  parser reads exactly 4 back — so decode yields rank-4 shapes (leading
  1-axes), and rank>4 tensors are refused (a reference peer would
  silently mis-size them; use flexbuf for rank>4).
- the reference ``Tensor_type`` enum has no fp16/bf16 — those are
  refused with a pointed error (typecast first).

A copy of the JAX package's module. ``google.protobuf`` is imported at
first use; without it the codec raises an ``ImportError`` naming the
package.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from nnstreamer_tpu_torch.pipeline.caps import Caps
from nnstreamer_tpu_torch.registry import DECODER, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensors.types import (
    Fraction,
    TensorFormat,
    TensorInfo,
)
from nnstreamer_tpu_torch.tensors import wire

_lock = threading.Lock()
_msgs = None


def _get_messages():
    """Build Tensor/Tensors message classes once (dynamic descriptor)."""
    global _msgs
    with _lock:
        if _msgs is not None:
            return _msgs
        descriptor_pb2 = wire.require("google.protobuf.descriptor_pb2",
                                      "protobuf", "protobuf")
        descriptor_pool = wire.require("google.protobuf.descriptor_pool",
                                       "protobuf", "protobuf")
        message_factory = wire.require("google.protobuf.message_factory",
                                       "protobuf", "protobuf")

        fdp = descriptor_pb2.FileDescriptorProto()
        fdp.name = "nnstreamer_tpu_tensors.proto"
        fdp.package = "nnstreamer.protobuf"
        fdp.syntax = "proto3"
        t = fdp.message_type.add()
        t.name = "Tensor"
        f = t.field.add(); f.name = "name"; f.number = 1; \
            f.type = f.TYPE_STRING; f.label = f.LABEL_OPTIONAL
        f = t.field.add(); f.name = "type"; f.number = 2; \
            f.type = f.TYPE_INT32; f.label = f.LABEL_OPTIONAL
        f = t.field.add(); f.name = "dimension"; f.number = 3; \
            f.type = f.TYPE_UINT32; f.label = f.LABEL_REPEATED
        f = t.field.add(); f.name = "data"; f.number = 4; \
            f.type = f.TYPE_BYTES; f.label = f.LABEL_OPTIONAL
        ts = fdp.message_type.add()
        ts.name = "Tensors"
        fr = ts.nested_type.add()
        fr.name = "frame_rate"
        f = fr.field.add(); f.name = "rate_n"; f.number = 1; \
            f.type = f.TYPE_INT32; f.label = f.LABEL_OPTIONAL
        f = fr.field.add(); f.name = "rate_d"; f.number = 2; \
            f.type = f.TYPE_INT32; f.label = f.LABEL_OPTIONAL
        f = ts.field.add(); f.name = "num_tensor"; f.number = 1; \
            f.type = f.TYPE_UINT32; f.label = f.LABEL_OPTIONAL
        f = ts.field.add(); f.name = "fr"; f.number = 2; \
            f.type = f.TYPE_MESSAGE; f.label = f.LABEL_OPTIONAL; \
            f.type_name = ".nnstreamer.protobuf.Tensors.frame_rate"
        f = ts.field.add(); f.name = "tensor"; f.number = 3; \
            f.type = f.TYPE_MESSAGE; f.label = f.LABEL_REPEATED; \
            f.type_name = ".nnstreamer.protobuf.Tensor"
        f = ts.field.add(); f.name = "format"; f.number = 4; \
            f.type = f.TYPE_INT32; f.label = f.LABEL_OPTIONAL
        pool = descriptor_pool.DescriptorPool()
        fd = pool.Add(fdp)
        tensor_cls = message_factory.GetMessageClass(
            fd.message_types_by_name["Tensor"])
        tensors_cls = message_factory.GetMessageClass(
            fd.message_types_by_name["Tensors"])
        _msgs = (tensor_cls, tensors_cls)
        return _msgs


def encode_protobuf(buf: TensorBuffer, rate: Optional[Fraction] = None,
                    fmt: TensorFormat = TensorFormat.STATIC) -> bytes:
    """Serialize a frame the way nnstreamer_protobuf.cc:44-130 does:
    ``fr`` always present (rate 0/1 when unknown), exactly 4 dimension
    entries per tensor, 1-padded."""
    Tensor, Tensors = _get_messages()
    msg = Tensors()
    host = buf.to_host()
    msg.num_tensor = host.num_tensors
    msg.fr.rate_n, msg.fr.rate_d = wire.rate_pair(rate)
    msg.format = wire.ref_format_index(fmt)
    names = buf.meta.get("tensor_names") or []
    for i, t in enumerate(host.tensors):
        info = TensorInfo.from_array(t)
        tm = msg.tensor.add()
        tm.name = str(names[i]) if i < len(names) and names[i] else ""
        tm.type = wire.ref_type_index(info, "protobuf", "mode=nnstpu-flex")
        tm.dimension.extend(wire.ref_dims(info, "protobuf",
                                          "mode=nnstpu-flex"))
        tm.data = np.ascontiguousarray(t).tobytes()
    return msg.SerializeToString()


def decode_protobuf(blob: bytes) -> TensorBuffer:
    """Parse a reference-format ``Tensors`` payload. Shapes keep the
    rank-4 wire dims (like the reference's parser,
    nnstreamer_protobuf.cc:160-176); framerate / format / tensor names
    land in ``buf.meta``."""
    Tensor, Tensors = _get_messages()
    msg = Tensors()
    msg.ParseFromString(bytes(blob))
    tensors = []
    names = []
    for tm in msg.tensor:
        ttype = wire.ref_type_from_index(tm.type, "protobuf")
        shape = tuple(reversed(list(tm.dimension)))
        tensors.append(np.frombuffer(tm.data,
                                     ttype.np_dtype).reshape(shape))
        names.append(tm.name or None)
    meta = {}
    if msg.fr.rate_n:
        meta["framerate"] = Fraction(msg.fr.rate_n, msg.fr.rate_d or 1)
    meta["format"] = wire.ref_format_from_index(msg.format,
                                                "protobuf").value
    if any(names):
        meta["tensor_names"] = names
    return TensorBuffer(tensors, meta=meta)


@subplugin(DECODER, "protobuf")
class ProtobufDecoder:
    def out_caps(self, config, options) -> Caps:
        return Caps("application/octet-stream", {"encoding": "protobuf"})

    def decode(self, buf: TensorBuffer, config, options) -> TensorBuffer:
        rate = config.rate if config is not None and config.rate.num else None
        fmt = config.format if config is not None else TensorFormat.STATIC
        blob = encode_protobuf(buf, rate=rate, fmt=fmt)
        return buf.with_tensors([np.frombuffer(blob, np.uint8)])
