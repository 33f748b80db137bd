"""Serializable per-tensor header for flexible/sparse streams and the wire.

The reference prepends a fixed binary header (``GstTensorMetaInfo``,
``gst/nnstreamer/tensor_meta.c`` / ``tensor_typedef.h:272-297``) to every
memory of a flexible or sparse tensor so each buffer is self-describing:
version magic, dtype, dim[rank], format, and for sparse tensors the
number of non-zero elements. We keep the same idea with an explicit
little-endian layout (struct-packed), used by:

- flexible-format streams (``TensorFormat.FLEXIBLE``) where shapes vary
  per buffer and caps carry no dimensions;
- sparse encode/decode (``elements.sparse``);
- the distributed query protocol's tensor framing (``query.protocol``).

The layout ("TMI1", little-endian, 96 bytes) is the framework's own
framing, used by the query protocol and mode=nnstpu-flex; it supports
rank>4 and fp16/bf16::

  u32 magic      0x544D4931 ("TMI1")
  u32 type       TensorType index
  u32 format     TensorFormat index (static=0/flexible=1/sparse=2)
  u32 rank
  u64 dim[8]     innermost-first, unused trailing dims = 1
  u64 media_type reserved (0)
  u64 sparse_nnz nonzero count for sparse payloads, else 0

A copy of the JAX package's module without its reference
``GstTensorMetaInfo`` layout (ROADMAP 26d): the TMI1 header is
byte-identical to the JAX package's. :func:`pack_tensor` also takes a
torch tensor (a CUDA tensor is copied to the host once), and
:func:`unpack_tensor` returns a CPU ``torch.Tensor`` for ``bfloat16``,
which numpy cannot hold.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Tuple

from nnstreamer_tpu_torch.tensors.types import (
    NNS_TENSOR_RANK_LIMIT,
    TensorFormat,
    TensorInfo,
    TensorType,
)

_MAGIC = 0x544D4931
_TYPE_ORDER = list(TensorType)
_FORMAT_ORDER = list(TensorFormat)
_STRUCT = struct.Struct("<IIII8QQQ")

HEADER_SIZE = _STRUCT.size


@dataclasses.dataclass
class TensorMetaInfo:
    """Self-describing tensor header (reference ``GstTensorMetaInfo``)."""

    type: TensorType
    dim: Tuple[int, ...]
    format: TensorFormat = TensorFormat.STATIC
    sparse_nnz: int = 0

    def __post_init__(self):
        self.type = TensorType.from_any(self.type)
        self.format = TensorFormat.from_any(self.format)
        self.dim = tuple(int(d) for d in self.dim)

    @classmethod
    def from_info(cls, info: TensorInfo, format=TensorFormat.FLEXIBLE,
                  sparse_nnz: int = 0) -> "TensorMetaInfo":
        return cls(type=info.type, dim=tuple(info.dim), format=format,
                   sparse_nnz=sparse_nnz)

    def to_info(self) -> TensorInfo:
        return TensorInfo(dim=self.dim, type=self.type)

    # -- wire format ---------------------------------------------------------
    def pack(self) -> bytes:
        dim = list(self.dim[:NNS_TENSOR_RANK_LIMIT])
        dim += [1] * (NNS_TENSOR_RANK_LIMIT - len(dim))
        return _STRUCT.pack(
            _MAGIC,
            _TYPE_ORDER.index(self.type),
            _FORMAT_ORDER.index(self.format),
            len(self.dim),
            *dim,
            0,
            self.sparse_nnz,
        )

    @classmethod
    def unpack(cls, data: bytes) -> "TensorMetaInfo":
        if len(data) < HEADER_SIZE:
            raise ValueError(f"header too short: {len(data)} < {HEADER_SIZE}")
        fields = _STRUCT.unpack_from(data)
        magic, type_i, fmt_i, rank = fields[0], fields[1], fields[2], fields[3]
        if magic != _MAGIC:
            raise ValueError(f"bad tensor header magic: {magic:#x}")
        if rank < 1 or rank > NNS_TENSOR_RANK_LIMIT:
            raise ValueError(f"bad rank {rank}")
        if type_i >= len(_TYPE_ORDER):
            raise ValueError(f"bad tensor type index {type_i}")
        if fmt_i >= len(_FORMAT_ORDER):
            raise ValueError(f"bad tensor format index {fmt_i}")
        dim = tuple(int(d) for d in fields[4:4 + rank])
        return cls(
            type=_TYPE_ORDER[type_i],
            dim=dim,
            format=_FORMAT_ORDER[fmt_i],
            sparse_nnz=int(fields[13]),
        )

    @property
    def data_size(self) -> int:
        """Byte size of the dense payload this header describes."""
        return self.to_info().size


def parse_header(data: bytes, offset: int = 0):
    """Parse the TMI1 header at ``offset``; returns
    ``(TensorMetaInfo, header_size)``."""
    return (TensorMetaInfo.unpack(data[offset:offset + HEADER_SIZE]),
            HEADER_SIZE)


def _host_bytes(arr) -> Tuple[TensorInfo, bytes]:
    """Info and raw bytes of a numpy array or a torch tensor (on any
    device: a device tensor is copied to the host once)."""
    import numpy as np
    import torch

    if isinstance(arr, torch.Tensor):
        t = arr.detach().contiguous().cpu()
        return (TensorInfo.from_array(t),
                t.reshape(-1).view(torch.uint8).numpy().tobytes())
    arr = np.ascontiguousarray(np.asarray(arr))
    return TensorInfo.from_array(arr), arr.tobytes()


def pack_tensor(arr, format=TensorFormat.FLEXIBLE) -> bytes:
    """Serialize one tensor as TMI1 header + raw bytes (host-side)."""
    info, raw = _host_bytes(arr)
    return TensorMetaInfo.from_info(info, format=format).pack() + raw


def unpack_tensor(data: bytes, offset: int = 0):
    """Parse header + payload at ``offset``; returns (array, next_offset).
    A ``bfloat16`` payload comes back as a CPU torch tensor."""
    import numpy as np

    meta, hsize = parse_header(data, offset)
    start = offset + hsize
    end = start + meta.data_size
    if len(data) < end:
        raise ValueError("truncated tensor payload")
    shape = meta.to_info().shape
    if meta.type is TensorType.BFLOAT16:
        import torch

        out = torch.empty(shape, dtype=torch.bfloat16)
        if end > start:
            out.reshape(-1).view(torch.uint8).copy_(
                torch.frombuffer(bytearray(data[start:end]),
                                 dtype=torch.uint8))
        return out, end
    arr = np.frombuffer(data[start:end], dtype=meta.type.np_dtype).reshape(
        shape
    )
    return arr, end
