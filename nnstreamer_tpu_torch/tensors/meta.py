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

Two selectable wire layouts:

**native** ("TMI1", little-endian, 96 bytes) — the framework's own
framing, used by the query protocol and mode=nnstpu-flex; supports
rank>4 and fp16/bf16::

  u32 magic      0x544D4931 ("TMI1")
  u32 type       TensorType index
  u32 format     TensorFormat index (static=0/flexible=1/sparse=2)
  u32 rank
  u64 dim[8]     innermost-first, unused trailing dims = 1
  u64 media_type reserved (0)
  u64 sparse_nnz nonzero count for sparse payloads, else 0

**reference** — the byte-exact ``GstTensorMetaInfo`` v1 header
(tensor_typedef.h:283-297, packed/parsed by tensor_common.c:1669-1723):
128 bytes of little-endian u32s, interoperable with reference
flexible/sparse pipelines::

  u32 version    0xDE001000  (GST_TENSOR_META_MAKE_VERSION(1,0))
  u32 type       reference tensor_type enum (no fp16/bf16)
  u32 dim[16]    innermost-first, rank-terminated by 0
  u32 format     static=0 / flexible=1 / sparse=2
  u32 media_type _NNS_TENSOR = 4
  u32 nnz        sparse non-zero count (union member; 0 otherwise)
  ...zero-padded to 128 bytes (gst_tensor_meta_info_get_header_size)

``parse_header`` sniffs which layout a buffer carries (the reference
version word always has the 0xDE magic in its top byte; TMI1's magic
differs), so decode paths accept both.

A copy of the JAX package's module; both layouts are byte-identical to
the JAX package's. :func:`pack_tensor` also takes a torch tensor (a CUDA
tensor is copied to the host once), and :func:`unpack_tensor` returns a
CPU ``torch.Tensor`` for ``bfloat16``, which numpy cannot hold.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Tuple

from nnstreamer_tpu_torch.tensors import wire
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

#: reference GstTensorMetaInfo v1 constants (tensor_common.c:1510-1525)
REF_META_VERSION = 0xDE001000  # GST_TENSOR_META_MAKE_VERSION(1, 0)
REF_META_VERSION_MASK = 0xDE000000
REF_META_RANK_LIMIT = 16  # NNS_TENSOR_META_RANK_LIMIT (tensor_typedef.h:44)
REF_HEADER_SIZE = 128  # gst_tensor_meta_info_get_header_size, v1
_REF_MEDIA_TENSOR = 4  # _NNS_TENSOR (tensor_typedef.h:185)
_REF_STRUCT = struct.Struct("<21I")  # version,type,dim[16],format,media,nnz


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

    # -- reference GstTensorMetaInfo wire format ----------------------------
    def pack_ref(self) -> bytes:
        """Byte-exact ``GstTensorMetaInfo`` v1 header (128 B) the way
        gst_tensor_meta_info_update_header (tensor_common.c:1669-1684)
        memcpys the struct: version, type, dim[16] rank-terminated by
        zero, format, media_type, nnz, zero-padded."""
        type_idx = wire.ref_type_index(self.to_info(), "meta",
                                       "the native TMI1 layout")
        if len(self.dim) > REF_META_RANK_LIMIT:
            raise ValueError(f"meta: rank {len(self.dim)} exceeds the "
                             f"reference limit {REF_META_RANK_LIMIT}")
        if any(d <= 0 for d in self.dim):
            raise ValueError(f"meta: invalid dimension {self.dim}")
        dims = list(self.dim) + [0] * (REF_META_RANK_LIMIT - len(self.dim))
        hdr = _REF_STRUCT.pack(
            REF_META_VERSION,
            type_idx,
            *dims,
            wire.ref_format_index(self.format),
            _REF_MEDIA_TENSOR,
            self.sparse_nnz,
        )
        return hdr + b"\x00" * (REF_HEADER_SIZE - len(hdr))

    @classmethod
    def unpack_ref(cls, data: bytes) -> "TensorMetaInfo":
        """Parse a reference v1 header the way
        gst_tensor_meta_info_parse_header (tensor_common.c:1691-1723)
        does, with its validate() checks."""
        if len(data) < REF_HEADER_SIZE:
            raise ValueError(
                f"header too short: {len(data)} < {REF_HEADER_SIZE}")
        fields = _REF_STRUCT.unpack_from(data)
        version = fields[0]
        if (version & REF_META_VERSION_MASK) != REF_META_VERSION_MASK:
            raise ValueError(f"bad GstTensorMetaInfo version {version:#x}")
        ttype = wire.ref_type_from_index(fields[1], "meta")
        dims = []
        for d in fields[2:2 + REF_META_RANK_LIMIT]:
            if d == 0:
                break
            dims.append(int(d))
        if not dims:
            raise ValueError("GstTensorMetaInfo header with empty dimension")
        if len(dims) > NNS_TENSOR_RANK_LIMIT:
            raise ValueError(
                f"GstTensorMetaInfo header with rank {len(dims)}: the "
                f"reference wire allows up to {REF_META_RANK_LIMIT} but "
                f"this framework handles rank ≤ {NNS_TENSOR_RANK_LIMIT}")
        fmt = wire.ref_format_from_index(fields[18], "meta")
        if fields[19] > _REF_MEDIA_TENSOR:
            raise ValueError(f"bad media_type {fields[19]}")
        nnz = fields[20] if fmt is TensorFormat.SPARSE else 0
        return cls(type=ttype, dim=tuple(dims), format=fmt, sparse_nnz=nnz)

    @property
    def data_size(self) -> int:
        """Byte size of the dense payload this header describes."""
        return self.to_info().size


def is_ref_header(data: bytes, offset: int = 0) -> bool:
    """True when ``data[offset:]`` starts with a reference
    ``GstTensorMetaInfo`` header (0xDE version magic in the first word;
    the native TMI1 magic never matches it)."""
    if len(data) < offset + 4:
        return False
    (word,) = struct.unpack_from("<I", data, offset)
    return (word & REF_META_VERSION_MASK) == REF_META_VERSION_MASK


def parse_header(data: bytes, offset: int = 0):
    """Sniff the header layout at ``offset``; returns
    ``(TensorMetaInfo, header_size)``."""
    if is_ref_header(data, offset):
        return (TensorMetaInfo.unpack_ref(
            data[offset:offset + REF_HEADER_SIZE]), REF_HEADER_SIZE)
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


def pack_tensor(arr, format=TensorFormat.FLEXIBLE,
                layout: str = "native") -> bytes:
    """Serialize one tensor as header + raw bytes (host-side).
    ``layout="reference"`` emits the ``GstTensorMetaInfo`` byte layout a
    reference flexible-stream peer parses; ``"native"`` the TMI1 one."""
    if layout not in ("reference", "native"):
        raise ValueError(f"pack_tensor: unknown layout {layout!r} "
                         "(reference|native)")
    info, raw = _host_bytes(arr)
    meta = TensorMetaInfo.from_info(info, format=format)
    return (meta.pack_ref() if layout == "reference" else meta.pack()) + raw


def unpack_tensor(data: bytes, offset: int = 0):
    """Parse header + payload at ``offset``; returns (array, next_offset).
    Accepts both the native and the reference header layouts. A
    ``bfloat16`` payload comes back as a CPU torch tensor."""
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
