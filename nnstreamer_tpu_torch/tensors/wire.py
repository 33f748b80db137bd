"""Reference wire-format contract shared by the serialization codecs
(protobuf / flexbuf / flatbuf).

Single source of truth for the cross-framework constraints every
reference-compatible codec inherits:

- the reference ``tensor_type`` enum order (tensor_typedef.h:154-166):
  ``_NNS_INT32=0 … _NNS_UINT64=9`` then ``_NNS_END`` — 10 values, no
  fp16/bf16;
- the reference ``tensor_format`` order (tensor_typedef.h:201-208):
  static=0 / flexible=1 / sparse=2;
- ``NNS_TENSOR_RANK_LIMIT == 4`` (tensor_typedef.h:34): exactly four
  dimension entries on the wire, 1-padded, innermost-first;
- ``NNS_TENSOR_SIZE_LIMIT == 16`` (tensor_typedef.h:35).

A copy of the JAX package's module, plus :func:`require`: the codecs
import their serialization package at first use, so the port and each of
its modules import without ``flatbuffers`` or ``protobuf`` installed.
"""

from __future__ import annotations

import importlib
from typing import List, Optional, Tuple

from nnstreamer_tpu_torch.tensors.types import (
    Fraction,
    TensorFormat,
    TensorInfo,
    TensorType,
)

TYPE_ORDER = list(TensorType)
REF_TYPE_COUNT = 10
FORMAT_ORDER = list(TensorFormat)
REF_RANK = 4
REF_SIZE_LIMIT = 16


def ref_type_index(info: TensorInfo, codec: str, alt: str) -> int:
    """Reference enum value for a tensor's dtype, or a pointed refusal
    when the reference enum has no such value (fp16/bf16)."""
    idx = TYPE_ORDER.index(info.type)
    if idx >= REF_TYPE_COUNT:
        raise ValueError(
            f"{codec} codec: {info.type.value} has no value in the "
            "reference tensor_type enum (tensor_typedef.h:154-166); "
            f"typecast first or use {alt}")
    return idx


def ref_type_from_index(idx: int, codec: str) -> TensorType:
    if not 0 <= idx < REF_TYPE_COUNT:
        raise ValueError(f"{codec} codec: unknown tensor_type value {idx}")
    return TYPE_ORDER[idx]


def ref_dims(info: TensorInfo, codec: str, alt: str) -> List[int]:
    """Wire dimension list: exactly REF_RANK entries, 1-padded,
    innermost-first (the reference's dimension-array convention)."""
    if len(info.dim) > REF_RANK:
        raise ValueError(
            f"{codec} codec: rank {len(info.dim)} exceeds the reference "
            f"wire rank {REF_RANK}; use {alt} for higher-rank tensors")
    return list(info.dim) + [1] * (REF_RANK - len(info.dim))


def ref_format_index(fmt) -> int:
    return FORMAT_ORDER.index(TensorFormat.from_any(fmt))


def ref_format_from_index(idx: int, codec: str) -> TensorFormat:
    if not 0 <= idx < len(FORMAT_ORDER):
        raise ValueError(f"{codec} codec: unknown tensor_format value {idx}")
    return FORMAT_ORDER[idx]


def rate_pair(rate: Optional[Fraction]) -> Tuple[int, int]:
    """(rate_n, rate_d) from our Fraction or fractions.Fraction; the
    reference writes 0/1 when the framerate is unknown."""
    if rate is None:
        return 0, 1
    n = int(getattr(rate, "num", getattr(rate, "numerator", 0)))
    d = int(getattr(rate, "den", getattr(rate, "denominator", 1))) or 1
    return n, d


def require(module: str, package: str, codec: str):
    """``module``, imported at a codec's first use; without it an
    ``ImportError`` that names the package to install."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{codec} codec needs the {package!r} package, "
                          f"which is not installed ({e})") from e
