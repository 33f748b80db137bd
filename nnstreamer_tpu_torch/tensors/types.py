"""Tensor type system: dtypes, dimensions, formats, and stream configs.

Capability parity with the reference's tensor type system
(``gst/nnstreamer/include/tensor_typedef.h:153-297`` and the caps/config
helpers in ``gst/nnstreamer/tensor_common.c``), carried over from the JAX
package for the PyTorch runtime:

- the ten reference dtypes plus ``float16``/``bfloat16``; element sizes
  and torch dtypes come from a torch dtype table, so ``bfloat16`` needs no
  numpy extension type;
- per-frame multi-tensor streams (up to ``NNS_TENSOR_SIZE_LIMIT`` tensors);
- three stream formats: ``STATIC`` (shapes fixed by caps), ``FLEXIBLE``
  (per-buffer shapes) and ``SPARSE`` (COO payloads); the port's elements
  negotiate ``STATIC`` streams so far;
- caps-string serialization compatible in spirit with the reference's
  ``other/tensors,num_tensors=..,dimensions=..,types=..`` negotiation
  grammar so pipelines negotiate the same way.

Dimension convention: like the reference, a ``dim`` tuple is innermost-first
(``(C, W, H, N)`` for video), while :meth:`TensorInfo.shape` gives the
row-major numpy/torch shape (``(N, H, W, C)``).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

#: Maximum rank of a single tensor (reference: 4→8→16 over versions; we use 8,
#: which covers every model family in scope and keeps caps strings readable).
NNS_TENSOR_RANK_LIMIT = 8

#: Maximum number of tensors in one stream frame (reference:
#: ``NNS_TENSOR_SIZE_LIMIT == 16``, tensor_typedef.h:38).
NNS_TENSOR_SIZE_LIMIT = 16

#: Caps media-type names (reference: ``other/tensor`` / ``other/tensors``).
MEDIA_TENSOR = "other/tensor"
MEDIA_TENSORS = "other/tensors"


class TensorType(enum.Enum):
    """Element dtype of a tensor (reference ``tensor_type``,
    tensor_typedef.h:153-168, plus the half types)."""

    INT32 = "int32"
    UINT32 = "uint32"
    INT16 = "int16"
    UINT16 = "uint16"
    INT8 = "int8"
    UINT8 = "uint8"
    FLOAT64 = "float64"
    FLOAT32 = "float32"
    INT64 = "int64"
    UINT64 = "uint64"
    FLOAT16 = "float16"
    BFLOAT16 = "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.value)

    @property
    def np_dtype(self) -> np.dtype:
        """The numpy dtype; ``bfloat16`` has none (use :attr:`torch_dtype`)."""
        if self is TensorType.BFLOAT16:
            raise TypeError("bfloat16 has no numpy dtype in this package; "
                            "use TensorType.torch_dtype")
        return np.dtype(self.value)

    @property
    def size(self) -> int:
        """Bytes per element."""
        return self.torch_dtype.itemsize

    @classmethod
    def from_any(cls, value) -> "TensorType":
        """Coerce a string / torch dtype / numpy dtype / TensorType."""
        if isinstance(value, TensorType):
            return value
        if isinstance(value, str):
            return cls(value.lower())
        if isinstance(value, torch.dtype):
            return cls(str(value).split(".")[-1])
        return cls(np.dtype(value).name)


class TensorFormat(enum.Enum):
    """Stream data format (reference ``tensor_format``,
    tensor_typedef.h:192-199)."""

    STATIC = "static"
    FLEXIBLE = "flexible"
    SPARSE = "sparse"

    @classmethod
    def from_any(cls, value) -> "TensorFormat":
        if isinstance(value, TensorFormat):
            return value
        return cls(str(value).lower())


def _parse_dim(text: str) -> Tuple[int, ...]:
    """Parse ``"3:224:224:1"`` into an innermost-first dim tuple."""
    parts = [p for p in text.strip().split(":") if p != ""]
    if not parts:
        raise ValueError(f"empty dimension string: {text!r}")
    if len(parts) > NNS_TENSOR_RANK_LIMIT:
        raise ValueError(
            f"rank {len(parts)} exceeds limit {NNS_TENSOR_RANK_LIMIT}: {text!r}"
        )
    dim = tuple(int(p) for p in parts)
    if any(d < 1 for d in dim):
        raise ValueError(f"dimensions must be >= 1: {text!r}")
    return dim


def _dim_to_str(dim: Sequence[int]) -> str:
    return ":".join(str(d) for d in dim)


def _trim_dim(dim: Sequence[int]) -> Tuple[int, ...]:
    """Drop trailing 1s (ranks compare equal modulo trailing 1s, like the
    reference's ``gst_tensor_dimension_is_equal``)."""
    dim = tuple(dim)
    while len(dim) > 1 and dim[-1] == 1:
        dim = dim[:-1]
    return dim


@dataclasses.dataclass
class TensorInfo:
    """Shape+dtype (+optional name) of one tensor in a frame.

    Reference: ``GstTensorInfo`` (tensor_typedef.h:239-247).
    """

    dim: Tuple[int, ...] = ()
    type: Optional[TensorType] = None
    name: Optional[str] = None

    def __post_init__(self):
        self.dim = tuple(int(d) for d in self.dim)
        if self.type is not None:
            self.type = TensorType.from_any(self.type)
        if len(self.dim) > NNS_TENSOR_RANK_LIMIT:
            raise ValueError(f"rank {len(self.dim)} exceeds {NNS_TENSOR_RANK_LIMIT}")

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_array(cls, arr, name: Optional[str] = None) -> "TensorInfo":
        """Build from a numpy array or torch tensor: shape is reversed into
        dim order."""
        return cls(
            dim=tuple(reversed(arr.shape)) if arr.ndim else (1,),
            type=TensorType.from_any(arr.dtype),
            name=name,
        )

    @classmethod
    def from_str(cls, dim_str: str, type_str: str, name: Optional[str] = None):
        return cls(dim=_parse_dim(dim_str), type=TensorType(type_str), name=name)

    # -- derived -----------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        """Row-major (numpy/torch) shape — reversed dim order."""
        return tuple(reversed(self.dim))

    @property
    def num_elements(self) -> int:
        return int(math.prod(self.dim)) if self.dim else 0

    @property
    def size(self) -> int:
        """Byte size of one tensor (reference ``gst_tensor_info_get_size``)."""
        if self.type is None or not self.dim:
            return 0
        return self.num_elements * self.type.size

    def is_valid(self) -> bool:
        return self.type is not None and bool(self.dim) and all(
            d >= 1 for d in self.dim
        )

    def is_equal(self, other: "TensorInfo") -> bool:
        """Dim/type equality modulo trailing 1s (names ignored, like the
        reference's ``gst_tensor_info_is_equal``)."""
        return (
            self.type == other.type
            and _trim_dim(self.dim) == _trim_dim(other.dim)
        )

    def dim_str(self) -> str:
        return _dim_to_str(self.dim)

    def __repr__(self):
        t = self.type.value if self.type else "?"
        n = f" name={self.name!r}" if self.name else ""
        return f"TensorInfo({self.dim_str()} {t}{n})"


@dataclasses.dataclass
class TensorsInfo:
    """Info for every tensor in a frame (reference ``GstTensorsInfo``,
    tensor_typedef.h:249-257)."""

    infos: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if len(self.infos) > NNS_TENSOR_SIZE_LIMIT:
            raise ValueError(
                f"{len(self.infos)} tensors exceeds {NNS_TENSOR_SIZE_LIMIT}"
            )

    @classmethod
    def from_arrays(cls, arrays: Iterable) -> "TensorsInfo":
        return cls([TensorInfo.from_array(a) for a in arrays])

    @classmethod
    def from_str(cls, dims: str, types: str, names: str = "") -> "TensorsInfo":
        dim_list = [d for d in dims.split(",") if d.strip()]
        type_list = [t.strip() for t in types.split(",") if t.strip()]
        name_list = [n.strip() for n in names.split(",")] if names else []
        if len(dim_list) != len(type_list):
            raise ValueError(
                f"dimensions/types count mismatch: {dims!r} vs {types!r}"
            )
        out = []
        for i, (d, t) in enumerate(zip(dim_list, type_list)):
            name = name_list[i] if i < len(name_list) and name_list[i] else None
            out.append(TensorInfo.from_str(d, t, name))
        return cls(out)

    # -- container protocol -------------------------------------------------
    def __len__(self):
        return len(self.infos)

    def __getitem__(self, i) -> TensorInfo:
        return self.infos[i]

    def __iter__(self):
        return iter(self.infos)

    def append(self, info: TensorInfo):
        if len(self.infos) >= NNS_TENSOR_SIZE_LIMIT:
            raise ValueError(f"cannot exceed {NNS_TENSOR_SIZE_LIMIT} tensors")
        self.infos.append(info)

    # -- derived ------------------------------------------------------------
    @property
    def num_tensors(self) -> int:
        return len(self.infos)

    def is_valid(self) -> bool:
        return bool(self.infos) and all(i.is_valid() for i in self.infos)

    def is_equal(self, other: "TensorsInfo") -> bool:
        return len(self) == len(other) and all(
            a.is_equal(b) for a, b in zip(self.infos, other.infos)
        )

    def dims_str(self) -> str:
        return ",".join(i.dim_str() for i in self.infos)

    def types_str(self) -> str:
        return ",".join(i.type.value if i.type else "?" for i in self.infos)

    def total_size(self) -> int:
        return sum(i.size for i in self.infos)

    def __repr__(self):
        return f"TensorsInfo([{', '.join(map(repr, self.infos))}])"


@dataclasses.dataclass
class Fraction:
    """Framerate as an exact fraction (reference caps use GstFraction)."""

    num: int = 0
    den: int = 1

    def __post_init__(self):
        if self.den == 0:
            raise ValueError("framerate denominator must be nonzero")
        g = math.gcd(int(self.num), int(self.den)) or 1
        self.num, self.den = int(self.num) // g, int(self.den) // g

    @classmethod
    def parse(cls, text) -> "Fraction":
        if isinstance(text, Fraction):
            return text
        if isinstance(text, (int, float)):
            return cls(int(text), 1)
        if "/" in text:
            n, d = text.split("/", 1)
            return cls(int(n), int(d))
        return cls(int(text), 1)

    @property
    def fps(self) -> float:
        return self.num / self.den if self.den else 0.0

    @property
    def frame_duration_ns(self) -> Optional[int]:
        if self.num <= 0:
            return None
        return int(round(1e9 * self.den / self.num))

    def __str__(self):
        return f"{self.num}/{self.den}"


@dataclasses.dataclass
class TensorsConfig:
    """Full stream configuration: tensor infos + format + rate.

    Reference: ``GstTensorsConfig`` (tensor_typedef.h:262-270). This is the
    payload of caps negotiation between elements.
    """

    info: TensorsInfo = dataclasses.field(default_factory=TensorsInfo)
    format: TensorFormat = TensorFormat.STATIC
    rate: Fraction = dataclasses.field(default_factory=lambda: Fraction(0, 1))

    @classmethod
    def from_arrays(cls, arrays, rate=None) -> "TensorsConfig":
        return cls(
            info=TensorsInfo.from_arrays(arrays),
            rate=Fraction.parse(rate) if rate is not None else Fraction(0, 1),
        )

    def is_valid(self) -> bool:
        if self.format in (TensorFormat.FLEXIBLE, TensorFormat.SPARSE):
            return True  # shapes are per-buffer (self-describing headers)
        return self.info.is_valid()

    def is_equal(self, other: "TensorsConfig") -> bool:
        if self.format != other.format:
            return False
        if self.format is TensorFormat.STATIC:
            return self.info.is_equal(other.info)
        return True

    # -- caps serialization -------------------------------------------------
    def to_caps(self) -> "Caps":
        from nnstreamer_tpu_torch.pipeline.caps import Caps

        fields = {"format": self.format.value}
        if self.format is TensorFormat.STATIC and self.info.num_tensors:
            fields["num_tensors"] = self.info.num_tensors
            fields["dimensions"] = self.info.dims_str()
            fields["types"] = self.info.types_str()
        if self.rate.num > 0:
            fields["framerate"] = str(self.rate)
        return Caps(MEDIA_TENSORS, fields)

    @classmethod
    def from_caps(cls, caps) -> "TensorsConfig":
        if caps.name not in (MEDIA_TENSOR, MEDIA_TENSORS):
            raise ValueError(f"not a tensor caps: {caps.name}")
        fmt = TensorFormat.from_any(caps.get("format", "static"))
        info = TensorsInfo()
        if "dimensions" in caps and "types" in caps:
            info = TensorsInfo.from_str(
                str(caps["dimensions"]), str(caps["types"]), str(caps.get("names", ""))
            )
        rate = Fraction.parse(caps.get("framerate", "0/1"))
        return cls(info=info, format=fmt, rate=rate)

    def __repr__(self):
        return (
            f"TensorsConfig({self.info!r}, format={self.format.value}, "
            f"rate={self.rate})"
        )
