"""Flax's msgpack checkpoint format, read and written with the standard
library and numpy.

The JAX package writes model weights with ``flax.serialization.to_bytes``
(``utils/checkpoint.save_params``) and reads them with ``from_bytes``;
``tensor_filter model=<file>.msgpack custom=module:<factory>`` loads such a
file. This module is the port's copy of that format, so the port reads
and writes those files without ``flax`` or ``msgpack``:

- :func:`to_bytes` gives, for a tree of dicts, lists and tuples with
  array leaves, the bytes ``flax.serialization.to_bytes`` gives for the
  same tree, byte for byte: flax's state dict (every key a string, a list
  or tuple a map ``{"0": ..., "1": ...}``), msgpack's smallest encodings,
  an array as ext type 1 ``(shape, dtype name, C-order bytes)``, a numpy
  scalar as ext type 3, a complex as ext type 2, and an array above
  :data:`MAX_CHUNK_SIZE` bytes as flax's chunked-array map.
- :func:`from_bytes` is ``flax.serialization.msgpack_restore``: the tree
  as the file holds it (maps as dicts, chunked arrays joined), leaves as
  numpy arrays; a ``bfloat16`` array, which numpy has no type for, comes
  back as a ``torch.bfloat16`` tensor (its bits through a uint16 view).

Leaves :func:`to_bytes` takes: numpy arrays and scalars, CPU or device
``torch.Tensor`` (written as the numpy array of the same dtype name;
``torch.bfloat16`` as ``bfloat16``), Python bool, int, float (float64),
complex, str, bytes and None.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

#: flax's ``MAX_CHUNK_SIZE``: an array of more bytes is written in chunks
MAX_CHUNK_SIZE = 2 ** 30
#: the key that marks flax's chunked-array map
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


class _Bf16:
    """A bfloat16 array as its bits (uint16), until the tree is whole."""

    __slots__ = ("bits",)

    def __init__(self, bits: np.ndarray):
        self.bits = bits

    def tensor(self) -> torch.Tensor:
        return torch.from_numpy(np.array(self.bits)).view(torch.bfloat16)


# -- the writer ----------------------------------------------------------------
def _leaf(x: Any) -> Any:
    """A torch tensor as the numpy array (or bfloat16 bits) it is written
    as; anything else as it is."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu")
        if x.dtype == torch.bfloat16:
            return _Bf16(x.contiguous().view(torch.int16).numpy()
                         .view(np.uint16))
        return x.numpy()
    return x


def _state_dict(tree: Any) -> Any:
    """``flax.serialization.to_state_dict`` of a tree of dicts, lists and
    tuples."""
    if isinstance(tree, dict):
        keys = {str(k) for k in tree}
        if len(keys) != len(tree):
            raise ValueError(f"Dict keys do not have a unique string "
                             f"representation: {keys}")
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, tuple):  # a namedtuple
        return {k: _state_dict(getattr(tree, k)) for k in tree._fields}
    return _leaf(tree)


def _nbytes_itemsize(x) -> Tuple[int, int]:
    arr = x.bits if isinstance(x, _Bf16) else x
    return arr.size * arr.dtype.itemsize, arr.dtype.itemsize


def _chunk(x) -> Dict[str, Any]:
    arr = x.bits if isinstance(x, _Bf16) else x
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    if isinstance(x, _Bf16):
        chunks = [_Bf16(c) for c in chunks]
    return {CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunk_leaves(tree: Any) -> Any:
    """flax's ``_chunk_array_leaves_in_place``: arrays of more than
    MAX_CHUNK_SIZE bytes in maps (and at the top) become chunked maps."""
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, _Bf16)) and \
            _nbytes_itemsize(tree)[0] > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _uint(out: List[bytes], n: int, codes) -> None:
    """A length header, msgpack's smallest: ``fixed_base | n`` below the
    fixed form's limit (where the type has one), else the 8-bit form
    (where it has one), the 16-bit or the 32-bit."""
    fixed_limit, fixed_base, c8, c16, c32 = codes
    if fixed_base is not None and n < fixed_limit:
        out.append(bytes([fixed_base | n]))
    elif c8 is not None and n < 0x100:
        out.append(bytes([c8, n]))
    elif n < 0x10000:
        out.append(struct.pack(">BH", c16, n))
    elif n < 0x100000000:
        out.append(struct.pack(">BI", c32, n))
    else:
        raise ValueError(f"msgpack: length {n} is too large")


_STR = (32, 0xA0, 0xD9, 0xDA, 0xDB)
_BIN = (0, None, 0xC4, 0xC5, 0xC6)
_ARRAY = (16, 0x90, None, 0xDC, 0xDD)
_MAP = (16, 0x80, None, 0xDE, 0xDF)
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _int(out: List[bytes], n: int) -> None:
    if n < -(1 << 5):
        if n < -(1 << 15):
            if n < -(1 << 31):
                if n < -(1 << 63):
                    raise OverflowError(f"msgpack: {n} is too small")
                out.append(struct.pack(">Bq", 0xD3, n))
            else:
                out.append(struct.pack(">Bi", 0xD2, n))
        elif n < -(1 << 7):
            out.append(struct.pack(">Bh", 0xD1, n))
        else:
            out.append(struct.pack(">Bb", 0xD0, n))
    elif n < (1 << 7):
        out.append(struct.pack(">b", n))
    elif n < (1 << 16):
        out.append(struct.pack(">BB", 0xCC, n) if n < (1 << 8)
                   else struct.pack(">BH", 0xCD, n))
    elif n < (1 << 32):
        out.append(struct.pack(">BI", 0xCE, n))
    elif n < (1 << 64):
        out.append(struct.pack(">BQ", 0xCF, n))
    else:
        raise OverflowError(f"msgpack: {n} is too large")


def _ext(out: List[bytes], code: int, data: bytes) -> None:
    n = len(data)
    if n in _FIXEXT:
        out.append(bytes([_FIXEXT[n], code]))
    elif n < 0x100:
        out.append(bytes([0xC7, n, code]))
    elif n < 0x10000:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    else:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    out.append(data)


def _array_bytes(x) -> bytes:
    """flax's ``_ndarray_to_bytes``: ``(shape, dtype name, bytes)``."""
    if isinstance(x, _Bf16):
        arr, name = x.bits, "bfloat16"
    else:
        arr, name = x, x.dtype.name
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("Object and structured dtypes not supported "
                             "for serialization of ndarrays.")
    out: List[bytes] = []
    _pack(out, [list(int(d) for d in arr.shape), name,
                arr.tobytes("C")])
    return b"".join(out)


def _pack(out: List[bytes], x: Any) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True:
        out.append(b"\xc3")
    elif x is False:
        out.append(b"\xc2")
    elif type(x) is int:
        _int(out, x)
    elif type(x) is float:
        out.append(struct.pack(">Bd", 0xCB, x))
    elif type(x) is str:
        data = x.encode("utf-8")
        _uint(out, len(data), _STR)
        out.append(data)
    elif type(x) in (bytes, bytearray, memoryview):
        data = bytes(x)
        _uint(out, len(data), _BIN)
        out.append(data)
    elif type(x) is list:
        _uint(out, len(x), _ARRAY)
        for v in x:
            _pack(out, v)
    elif type(x) is dict:
        _uint(out, len(x), _MAP)
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, (np.ndarray, _Bf16)):
        _ext(out, EXT_NDARRAY, _array_bytes(x))
    elif isinstance(x, np.generic):
        _ext(out, EXT_NPSCALAR, _array_bytes(np.asarray(x)))
    elif type(x) is complex:
        inner: List[bytes] = []
        _pack(inner, [x.real, x.imag])
        _ext(out, EXT_COMPLEX, b"".join(inner))
    else:
        raise TypeError(f"can not serialize {type(x).__name__!r} object")


def to_bytes(tree: Any) -> bytes:
    """``flax.serialization.to_bytes(tree)`` for a tree of dicts, lists
    and tuples with array (numpy or torch) and scalar leaves."""
    out: List[bytes] = []
    _pack(out, _chunk_leaves(_state_dict(tree)))
    return b"".join(out)


# -- the reader ----------------------------------------------------------------
class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fmts = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fmts:
            v = self.unpack(fmts[b])
            return float(v) if b in (0xCA, 0xCB) else int(v)
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B",
                   0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I",
                   0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                   0xC9: ">I"}
        if b in lengths:
            n = self.unpack(lengths[b])
            if b in (0xC4, 0xC5, 0xC6):
                return bytes(self.take(n))
            if b in (0xD9, 0xDA, 0xDB):
                return str(self.take(n), "utf-8")
            if b in (0xDC, 0xDD):
                return self.array(n)
            if b in (0xDE, 0xDF):
                return self.map(n)
            return self.ext(self.unpack(">b"), n)
        fixext = {v: k for k, v in _FIXEXT.items()}
        if b in fixext:
            return self.ext(self.unpack(">b"), fixext[b])
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int) -> Any:
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _array_from(data)
        if code == EXT_NPSCALAR:
            arr = _array_from(data)
            return arr if isinstance(arr, _Bf16) else arr[()]
        if code == EXT_COMPLEX:
            real, imag = _Reader(data).value()
            return complex(real, imag)
        raise ValueError(f"msgpack: unknown ext type {code}")


def _array_from(data) -> Any:
    shape, name, buf = _Reader(data).value()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        return _Bf16(np.frombuffer(buf, np.uint16).reshape(shape))
    return np.frombuffer(buf, np.dtype(name)).reshape(shape)


def _unchunk(x: Any) -> Any:
    if isinstance(x, dict):
        if CHUNKED in x:
            shape = tuple(x["shape"][str(i)] for i in range(len(x["shape"])))
            chunks = [x["chunks"][str(i)] for i in range(len(x["chunks"]))]
            if chunks and isinstance(chunks[0], _Bf16):
                return _Bf16(np.concatenate([c.bits for c in chunks])
                             .reshape(shape)).tensor()
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_unchunk(v) for v in x]
    if isinstance(x, _Bf16):
        return x.tensor()
    return x


def from_bytes(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore(data)``: the tree the bytes
    hold, chunked arrays joined; ``bfloat16`` arrays as torch tensors."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: trailing data after the tree")
    return _unchunk(tree)
