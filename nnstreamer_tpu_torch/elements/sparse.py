"""tensor_sparse_enc / tensor_sparse_dec — dense↔sparse transcoding.

Reference: ``gst/nnstreamer/elements/gsttensorsparseenc.c`` (414 LoC) /
``...dec.c`` (408) + ``tensor_sparse/tensor_sparse_util.c``: COO-style
encoding (nnz values + flat indices) of mostly-zero tensors to save
transport bandwidth, emitted as flexible-format buffers with
self-describing headers.

Two selectable wire layouts (``layout`` property on the encoder; the
decoder sniffs the header and accepts both):

- ``reference`` (default): byte-exact ``GstTensorMetaInfo`` v1 header
  (128 B) + values[nnz] + uint32 flat indices[nnz] — the order
  gst_tensor_sparse_from_dense writes (tensor_sparse_util.c:236-240)
  — so streams interoperate with reference sparse_dec peers.
- ``native``: the framework's TMI1 header + uint32 indices[nnz] +
  values[nnz]; supports rank>4 and fp16/bf16 tensors the reference
  enum cannot express.

A port of the JAX package's module. An element counts as zero when all of
its bytes are zero: the scan runs on an unsigned-integer view of the
element's width, through the native library's GIL-free C++ scan
(``native.sparse_encode_arrays``/``sparse_decode_arrays``, which compares
bytes) when it is loaded and numpy otherwise, so ``-0.0`` and every NaN
are kept as non-zeros on both paths. The
encoder fetches a device buffer to the host once and scans there, as the
JAX encoder does; a ``bfloat16`` tensor stays a CPU torch tensor on the
host and is scanned through its 16-bit view.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from nnstreamer_tpu_torch.pipeline.element import Element
from nnstreamer_tpu_torch.registry import ELEMENT, subplugin
from nnstreamer_tpu_torch.tensors.meta import (
    REF_HEADER_SIZE,
    TensorMetaInfo,
    parse_header,
)
from nnstreamer_tpu_torch.tensors.types import (
    TensorFormat,
    TensorInfo,
    TensorsConfig,
    TensorType,
)

#: element width in bytes → the unsigned type the zero test reads
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
_LAYOUTS = ("reference", "native")


def _flat_bits(arr) -> Tuple[TensorInfo, np.ndarray]:
    """Info and a flat unsigned-integer view of a host tensor's elements
    (numpy, or a CPU torch tensor such as ``bfloat16``)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().contiguous().cpu()
        info = TensorInfo.from_array(t)
        if t.dtype is torch.bfloat16:
            return info, t.reshape(-1).view(torch.int16).numpy().view(
                np.uint16)
        arr = t.numpy()
    arr = np.ascontiguousarray(np.asarray(arr))
    flat = arr.reshape(-1)
    return TensorInfo.from_array(arr), flat.view(_UINT[flat.dtype.itemsize])


def sparse_encode(arr, layout: str = "reference") -> bytes:
    if layout not in _LAYOUTS:
        raise ValueError(f"sparse_encode: unknown layout {layout!r} "
                         "(reference|native)")
    from nnstreamer_tpu_torch import native

    info, bits = _flat_bits(arr)
    idx, vals = native.sparse_encode_arrays(bits)
    meta = TensorMetaInfo.from_info(info, format=TensorFormat.SPARSE,
                                    sparse_nnz=int(idx.size))
    if layout == "reference":
        # values first, then indices (tensor_sparse_util.c:236-240)
        return meta.pack_ref() + vals.tobytes() + idx.tobytes()
    return meta.pack() + idx.tobytes() + vals.tobytes()


def sparse_decode(blob: bytes, offset: int = 0):
    """Dense tensor and the offset past its payload. A ``bfloat16``
    tensor comes back as a CPU torch tensor, every other type as numpy."""
    meta, hsize = parse_header(blob, offset)
    if meta.format is not TensorFormat.SPARSE:
        raise ValueError("sparse_decode: not a sparse payload")
    nnz = meta.sparse_nnz
    width = meta.type.size
    ubits = _UINT[width]
    p = offset + hsize
    end = p + (width + 4) * nnz
    if len(blob) < end:
        raise ValueError(f"sparse_decode: truncated payload ({len(blob)} "
                         f"bytes, header promises {end})")
    if hsize == REF_HEADER_SIZE:
        # reference order: values then flat indices
        vals = np.frombuffer(blob[p:p + width * nnz], ubits)
        idx = np.frombuffer(blob[p + width * nnz:end], np.uint32)
    else:
        idx = np.frombuffer(blob[p:p + 4 * nnz], np.uint32)
        vals = np.frombuffer(blob[p + 4 * nnz:end], ubits)
    info = meta.to_info()
    n = info.num_elements
    if nnz and int(idx.max()) >= n:
        raise ValueError(f"sparse_decode: index {int(idx.max())} outside "
                         f"dense tensor of {n} elements")
    from nnstreamer_tpu_torch import native

    dense = native.sparse_decode_arrays(idx, vals, n)
    if meta.type is TensorType.BFLOAT16:
        out = torch.from_numpy(dense.view(np.int16)).view(torch.bfloat16)
        return out.reshape(info.shape), end
    return dense.view(meta.type.np_dtype).reshape(info.shape), end


@subplugin(ELEMENT, "tensor_sparse_enc")
class TensorSparseEnc(Element):
    ELEMENT_NAME = "tensor_sparse_enc"
    PROPERTIES = {
        **Element.PROPERTIES,
        "layout": "reference",
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.add_src_pad("src")

    def transform_caps(self, pad, caps):
        return TensorsConfig(format=TensorFormat.SPARSE).to_caps()

    def chain(self, pad, buf):
        layout = self.get_property("layout")
        if layout not in _LAYOUTS:
            raise ValueError(f"tensor_sparse_enc: unknown layout {layout!r} "
                             "(reference|native)")
        host = buf.to_host()  # applies any deferred finalize exactly once
        blobs = [np.frombuffer(sparse_encode(t, layout=layout), np.uint8)
                 for t in host.tensors]
        return self.srcpad.push(host.with_tensors(blobs))


@subplugin(ELEMENT, "tensor_sparse_dec")
class TensorSparseDec(Element):
    ELEMENT_NAME = "tensor_sparse_dec"

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.add_src_pad("src")

    def transform_caps(self, pad, caps):
        return None  # static caps derive from the first decoded frame

    def chain(self, pad, buf):
        host = buf.to_host()
        outs = [sparse_decode(np.ascontiguousarray(t).tobytes())[0]
                for t in host.tensors]
        if self.srcpad.caps is None:
            self.srcpad.set_caps(TensorsConfig.from_arrays(outs).to_caps())
        return self.srcpad.push(host.with_tensors(outs))
