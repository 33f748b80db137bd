"""Typed scalar/tensor math helpers (reference ``tensor_data.c``).

Port of ``nnstreamer_tpu/tensors/data.py``. The reference implements
per-dtype get/set/typecast/average in C for tensor_if, tensor_crop and
tensor_transform. The elementwise work is the transform's (and kernel
B1's); these helpers cover the host-side scalar paths (condition
evaluation, crop coordinate extraction) plus saturating typecast
semantics matching the reference's behaviour for integer narrowing. They
take host arrays: numpy, or a CPU ``torch.Tensor`` (``bfloat16``
included), never a device tensor, which the calling element fetched first.
"""

from __future__ import annotations

import numpy as np
import torch

from nnstreamer_tpu_torch.tensors.buffer import host_float32
from nnstreamer_tpu_torch.tensors.types import TensorType


def host_numpy(arr) -> np.ndarray:
    """A host tensor as a numpy array (a ``bfloat16`` one as float32)."""
    if isinstance(arr, torch.Tensor):
        if arr.device.type != "cpu":
            raise ValueError("tensors.data takes host arrays; fetch the "
                             f"{arr.device} tensor first")
        if arr.dtype is torch.bfloat16:
            return host_float32(arr)
        return arr.numpy()
    return np.asarray(arr)


def typecast(arr, dst: TensorType):
    """Cast with C-style saturation for float->int (reference
    ``gst_tensor_data_typecast``, tensor_data.c)."""
    dst = TensorType.from_any(dst)
    dt = dst.np_dtype
    a = host_numpy(arr)
    if np.issubdtype(dt, np.integer) and np.issubdtype(a.dtype, np.floating):
        inf = np.iinfo(dt)
        a = np.clip(a, inf.min, inf.max)
    return a.astype(dt)


def average(arr) -> float:
    """Scalar mean of a tensor (reference ``gst_tensor_data_average``)."""
    return float(np.mean(np.asarray(host_numpy(arr), dtype=np.float64)))


def scalar_at(arr, flat_index: int) -> float:
    """Value at a flat index, as float (reference per-dtype get)."""
    return float(host_numpy(arr).reshape(-1)[flat_index])
