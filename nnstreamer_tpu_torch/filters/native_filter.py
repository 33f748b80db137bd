"""Native (.so) custom filter backend — the C-ABI extension point.

Reference: ``tensor_filter_custom`` loads user shared objects exposing a C
vtable (gst/nnstreamer/tensor_filter/tensor_filter_custom.c,
include/tensor_filter_custom.h), and the C++ class API wraps the same
contract (include/nnstreamer_cppplugin_api_filter.hh). Here the contract
is ``native/nnstpu_filter.h``: the .so exports
``nnstpu_filter_get_vtable()`` and the backend drives it via ctypes.
Tensors cross as raw host pointers; ctypes releases the GIL during
``invoke``, so native filters run concurrently with the Python pipeline
threads — the reference's native-speed custom-op path, kept native.

``model`` property: path to the .so. ``custom``: opaque option string
passed to the filter's ``open``. Host tensors only: the filter element
hands this backend host arrays. A copy of the JAX package's module.
"""

from __future__ import annotations

import ctypes
import os
from typing import Any, List, Optional, Sequence

import numpy as np

from nnstreamer_tpu_torch.filters.api import FilterFramework, FilterProperties
from nnstreamer_tpu_torch.registry import FILTER, subplugin
from nnstreamer_tpu_torch.tensors.types import TensorInfo, TensorsInfo, TensorType

NNSTPU_MAX_TENSORS = 16
NNSTPU_MAX_RANK = 8
_ABI = 1

_TYPE_ORDER = list(TensorType)


class _CTensorInfo(ctypes.Structure):
    _fields_ = [
        ("rank", ctypes.c_uint32),
        ("dims", ctypes.c_uint32 * NNSTPU_MAX_RANK),
        ("dtype", ctypes.c_int32),
    ]


class _CTensorsInfo(ctypes.Structure):
    _fields_ = [
        ("num_tensors", ctypes.c_uint32),
        ("info", _CTensorInfo * NNSTPU_MAX_TENSORS),
    ]


_PTR = ctypes.c_void_p


class _CVtable(ctypes.Structure):
    _fields_ = [
        ("abi_version", ctypes.c_int),
        ("open", ctypes.CFUNCTYPE(_PTR, ctypes.c_char_p)),
        ("close", ctypes.CFUNCTYPE(None, _PTR)),
        ("get_model_info", ctypes.CFUNCTYPE(
            ctypes.c_int, _PTR, ctypes.POINTER(_CTensorsInfo),
            ctypes.POINTER(_CTensorsInfo))),
        ("set_input_info", ctypes.CFUNCTYPE(
            ctypes.c_int, _PTR, ctypes.POINTER(_CTensorsInfo),
            ctypes.POINTER(_CTensorsInfo))),
        ("invoke", ctypes.CFUNCTYPE(
            ctypes.c_int, _PTR, ctypes.POINTER(_PTR),
            ctypes.POINTER(_PTR))),
    ]


def _to_c_info(info: TensorsInfo) -> _CTensorsInfo:
    c = _CTensorsInfo()
    c.num_tensors = len(info)
    for i, ti in enumerate(info):
        shape = ti.shape  # numpy order
        c.info[i].rank = len(shape)
        for d, s in enumerate(shape):
            c.info[i].dims[d] = s
        c.info[i].dtype = _TYPE_ORDER.index(ti.type)
    return c


def _from_c_info(c: _CTensorsInfo) -> Optional[TensorsInfo]:
    if c.num_tensors == 0:
        return None
    infos = []
    for i in range(c.num_tensors):
        ci = c.info[i]
        shape = tuple(ci.dims[d] for d in range(ci.rank))
        infos.append(TensorInfo(dim=tuple(reversed(shape)),
                                type=_TYPE_ORDER[ci.dtype]))
    return TensorsInfo(infos)


@subplugin(FILTER, "native")
class NativeFilter(FilterFramework):
    NAME = "native"
    KEEP_ON_DEVICE = False

    def __init__(self):
        super().__init__()
        self._dll: Optional[ctypes.CDLL] = None
        self._vt: Optional[_CVtable] = None
        self._handle: Optional[int] = None
        self._out_info: Optional[TensorsInfo] = None
        self._in_info: Optional[TensorsInfo] = None

    def open(self, props: FilterProperties) -> None:
        super().open(props)
        path = props.model
        if not path or not os.path.isfile(path):
            raise ValueError(f"native: model must be a .so path, got "
                             f"{path!r}")
        self._dll = ctypes.CDLL(os.path.abspath(path))
        getter = self._dll.nnstpu_filter_get_vtable
        getter.restype = ctypes.POINTER(_CVtable)
        self._vt = getter().contents
        if self._vt.abi_version != _ABI:
            raise RuntimeError(
                f"native: {path} has filter ABI {self._vt.abi_version}, "
                f"runtime expects {_ABI}")
        custom = (props.custom or "").encode()
        self._handle = self._vt.open(custom if custom else None)
        if not self._handle:
            raise RuntimeError(f"native: {path} open() failed")

    def close(self) -> None:
        if self._vt is not None and self._handle:
            self._vt.close(self._handle)
        self._dll = self._vt = self._handle = None
        super().close()

    def get_model_info(self):
        cin, cout = _CTensorsInfo(), _CTensorsInfo()
        rc = self._vt.get_model_info(self._handle, ctypes.byref(cin),
                                     ctypes.byref(cout))
        if rc != 0:
            raise RuntimeError(f"native: get_model_info failed ({rc})")
        self._in_info = _from_c_info(cin)
        self._out_info = _from_c_info(cout)
        return self._in_info, self._out_info

    def set_input_info(self, in_info: TensorsInfo) -> TensorsInfo:
        cin = _to_c_info(in_info)
        cout = _CTensorsInfo()
        if not self._vt.set_input_info:
            raise RuntimeError("native: filter has no set_input_info and "
                               "no static output info")
        rc = self._vt.set_input_info(self._handle, ctypes.byref(cin),
                                     ctypes.byref(cout))
        if rc != 0:
            raise RuntimeError(f"native: set_input_info failed ({rc})")
        self._in_info = in_info
        self._out_info = _from_c_info(cout)
        if self._out_info is None:
            raise RuntimeError("native: set_input_info returned no output "
                               "info")
        return self._out_info

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        if self._out_info is None:
            # static-info filters may skip set_input_info; derive now
            self.set_input_info(TensorsInfo.from_arrays(list(inputs)))
        ins = [np.ascontiguousarray(x) for x in inputs]
        outs = [np.empty(i.shape, i.type.np_dtype) for i in self._out_info]
        in_ptrs = (_PTR * len(ins))(
            *[x.ctypes.data_as(_PTR).value for x in ins])
        out_ptrs = (_PTR * len(outs))(
            *[x.ctypes.data_as(_PTR).value for x in outs])
        with self.global_stats().measure():
            rc = self._vt.invoke(self._handle, in_ptrs, out_ptrs)
        if rc != 0:
            raise RuntimeError(f"native: invoke failed ({rc})")
        return outs
