"""Python-class filter backend (reference ``tensor_filter_python3.cc``,
842 LoC + helper ``nnstreamer_python3_helper.cc``).

The reference embeds CPython and loads a user script defining a class with
``getInputDim/getOutputDim/setInputDim/invoke``; here the host language *is*
Python, so the backend imports the script and duck-types the same protocol
(both reference-style camelCase and snake_case method names are accepted)::

    # model file my_filter.py
    class Filter:
        def get_input_info(self): ...   # or getInputDim
        def get_output_info(self): ...  # or getOutputDim
        def set_input_info(self, in_info): ...  # optional, dynamic shapes
        def invoke(self, inputs): return [...]
"""

from __future__ import annotations

import importlib.util
import os
import sys
from typing import List, Sequence

from nnstreamer_tpu_torch.filters.api import FilterFramework, FilterProperties
from nnstreamer_tpu_torch.registry import FILTER, subplugin
from nnstreamer_tpu_torch.tensors.types import TensorsInfo


def _first_attr(obj, *names):
    for n in names:
        if hasattr(obj, n):
            return getattr(obj, n)
    return None


@subplugin(FILTER, "python")
class PythonFilter(FilterFramework):
    NAME = "python"

    def __init__(self):
        super().__init__()
        self._obj = None

    def open(self, props: FilterProperties) -> None:
        super().open(props)
        path = props.model
        if not path or not os.path.isfile(path):
            raise ValueError(f"python: no such script {path!r}")
        spec = importlib.util.spec_from_file_location(
            f"nnstreamer_tpu_torch_pyfilter_{os.path.basename(path).replace('.', '_')}",
            path,
        )
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        cls = _first_attr(mod, "Filter", "CustomFilter")
        if cls is None:
            raise ValueError(
                f"python: {path!r} must define class Filter (or CustomFilter)"
            )
        self._obj = cls(props.custom) if _takes_arg(cls) else cls()

    def close(self) -> None:
        self._obj = None
        super().close()

    def get_model_info(self):
        fin = _first_attr(self._obj, "get_input_info", "getInputDim")
        fout = _first_attr(self._obj, "get_output_info", "getOutputDim")
        return (fin() if fin else None), (fout() if fout else None)

    def set_input_info(self, in_info: TensorsInfo) -> TensorsInfo:
        f = _first_attr(self._obj, "set_input_info", "setInputDim")
        if f is None:
            return super().set_input_info(in_info)
        return f(in_info)

    def invoke(self, inputs: Sequence) -> List:
        with self.global_stats().measure():
            return list(self._obj.invoke(list(inputs)))


def _takes_arg(cls) -> bool:
    import inspect

    try:
        sig = inspect.signature(cls.__init__)
        return len(sig.parameters) > 1
    except (TypeError, ValueError):
        return False
