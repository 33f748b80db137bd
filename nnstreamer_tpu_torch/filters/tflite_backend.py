"""TFLite filter backend (reference ``tensor_filter_tensorflow_lite.cc``,
1616 LoC — its richest subplugin).

Gated on an available TFLite interpreter (``ai_edge_litert``, standalone
``tflite_runtime``, or full ``tensorflow``), each imported at first open;
raises a clear error otherwise. TFLite runs on the host only — it exists
for drop-in parity with reference pipelines (``framework=tensorflow-lite
model=m.tflite``); the card's path is the torch backend. A copy of the JAX
package's module."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from nnstreamer_tpu_torch.filters.api import FilterFramework, FilterProperties
from nnstreamer_tpu_torch.registry import FILTER, subplugin
from nnstreamer_tpu_torch.tensors.types import TensorInfo, TensorsInfo, TensorType


def _interpreter_cls():
    try:
        from ai_edge_litert.interpreter import Interpreter  # type: ignore

        return Interpreter
    except ImportError:
        pass
    try:
        from tflite_runtime.interpreter import Interpreter  # type: ignore

        return Interpreter
    except ImportError:
        pass
    try:
        from tensorflow.lite.python.interpreter import Interpreter  # type: ignore

        return Interpreter
    except ImportError:
        return None


@subplugin(FILTER, "tflite")
@subplugin(FILTER, "tensorflow-lite")
class TFLiteFilter(FilterFramework):
    NAME = "tflite"

    def __init__(self):
        super().__init__()
        self._interp = None

    def open(self, props: FilterProperties) -> None:
        super().open(props)
        cls = _interpreter_cls()
        if cls is None:
            raise RuntimeError(
                "tflite: no TFLite interpreter installed (ai_edge_litert / "
                "tflite_runtime / tensorflow). Use framework=torch for "
                "the card's path."
            )
        num_threads = 1
        for part in (props.custom or "").split(","):
            if part.startswith("num_threads:"):
                num_threads = int(part.split(":", 1)[1])
        self._interp = cls(model_path=props.model, num_threads=num_threads)
        self._interp.allocate_tensors()

    def close(self) -> None:
        self._interp = None
        super().close()

    def _infos(self, details) -> TensorsInfo:
        return TensorsInfo([
            TensorInfo(dim=tuple(reversed([int(x) for x in d["shape"]])),
                       type=TensorType.from_any(d["dtype"]))
            for d in details
        ])

    def get_model_info(self):
        return (self._infos(self._interp.get_input_details()),
                self._infos(self._interp.get_output_details()))

    def invoke(self, inputs: Sequence) -> List:
        ins = self._interp.get_input_details()
        for d, x in zip(ins, inputs):
            self._interp.set_tensor(d["index"],
                                    np.ascontiguousarray(np.asarray(x)))
        with self.global_stats().measure():
            self._interp.invoke()
        return [self._interp.get_tensor(d["index"])
                for d in self._interp.get_output_details()]
