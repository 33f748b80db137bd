"""SingleShot — pipeline-less single invoke (L7 API surface).

Reference: ``gst/nnstreamer/tensor_filter/tensor_filter_single.c`` (431 LoC)
— a GObject wrapping tensor_filter_common without pads/caps, backing the
Tizen ``ml_single`` C-API: open the framework, invoke on demand, close.

Usage::

    s = SingleShot(framework="jax", model="mobilenet")  # or framework="auto"
    out = s.invoke([img])          # list in → list out
    s.close()                      # or use as a context manager

A copy of the JAX package's module. The backend runs where a
``tensor_filter`` with the same properties would: the torch backend on the
card by default, the CPU only on request (``accelerator="true:cpu"``, or
``set_device("cpu")``).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

from nnstreamer_tpu_torch.elements.filter import detect_framework
from nnstreamer_tpu_torch.filters.api import FilterFramework, FilterProperties
from nnstreamer_tpu_torch.registry import FILTER, get_subplugin
from nnstreamer_tpu_torch.tensors.types import TensorsInfo
from nnstreamer_tpu_torch.utils.stats import InvokeStats


class SingleShot:
    def __init__(self, framework: str = "auto", model: Optional[str] = None,
                 custom: Optional[str] = None,
                 accelerator: Optional[str] = None,
                 input_info: Optional[TensorsInfo] = None,
                 output_info: Optional[TensorsInfo] = None,
                 is_updatable: bool = False):
        if framework == "auto":
            if model is None:
                raise ValueError("SingleShot: framework=auto needs a model")
            framework = detect_framework(model)
            if framework is None:
                raise ValueError(f"cannot detect framework for {model!r}")
        factory = get_subplugin(FILTER, framework)
        if factory is None:
            raise ValueError(f"no filter backend {framework!r}")
        self.fw: FilterFramework = factory()
        self.stats = InvokeStats()
        self.fw.open(FilterProperties(
            model=model, custom=custom, accelerator=accelerator,
            input_info=input_info, output_info=output_info,
            is_updatable=is_updatable,
        ))

    # -- model info ----------------------------------------------------------
    def get_input_info(self) -> Optional[TensorsInfo]:
        return self.fw.get_model_info()[0]

    def get_output_info(self) -> Optional[TensorsInfo]:
        return self.fw.get_model_info()[1]

    def set_input_info(self, info: TensorsInfo) -> TensorsInfo:
        return self.fw.set_input_info(info)

    # -- invoke --------------------------------------------------------------
    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        with self.stats.measure():
            return self.fw.invoke(list(inputs))

    def reload_model(self, model: Optional[str] = None) -> None:
        self.fw.handle_event("reload_model",
                             {"model": model} if model else {})

    def close(self) -> None:
        self.fw.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
