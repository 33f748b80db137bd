"""Pipeline-as-filter backend (reference ``tensor_filter_mediapipe.cc``,
373 LoC: an entire MediaPipe graph runs behind the filter vtable).

Here the nested "graph" is one of our own pipelines: the ``model``
property is a pipeline description (inline, or a ``.pipeline`` file)
containing an ``appsrc name=in`` and a ``tensor_sink name=out``::

    tensor_filter framework=pipeline \
        model="appsrc name=in ! tensor_transform mode=arithmetic \
               option=mul:2.0 ! tensor_sink name=out"

``open`` parses and starts the inner pipeline once; each ``invoke``
pushes the input frame into ``in`` and blocks until ``out`` emits the
result, so the nested pipeline (including any torch filters it contains,
with their own fused regions on the card) is a single element of the
outer one. Frames stay ordered because the inner pipeline is itself
order-preserving.

This is also the composition primitive the reference gets from
"composite models" pages: sub-pipelines become reusable filter units.

A copy of the JAX package's module; the inner pipeline is the port's.
The outer filter hands the inner ``appsrc`` host arrays, and the inner
``tensor_sink`` hands back host tensors.
"""

from __future__ import annotations

import os
import queue
from typing import Any, List, Sequence

import numpy as np

from nnstreamer_tpu_torch.filters.api import FilterFramework, FilterProperties
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.registry import FILTER, subplugin
from nnstreamer_tpu_torch.tensors.types import TensorsInfo, TensorType

log = get_logger("filters.pipeline")


@subplugin(FILTER, "pipeline")
class PipelineFilter(FilterFramework):
    """A nested pipeline behind the filter vtable."""

    NAME = "pipeline"

    #: seconds to wait for the inner pipeline to yield one result
    INVOKE_TIMEOUT = 120.0

    def __init__(self):
        super().__init__()
        self._pipe = None
        self._src = None
        self._results: "queue.Queue" = queue.Queue()

    def open(self, props: FilterProperties) -> None:
        super().open(props)
        desc = props.model or ""
        if os.path.isfile(desc):
            with open(desc, "r", encoding="utf-8") as f:
                desc = f.read()
        if "appsrc" not in desc or "tensor_sink" not in desc:
            raise ValueError(
                "pipeline: description needs 'appsrc name=in' and "
                "'tensor_sink name=out'"
            )
        from nnstreamer_tpu_torch.pipeline.parse import parse_launch

        self._pipe = parse_launch(" ".join(desc.split()))
        self._src = self._pipe.get("in")
        sink = self._pipe.get("out")
        sink.connect(self._results.put)
        self._pipe.start()

    def close(self) -> None:
        if self._pipe is not None:
            try:
                self._src.end_of_stream()
            except Exception as e:  # noqa: BLE001 — teardown best-effort
                log.debug("inner pipeline EOS on close failed: %s", e)
            self._pipe.stop()
        self._pipe = self._src = None
        super().close()

    def set_input_info(self, in_info: TensorsInfo) -> TensorsInfo:
        # probe the inner pipeline with one zero frame of the negotiated
        # shape; its output defines our output caps.
        import torch

        zeros = [torch.zeros(t.shape, dtype=t.type.torch_dtype)
                 if t.type is TensorType.BFLOAT16 else
                 np.zeros(t.shape, t.type.np_dtype) for t in in_info]
        outs = self.invoke(zeros)
        return TensorsInfo.from_arrays(outs)

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        if self._pipe is None:
            raise RuntimeError("pipeline: not opened")
        with self.global_stats().measure():
            self._src.push(list(inputs))
            try:
                buf = self._results.get(timeout=self.INVOKE_TIMEOUT)
            except queue.Empty:
                # surface an inner-pipeline error if that's why we starved
                msg = self._pipe.pop_message(timeout=0)
                while msg is not None and msg.kind != "error":
                    msg = self._pipe.pop_message(timeout=0)
                if msg is not None:
                    raise RuntimeError(
                        f"pipeline: inner pipeline error: {msg.error}"
                    )
                raise RuntimeError(
                    "pipeline: inner pipeline produced no result "
                    f"within {self.INVOKE_TIMEOUT}s"
                )
            return list(buf.tensors)
