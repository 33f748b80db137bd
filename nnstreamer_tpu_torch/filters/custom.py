"""Custom filter backends: in-process user functions and classes.

Port of ``nnstreamer_tpu/filters/custom.py``. Reference:
``tensor_filter_custom.c`` (full vtable from a user .so) and
``tensor_filter_custom_easy.c`` (single function registered from app
code, ``include/tensor_filter_custom_easy.h``). These are the test-scaffolding
backbone of the reference (tests/nnstreamer_example custom .so models);
here they are plain Python registrations — the same capability without the
dlopen ceremony.

- :func:`register_custom_easy(name, fn, in_info, out_info)` — the
  custom-easy path: ``fn(list_of_arrays) -> list_of_arrays``; instantiate
  with ``tensor_filter framework=custom-easy model=<name>``.
- :class:`CustomFilterBase` — the full-vtable path: subclass, then
  ``register_custom(name, cls)``; supports dynamic shapes via
  ``set_input_info``.

Neither backend keeps tensors on the device: the filter element hands
them host arrays (numpy; a ``bfloat16`` tensor as a CPU tensor), fetching
a device payload first, as the JAX package hands its custom backends
numpy arrays. A callable that raises fails the frame under the filter's
error policy; nothing is retried elsewhere.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

from nnstreamer_tpu_torch.filters.api import FilterFramework, FilterProperties
from nnstreamer_tpu_torch.registry import FILTER, subplugin
from nnstreamer_tpu_torch.tensors.types import TensorsInfo

_easy: Dict[str, tuple] = {}
_custom: Dict[str, type] = {}
_lock = threading.Lock()


def register_custom_easy(name: str, fn: Callable[[Sequence[Any]], List[Any]],
                         in_info: TensorsInfo,
                         out_info: TensorsInfo) -> None:
    """Register a single-function model (reference
    ``NNS_custom_easy_register``, tensor_filter_custom_easy.c)."""
    with _lock:
        _easy[name] = (fn, in_info, out_info)


def unregister_custom_easy(name: str) -> bool:
    with _lock:
        return _easy.pop(name, None) is not None


class CustomFilterBase(FilterFramework):
    """Full custom filter: subclass with get_model_info/invoke (reference
    ``NNStreamer_custom_class``, tensor_filter_custom.h)."""

    NAME = "custom"


def register_custom(name: str, cls: type) -> None:
    with _lock:
        _custom[name] = cls


@subplugin(FILTER, "custom-easy")
class CustomEasyFilter(FilterFramework):
    NAME = "custom-easy"

    def __init__(self):
        super().__init__()
        self._fn = None
        self._in = None
        self._out = None

    def open(self, props: FilterProperties) -> None:
        super().open(props)
        name = props.model
        with _lock:
            entry = _easy.get(name)
        if entry is None:
            raise ValueError(
                f"custom-easy: no registered model {name!r} "
                f"(register_custom_easy first)"
            )
        self._fn, self._in, self._out = entry

    def get_model_info(self):
        return self._in, self._out

    def invoke(self, inputs):
        return list(self._fn(inputs))


@subplugin(FILTER, "custom")
class CustomFilter(FilterFramework):
    """Dispatches to a registered CustomFilterBase subclass by model name."""

    NAME = "custom"

    def __init__(self):
        super().__init__()
        self._impl: Optional[FilterFramework] = None

    def open(self, props: FilterProperties) -> None:
        super().open(props)
        with _lock:
            cls = _custom.get(props.model)
        if cls is None:
            raise ValueError(f"custom: no registered class {props.model!r}")
        self._impl = cls()
        self._impl.open(props)

    def close(self):
        if self._impl is not None:
            self._impl.close()
            self._impl = None
        super().close()

    def get_model_info(self):
        return self._impl.get_model_info()

    def set_input_info(self, in_info):
        return self._impl.set_input_info(in_info)

    def invoke(self, inputs):
        return self._impl.invoke(inputs)

    def handle_event(self, name, data):
        self._impl.handle_event(name, data)
