"""Subplugin registries — name → implementation per subplugin kind.

The port's own registry (the JAX package keeps a process-global dict keyed
by element name, so the two packages cannot share one). Same contract as
the reference's ``nnstreamer_subplugin.c``: explicit registration
(:func:`register_subplugin` / the :func:`subplugin` decorator) and lookup
with lazy discovery of the built-in module that provides a name
(:func:`get_subplugin`). ELEMENT factories register when
``nnstreamer_tpu_torch.elements`` is imported. A name no built-in module
provides is looked for as ``nnstreamer_tpu_torch_<kind>_<name>.py`` on the
kind's search path (``NNSTREAMER_TPU_<KIND>_PATH`` or the ini's
``[<kind>] path``), the file ``nns-launch-torch --scaffold`` writes; the
JAX package's scaffolds are named ``nnstreamer_tpu_<kind>_<name>.py`` and
are not loaded here.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import sys
import threading
from typing import Any, Callable, Dict, Optional

from nnstreamer_tpu_torch.log import get_logger

log = get_logger("registry")

FILTER = "filter"
DECODER = "decoder"
CONVERTER = "converter"
ELEMENT = "element"

_KINDS = (FILTER, DECODER, CONVERTER, ELEMENT)
_registry: Dict[str, Dict[str, Any]] = {k: {} for k in _KINDS}
_lock = threading.RLock()

#: name → module that provides it, for lazy built-in discovery.
_BUILTIN_PROVIDERS: Dict[str, Dict[str, str]] = {
    FILTER: {
        "torch": "nnstreamer_tpu_torch.filters.torch_backend",
        # reference launch strings name framework=jax; the port serves
        # them with its torch backend
        "jax": "nnstreamer_tpu_torch.filters.torch_backend",
        "custom": "nnstreamer_tpu_torch.filters.custom",
        "custom-easy": "nnstreamer_tpu_torch.filters.custom",
        "python": "nnstreamer_tpu_torch.filters.python_class",
        "tflite": "nnstreamer_tpu_torch.filters.tflite_backend",
        "tensorflow-lite": "nnstreamer_tpu_torch.filters.tflite_backend",
        "native": "nnstreamer_tpu_torch.filters.native_filter",
        "pipeline": "nnstreamer_tpu_torch.filters.pipeline_filter",
        "tensorflow": "nnstreamer_tpu_torch.filters.tf_backend",
        "script": "nnstreamer_tpu_torch.filters.script",
        "transformers": "nnstreamer_tpu_torch.filters.transformers_backend",
    },
    DECODER: {
        "image_labeling": "nnstreamer_tpu_torch.decoders.image_labeling",
        "bounding_boxes": "nnstreamer_tpu_torch.decoders.bounding_boxes",
        "pose_estimation": "nnstreamer_tpu_torch.decoders.pose_estimation",
        "image_segment": "nnstreamer_tpu_torch.decoders.image_segment",
        "direct_video": "nnstreamer_tpu_torch.decoders.direct_video",
        "octet_stream": "nnstreamer_tpu_torch.decoders.octet_stream",
        "flexbuf": "nnstreamer_tpu_torch.decoders.flexbuf",
        "nnstpu-flex": "nnstreamer_tpu_torch.decoders.flexbuf",
        "protobuf": "nnstreamer_tpu_torch.decoders.protobuf_codec",
        "flatbuf": "nnstreamer_tpu_torch.decoders.flatbuf_codec",
        "python3": "nnstreamer_tpu_torch.decoders.python3",
    },
    CONVERTER: {
        "flexbuf": "nnstreamer_tpu_torch.converters.flexbuf",
        "nnstpu-flex": "nnstreamer_tpu_torch.converters.flexbuf",
        "protobuf": "nnstreamer_tpu_torch.converters.protobuf_codec",
        "flatbuf": "nnstreamer_tpu_torch.decoders.flatbuf_codec",
        "python3": "nnstreamer_tpu_torch.converters.python3",
    },
    ELEMENT: {},  # populated by nnstreamer_tpu_torch.elements at import
}

_ELEMENTS_MODULE = "nnstreamer_tpu_torch.elements"


def register_subplugin(kind: str, name: str, impl: Any,
                       replace: bool = True) -> None:
    """Register ``impl`` under (kind, name). Reference
    ``register_subplugin`` (nnstreamer_subplugin.c:222)."""
    if kind not in _KINDS:
        raise ValueError(f"unknown subplugin kind {kind!r}")
    with _lock:
        if name in _registry[kind] and not replace:
            raise ValueError(f"{kind} subplugin {name!r} already registered")
        _registry[kind][name] = impl


def unregister_subplugin(kind: str, name: str) -> bool:
    with _lock:
        return _registry[kind].pop(name, None) is not None


def subplugin(kind: str, name: str) -> Callable:
    """Class/function decorator form of :func:`register_subplugin`."""

    def deco(obj):
        register_subplugin(kind, name, obj)
        return obj

    return deco


def external_subplugin_filename(kind: str, name: str) -> str:
    """The on-disk filename the external search expects — shared with the
    ``--scaffold`` codegen so the two can never drift."""
    return f"nnstreamer_tpu_torch_{kind}_{name}.py"


def _search_external(kind: str, name: str) -> None:
    """Load ``nnstreamer_tpu_torch_<kind>_<name>.py`` from the configured
    search paths (the dlopen-from-conf-paths analog,
    nnstreamer_subplugin.c:107-135); the module registers itself."""
    from nnstreamer_tpu_torch.config import get_conf

    fname = external_subplugin_filename(kind, name)
    for path in get_conf().subplugin_paths(kind):
        full = os.path.join(path, fname)
        if os.path.isfile(full):
            spec = importlib.util.spec_from_file_location(
                f"nnstreamer_tpu_torch_ext.{kind}.{name}", full)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[spec.name] = mod
            spec.loader.exec_module(mod)
            return


def get_subplugin(kind: str, name: str) -> Optional[Any]:
    """Look up a subplugin, lazily importing the built-in module that
    provides it, else an external one from the search paths. Reference
    ``get_subplugin`` (nnstreamer_subplugin.c:138)."""
    with _lock:
        if name in _registry[kind]:
            return _registry[kind][name]
    if kind == ELEMENT:
        importlib.import_module(_ELEMENTS_MODULE)
    provider = _BUILTIN_PROVIDERS.get(kind, {}).get(name)
    if provider:
        importlib.import_module(provider)
    with _lock:
        if name in _registry[kind]:
            return _registry[kind][name]
    _search_external(kind, name)
    with _lock:
        return _registry[kind].get(name)


def registered_names(kind: str) -> list:
    """All known names for a kind: registered plus lazily discoverable."""
    with _lock:
        names = set(_registry[kind])
    names.update(_BUILTIN_PROVIDERS.get(kind, {}))
    return sorted(names)
