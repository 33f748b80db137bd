"""Subplugin registries — name → implementation per subplugin kind.

The port's own registry (the JAX package keeps a process-global dict keyed
by element name, so the two packages cannot share one). Same contract as
the reference's ``nnstreamer_subplugin.c``: explicit registration
(:func:`register_subplugin` / the :func:`subplugin` decorator) and lookup
with lazy discovery of the built-in module that provides a name
(:func:`get_subplugin`). ELEMENT factories register when
``nnstreamer_tpu_torch.elements`` is imported.
"""

from __future__ import annotations

import importlib
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
    },
    DECODER: {
        "image_labeling": "nnstreamer_tpu_torch.decoders.image_labeling",
        "bounding_boxes": "nnstreamer_tpu_torch.decoders.bounding_boxes",
        "pose_estimation": "nnstreamer_tpu_torch.decoders.pose_estimation",
        "image_segment": "nnstreamer_tpu_torch.decoders.image_segment",
        "direct_video": "nnstreamer_tpu_torch.decoders.direct_video",
        "octet_stream": "nnstreamer_tpu_torch.decoders.octet_stream",
        "python3": "nnstreamer_tpu_torch.decoders.python3",
    },
    CONVERTER: {
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


def get_subplugin(kind: str, name: str) -> Optional[Any]:
    """Look up a subplugin, lazily importing the built-in module that
    provides it. Reference ``get_subplugin`` (nnstreamer_subplugin.c:138)."""
    with _lock:
        if name in _registry[kind]:
            return _registry[kind][name]
    if kind == ELEMENT:
        importlib.import_module(_ELEMENTS_MODULE)
    provider = _BUILTIN_PROVIDERS.get(kind, {}).get(name)
    if provider:
        importlib.import_module(provider)
    with _lock:
        return _registry[kind].get(name)


def registered_names(kind: str) -> list:
    """All known names for a kind: registered plus lazily discoverable."""
    with _lock:
        names = set(_registry[kind])
    names.update(_BUILTIN_PROVIDERS.get(kind, {}))
    return sorted(names)
