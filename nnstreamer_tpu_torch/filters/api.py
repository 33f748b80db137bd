"""The filter-framework subplugin API (the reference's single most important
extension point).

Reference: ``GstTensorFilterFramework`` v1 vtable —
``open/close/invoke/getModelInfo/eventHandler``
(gst/nnstreamer/include/nnstreamer_plugin_api_filter.h:273-495) — plus the
cross-instance shared-model representation
(``nnstreamer_filter_shared_model_get/insert/remove``, :577-602) and
per-framework cumulative statistics (:169-174).

Backends subclass :class:`FilterFramework` and register with
``register_subplugin(FILTER, name, cls)`` (the .so-constructor
``nnstreamer_filter_probe`` analog). The element never touches backend
internals; tensors cross the boundary as numpy arrays or torch tensors —
backends declare ``KEEP_ON_DEVICE`` to receive/return device tensors so a
chain of device-aware elements never bounces tensors to host.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from nnstreamer_tpu_torch.tensors.types import TensorsInfo
from nnstreamer_tpu_torch.utils.stats import InvokeStats


def parse_custom(custom: Optional[str]) -> Dict[str, str]:
    """Parse the backend-agnostic ``custom`` option string:
    comma-separated ``key:value`` (or ``key=value``) pairs. Values may
    carry ';'-separated lists (e.g. multiple tensor names) — the comma
    is the only pair separator."""
    out: Dict[str, str] = {}
    for part in (custom or "").split(","):
        part = part.strip()
        if not part:
            continue
        sep = ":" if ":" in part else "="
        k, _, v = part.partition(sep)
        out[k.strip()] = v.strip()
    return out


@dataclasses.dataclass
class FilterProperties:
    """Everything a backend needs at open() time (reference
    ``GstTensorFilterProperties``)."""

    model: Optional[str] = None          # path(s), comma-separated
    custom: Optional[str] = None         # backend-specific option string
    accelerator: Optional[str] = None    # e.g. "true:cuda", "true:cpu"
    mesh: Optional[str] = None           # serving mesh spec, e.g. "dp4",
                                         # "dp2xtp2" (parallel/serve.py)
    input_info: Optional[TensorsInfo] = None   # user-forced input shapes
    output_info: Optional[TensorsInfo] = None  # user-forced output shapes
    is_updatable: bool = False           # model hot-reload allowed
    shared_key: Optional[str] = None     # shared-tensor-filter-key
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def models(self) -> List[str]:
        return [m.strip() for m in (self.model or "").split(",") if m.strip()]


class FilterFramework:
    """Backend base class (the v1 vtable).

    Lifecycle: ``open(props)`` → ``get_model_info()`` / ``set_input_info()``
    → ``invoke()``×N → ``close()``. ``handle_event`` receives custom events
    (e.g. ``reload_model``, reference RELOAD_MODEL,
    nnstreamer_plugin_api_filter.h:377-383).
    """

    #: registry name; subclasses override.
    NAME = "base"
    #: backend accepts/returns device tensors (no host bounce).
    KEEP_ON_DEVICE = False
    #: per-framework cumulative stats (reference
    #: GstTensorFilterFrameworkStatistics) — keyed by NAME.
    _GLOBAL_STATS: Dict[str, InvokeStats] = {}
    _GLOBAL_STATS_LOCK = threading.Lock()

    def __init__(self):
        self.props: Optional[FilterProperties] = None

    # -- vtable --------------------------------------------------------------
    def open(self, props: FilterProperties) -> None:
        self.props = props

    def close(self) -> None:
        self.props = None

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        raise NotImplementedError

    def get_model_info(self) -> Tuple[Optional[TensorsInfo], Optional[TensorsInfo]]:
        """(input_info, output_info); either may be None if the backend can
        adapt to any input (then set_input_info decides)."""
        return None, None

    def set_input_info(self, in_info: TensorsInfo) -> TensorsInfo:
        """Given negotiated input shapes, return output shapes (reference
        getModelInfo(SET_INPUT_INFO))."""
        raise NotImplementedError(
            f"{self.NAME}: cannot infer output info from input"
        )

    def handle_event(self, name: str, data: Dict[str, Any]) -> None:
        """Custom events; ``reload_model`` by default re-opens."""
        if name == "reload_model" and self.props is not None:
            if not self.props.is_updatable:
                raise RuntimeError(
                    f"{self.NAME}: reload requested but is-updatable=false"
                )
            if "model" in data:
                self.props.model = data["model"]
            self.reload()

    def reload(self) -> None:
        props = self.props
        self.close()
        self.open(props)

    # -- framework-wide stats ------------------------------------------------
    @classmethod
    def global_stats(cls) -> InvokeStats:
        with cls._GLOBAL_STATS_LOCK:
            if cls.NAME not in cls._GLOBAL_STATS:
                cls._GLOBAL_STATS[cls.NAME] = InvokeStats(window=100)
            return cls._GLOBAL_STATS[cls.NAME]


# --------------------------------------------------------------------------
# Shared model representation (reference nnstreamer_plugin_api_filter.h:
# 577-602): instances with the same shared-tensor-filter-key reuse one
# loaded model (e.g. one set of device-resident weights for N pipelines).
# --------------------------------------------------------------------------
_shared: Dict[str, Any] = {}
_shared_lock = threading.Lock()


def shared_model_get(key: str) -> Optional[Any]:
    with _shared_lock:
        return _shared.get(key)


def shared_model_insert(key: str, model: Any) -> Any:
    """Insert if absent; returns the representative instance."""
    with _shared_lock:
        return _shared.setdefault(key, model)


def shared_model_remove(key: str) -> bool:
    with _shared_lock:
        return _shared.pop(key, None) is not None


# Backends shared by ``shared-tensor-filter-key``: filters with one key use
# one opened backend, so its weights sit on the device (and in the HBM
# accountant) once. Reference-counted: the last filter to let go closes it.
_shared_backends: Dict[str, list] = {}


def shared_backend_acquire(key: str, open_backend) -> "FilterFramework":
    """The backend shared under ``key``, opened by ``open_backend()`` for
    the first filter that names it."""
    with _shared_lock:
        entry = _shared_backends.get(key)
        if entry is None:
            entry = _shared_backends[key] = [open_backend(), 0]
        entry[1] += 1
        return entry[0]


def shared_backend_release(key: str, fw: "FilterFramework") -> None:
    """One filter lets go of the backend shared under ``key``; the last
    one closes it."""
    with _shared_lock:
        entry = _shared_backends.get(key)
        if entry is None or entry[0] is not fw:
            last = True  # not (or no longer) shared: close it alone
        else:
            entry[1] -= 1
            last = entry[1] <= 0
            if last:
                del _shared_backends[key]
    if last:
        fw.close()
