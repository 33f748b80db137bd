"""Config system: ini file + environment-variable overrides.

The same three-layer config as the JAX package (reference
``nnstreamer_conf.c``): an ini file (``$NNSTREAMER_TPU_CONF`` or the
default paths), ``NNSTREAMER_TPU_<GROUP>_<KEY>`` environment overrides,
and element properties. The port reads the element-restriction allowlist
at parse time and the per-extension framework priority for
``framework=auto``.
"""

from __future__ import annotations

import configparser
import os
import threading
from typing import Dict, List, Optional

ENV_CONF = "NNSTREAMER_TPU_CONF"
ENV_PREFIX = "NNSTREAMER_TPU_"
DEFAULT_CONF_PATHS = (
    os.path.expanduser("~/.config/nnstreamer_tpu.ini"),
    "/etc/nnstreamer_tpu.ini",
)

#: Default model-extension → framework priority (reference nnstreamer.ini.in
#: [filter] framework priorities). First loadable wins.
DEFAULT_EXT_PRIORITY: Dict[str, List[str]] = {
    ".pt": ["torch"],
    ".pth": ["torch"],
    # torch.export artifacts (filters/artifact.py)
    ".pt2": ["torch"],
    # the JAX package's flax weights with custom=module:<factory>
    ".msgpack": ["torch"],
    # the JAX package's StableHLO artifacts: the torch backend names
    # ROADMAP C.24 for them
    **{ext: ["torch"] for ext in (".jaxexp", ".stablehlo", ".mlir",
                                  ".mlirbc")},
    ".tflite": ["tflite"],
    ".py": ["python"],
    ".so": ["native", "custom"],
}

#: model files the torch backend recognises and refuses (C.24)
FOREIGN_MODEL_EXTS = (".jaxexp", ".stablehlo", ".mlir", ".mlirbc")


class Conf:
    """Parsed configuration with env overrides. Thread-safe singleton via
    :func:`get_conf`."""

    def __init__(self, path: Optional[str] = None):
        self._cp = configparser.ConfigParser()
        self.path = path or os.environ.get(ENV_CONF)
        if not self.path:
            for p in DEFAULT_CONF_PATHS:
                if os.path.isfile(p):
                    self.path = p
                    break
        if self.path and os.path.isfile(self.path):
            self._cp.read(self.path)

    def get(self, group: str, key: str, default: Optional[str] = None):
        """Env override first (NNSTREAMER_TPU_<GROUP>_<KEY>), then ini.
        Hyphenated group names also match their underscore spelling."""
        for g in (group.upper(), group.upper().replace("-", "_")):
            env = os.environ.get(f"{ENV_PREFIX}{g}_{key.upper()}")
            if env is not None:
                return env
        return self._cp.get(group, key, fallback=default)

    def get_bool(self, group: str, key: str, default: bool = False) -> bool:
        v = self.get(group, key)
        if v is None:
            return default
        return str(v).strip().lower() in ("1", "true", "yes", "on")

    def subplugin_paths(self, kind: str) -> List[str]:
        """Extra search paths for dynamically-discovered subplugins
        (reference [filter]/[decoder]/[converter] path keys;
        ``NNSTREAMER_TPU_<KIND>_PATH``)."""
        raw = self.get(kind, "path", "") or ""
        return [p for p in raw.split(os.pathsep) if p]

    def allowed_elements(self) -> Optional[set]:
        """Element allowlist, or ``None`` when restriction is off
        (reference ``enable-element-restriction`` + ``allowed-elements``).
        Restricted pipelines fail closed at parse time."""
        if not (self.get_bool("element-restriction",
                              "enable_element_restriction")
                or self.get_bool("element-restriction", "enable")):
            return None
        raw = (self.get("element-restriction", "allowed_elements")
               or self.get("element-restriction", "restricted_elements")
               or "")
        return {e for e in raw.replace(",", " ").split() if e}

    def framework_priority(self, model_path: str) -> List[str]:
        """Framework candidates for a model file, best first (reference
        framework auto-detect by extension, tensor_filter_common.c:1200)."""
        ext = os.path.splitext(model_path)[1].lower()
        key = f"framework_priority_{ext.lstrip('.')}"
        raw = self.get("filter", key)
        if raw:
            return [f.strip() for f in raw.split(",") if f.strip()]
        return list(DEFAULT_EXT_PRIORITY.get(ext, []))


_conf: Optional[Conf] = None
_lock = threading.Lock()


def get_conf(refresh: bool = False) -> Conf:
    global _conf
    with _lock:
        if _conf is None or refresh:
            _conf = Conf()
        return _conf
