"""python3 converter — user-script media→tensor converters (port of
``nnstreamer_tpu/converters/python3.py``; reference
``tensor_converter/tensor_converter_python3.cc``, 404 LoC). The script
defines::

    class Converter:
        def get_out_config(self, caps): ...   # optional
        def convert(self, buf, in_caps): ...

Two ways to use it:

- app registration: ``load_python_converter("myconv", "/path/s.py")``,
  then ``tensor_converter mode=custom-code:myconv``;
- conf-driven: set ``[converter] python3_script`` (or env
  ``NNSTREAMER_TPU_CONVERTER_PYTHON3_SCRIPT``) and use
  ``tensor_converter mode=custom-code:python3`` — the reference resolves
  its python subplugin paths through nnstreamer.ini the same way.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import threading

from nnstreamer_tpu_torch.registry import CONVERTER, register_subplugin, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer


def load_script(path: str, tag: str, cls_name: str = "Converter"):
    """Run the user script at ``path`` as module ``..._py_<tag>`` and
    return an instance of its class ``cls_name`` (the python3 converter's
    and decoder's loader)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(
        f"nnstreamer_tpu_torch_py_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    cls = getattr(mod, cls_name, None)
    if cls is None:
        raise ValueError(f"{path!r} must define class {cls_name}")
    return cls()


def load_python_converter(name: str, path: str) -> None:
    """Load a converter script and register it under ``name`` (apps call
    this; tensor_converter mode=custom-code:<name> then finds it)."""
    register_subplugin(CONVERTER, name, load_script(path, f"conv_{name}"))


@subplugin(CONVERTER, "python3")
class Python3Converter:
    """Conf-driven script converter: the script path comes from
    ``[converter] python3_script`` (env override supported)."""

    def __init__(self):
        self._obj = None
        self._key = None  # (path, mtime) — in-place edits reload
        self._lock = threading.Lock()

    def _load(self):
        from nnstreamer_tpu_torch.config import get_conf

        path = get_conf().get("converter", "python3_script")
        if not path:
            raise ValueError(
                "python3 converter: set [converter] python3_script in the "
                "conf (or NNSTREAMER_TPU_CONVERTER_PYTHON3_SCRIPT), or "
                "register a script with load_python_converter()")
        try:
            mtime = os.stat(path).st_mtime_ns
        except OSError:
            # script vanished/unreadable after a successful load: keep
            # serving the loaded object (pre-reload-support behavior)
            with self._lock:
                if self._obj is not None and path == self._key[0]:
                    return self._obj
            raise FileNotFoundError(path)
        key = (path, mtime)
        with self._lock:
            if self._obj is None or key != self._key:
                self._obj = load_script(path, "conv_conf")
                self._key = key
            return self._obj

    def get_out_config(self, caps):
        obj = self._load()
        if hasattr(obj, "get_out_config"):
            return obj.get_out_config(caps)
        return None

    def convert(self, buf: TensorBuffer, in_caps) -> TensorBuffer:
        return self._load().convert(buf, in_caps)
