"""python3 decoder — user-script decoders.

Port of ``nnstreamer_tpu/decoders/python3.py``.

Reference: ``ext/nnstreamer/tensor_decoder/tensordec-python3.cc`` (405 LoC):
loads a user script whose class implements getOutCaps/decode. Here the
script (option1) defines::

    class Decoder:
        def out_caps(self, config, options): ...   # optional
        def decode(self, buf, config, options): ...
"""

from __future__ import annotations

import os

from nnstreamer_tpu_torch.converters.python3 import load_script
from nnstreamer_tpu_torch.pipeline.caps import Caps
from nnstreamer_tpu_torch.registry import DECODER, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer


@subplugin(DECODER, "python3")
class Python3Decoder:
    def __init__(self):
        self._obj = None
        self._path = None

    def _load(self, options):
        path = options.get("option1")
        if not path:
            raise ValueError("python3 decoder: option1=<script.py> required")
        if self._obj is None or path != self._path:
            tag = os.path.basename(path).replace(".", "_")
            self._obj = load_script(path, f"dec_{tag}", "Decoder")
            self._path = path
        return self._obj

    def out_caps(self, config, options) -> Caps:
        obj = self._load(options)
        if hasattr(obj, "out_caps"):
            return obj.out_caps(config, options)
        return Caps("other/tensors", {"format": "flexible"})

    def decode(self, buf: TensorBuffer, config, options) -> TensorBuffer:
        return self._load(options).decode(buf, config, options)
