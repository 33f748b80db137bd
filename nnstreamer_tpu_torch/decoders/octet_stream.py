"""octet_stream decoder — tensors → raw byte stream.

Port of ``nnstreamer_tpu/decoders/octet_stream.py``. Reference:
``ext/nnstreamer/tensor_decoder/tensordec-octetstream.c``: concatenates
the tensor payloads into ``application/octet-stream`` bytes. A host-only
mode: the decoder element fetches a device payload first (one D2H).
"""

from __future__ import annotations

import numpy as np

from nnstreamer_tpu_torch.elements.sink import tensor_bytes
from nnstreamer_tpu_torch.pipeline.caps import Caps
from nnstreamer_tpu_torch.registry import DECODER, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer


@subplugin(DECODER, "octet_stream")
class OctetStream:
    def out_caps(self, config, options) -> Caps:
        return Caps("application/octet-stream", {})

    def decode(self, buf: TensorBuffer, config, options) -> TensorBuffer:
        blob = b"".join(tensor_bytes(t) for t in buf.tensors)
        return buf.with_tensors([np.frombuffer(blob, np.uint8)])
