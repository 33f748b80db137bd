"""protobuf converter — serialized Tensors message → tensors (reference
``tensor_converter/tensor_converter_protobuf.cc``, 89 LoC). Inverse of
``decoders.protobuf_codec``."""

from __future__ import annotations

import numpy as np

from nnstreamer_tpu_torch.decoders.protobuf_codec import decode_protobuf
from nnstreamer_tpu_torch.registry import CONVERTER, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer


@subplugin(CONVERTER, "protobuf")
class ProtobufConverter:
    def get_out_config(self, caps):
        return None

    def convert(self, buf: TensorBuffer, in_caps) -> TensorBuffer:
        blob = np.ascontiguousarray(buf.to_host()[0]).tobytes()
        out = decode_protobuf(blob)
        # keep the decoded wire meta (framerate/format/tensor_names) and
        # overlay the incoming buffer's own meta on top
        return out.replace(pts=buf.pts, meta={**out.meta, **buf.meta})
