"""flexbuf converter — FlexBuffers byte stream → tensors (reference
``tensor_converter/tensor_converter_flexbuf.cc``, 188 LoC). Inverse of
``decoders.flexbuf``; parses the reference wire layout. The
framework-native compact framing stays available as
``mode=nnstpu-flex``."""

from __future__ import annotations

import numpy as np

from nnstreamer_tpu_torch.decoders.flexbuf import decode_flex, decode_flexbuf
from nnstreamer_tpu_torch.registry import CONVERTER, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer


@subplugin(CONVERTER, "flexbuf")
class FlexBufConverter:
    """Reference-format FlexBuffers payload → tensors."""

    def get_out_config(self, caps):
        return None  # per-buffer shapes

    def convert(self, buf: TensorBuffer, in_caps) -> TensorBuffer:
        blob = np.ascontiguousarray(buf.to_host()[0]).tobytes()
        out = decode_flexbuf(blob)
        # keep the decoded wire meta (framerate/format/tensor_names) and
        # overlay the incoming buffer's own meta on top
        return out.replace(pts=buf.pts, meta={**out.meta, **buf.meta})


@subplugin(CONVERTER, "nnstpu-flex")
class NnstpuFlexConverter:
    """Framework-native compact flex framing → tensors."""

    def get_out_config(self, caps):
        return None

    def convert(self, buf: TensorBuffer, in_caps) -> TensorBuffer:
        blob = np.ascontiguousarray(buf.to_host()[0]).tobytes()
        out = decode_flex(blob)
        return out.replace(pts=buf.pts if out.pts is None else out.pts,
                           meta=dict(buf.meta))
