"""L3 stream elements.

Importing this package registers every element the port has with its
ELEMENT registry (the reference registers its elements in one gst plugin,
``gst/nnstreamer/registerer/nnstreamer.c:85-116``). The gRPC elements
register with or without grpcio, which they import at ``start()``.
``tensor_lm_serve`` imports no model code until its engine is looked up.
"""

from nnstreamer_tpu_torch.pipeline.pipeline import Queue  # noqa: F401 (registers "queue")
from nnstreamer_tpu_torch.pipeline.parse import CapsFilter  # noqa: F401 ("capsfilter")

from nnstreamer_tpu_torch.elements import source  # noqa: F401
from nnstreamer_tpu_torch.elements import sink  # noqa: F401
from nnstreamer_tpu_torch.elements import converter  # noqa: F401
from nnstreamer_tpu_torch.elements import aggregator  # noqa: F401
from nnstreamer_tpu_torch.elements import transform  # noqa: F401
from nnstreamer_tpu_torch.elements import filter as filter_element  # noqa: F401
from nnstreamer_tpu_torch.elements import decoder  # noqa: F401
from nnstreamer_tpu_torch.elements import lm_serve  # noqa: F401
from nnstreamer_tpu_torch.elements import quant  # noqa: F401
from nnstreamer_tpu_torch.elements import query  # noqa: F401
from nnstreamer_tpu_torch.elements import pubsub  # noqa: F401 (+ mqttsink/mqttsrc)
from nnstreamer_tpu_torch.elements import rate  # noqa: F401
from nnstreamer_tpu_torch.elements import tee  # noqa: F401
from nnstreamer_tpu_torch.elements import mux  # noqa: F401
from nnstreamer_tpu_torch.elements import merge  # noqa: F401
from nnstreamer_tpu_torch.elements import repo  # noqa: F401
from nnstreamer_tpu_torch.elements import demux  # noqa: F401
from nnstreamer_tpu_torch.elements import split  # noqa: F401
from nnstreamer_tpu_torch.elements import join  # noqa: F401
from nnstreamer_tpu_torch.elements import cond  # noqa: F401
from nnstreamer_tpu_torch.elements import crop  # noqa: F401
from nnstreamer_tpu_torch.elements import sparse  # noqa: F401

from nnstreamer_tpu_torch.elements import grpc_io  # noqa: F401 (grpcio itself
# is imported lazily inside the elements' start())
