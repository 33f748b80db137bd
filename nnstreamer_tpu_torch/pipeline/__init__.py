"""L3 pipeline core: pads, elements, events, the pipeline and its queue,
and the gst-launch-style pipeline-description parser."""

from nnstreamer_tpu_torch.pipeline.caps import Caps, CapsList, IntRange, ANY  # noqa: F401
from nnstreamer_tpu_torch.pipeline.element import (  # noqa: F401
    Element,
    Pad,
    PadDirection,
    FlowReturn,
    Event,
    CapsEvent,
    EosEvent,
    CustomEvent,
    FlowError,
)
from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline  # noqa: F401
from nnstreamer_tpu_torch.pipeline.parse import parse_launch  # noqa: F401
