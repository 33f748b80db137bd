"""Model zoo — the JAX package's networks as ``nn.Module``s.

Each factory returns ``(module, in_info, out_info)``, the arguments
``filters.torch_backend.register_torch_model`` takes after the name, and
each model module has a ``params_from_jax`` that maps the JAX model's
variables onto its ``state_dict``. The other models of the JAX package
wait for later slices (ROADMAP.md).
"""

from nnstreamer_tpu_torch.models.mobilenet_v2 import (  # noqa: F401
    mobilenet_v2,
    params_from_jax,
)
from nnstreamer_tpu_torch.models.ssd_mobilenet import ssd_mobilenet  # noqa: F401
from nnstreamer_tpu_torch.models.posenet import posenet  # noqa: F401
from nnstreamer_tpu_torch.models.lstm import lstm_cell  # noqa: F401
from nnstreamer_tpu_torch.models.yolo import yolo_detector  # noqa: F401
from nnstreamer_tpu_torch.models.segmenter import segmenter  # noqa: F401
from nnstreamer_tpu_torch.models.beam import BeamSearcher  # noqa: F401
