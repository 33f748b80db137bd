"""L1 — tensor type system and buffers."""

from nnstreamer_tpu_torch.tensors.types import (  # noqa: F401
    TensorType,
    TensorFormat,
    TensorInfo,
    TensorsInfo,
    TensorsConfig,
    NNS_TENSOR_RANK_LIMIT,
    NNS_TENSOR_SIZE_LIMIT,
)
from nnstreamer_tpu_torch.tensors.buffer import (  # noqa: F401
    DeviceBuffer,
    TensorBuffer,
)
