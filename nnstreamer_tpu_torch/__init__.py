"""nnstreamer_tpu_torch — the PyTorch/CUDA port of nnstreamer_tpu.

The same typed multi-tensor streams, elements and gst-launch-style launch
strings as the JAX package ``nnstreamer_tpu``, with the compute in
PyTorch on an NVIDIA GPU (the package device, ``cuda:0`` unless
:func:`set_device` says otherwise). Each Pallas kernel of the JAX package
becomes a hand-written CUDA kernel (``csrc/``, built by ``nvcc`` at first
use); each has a plain PyTorch version beside it that CPU tensors take.

The package imports torch, numpy and the standard library — never JAX and
nothing of ``nnstreamer_tpu``.

Quick start (the flagship classification pipeline)::

    import nnstreamer_tpu_torch as nt
    from nnstreamer_tpu_torch.filters.torch_backend import register_torch_model
    from nnstreamer_tpu_torch.models.mobilenet_v2 import mobilenet_v2

    register_torch_model("mnv2", *mobilenet_v2(image_size=224))
    pipe = nt.parse_launch(
        "videotestsrc num-buffers=100 width=224 height=224 ! "
        "tensor_converter ! tensor_transform mode=arithmetic "
        "option=typecast:float32,add:-127.5,div:127.5 ! "
        "tensor_filter framework=jax model=mnv2 ! "
        "tensor_decoder mode=image_labeling option1=labels.txt ! "
        "queue max-size-buffers=32 prefetch-host=true ! "
        "tensor_sink name=out to-host=true")
    pipe.get("out").connect(lambda buf: print(buf.meta["label"]))
    pipe.run(timeout=120)
"""

__version__ = "0.1.0"

# before everything else: with NNSTPU_LOCKGRAPH set, the lock-order
# witness must patch the threading factories ahead of every module that
# creates locks at import time (obs/__init__ arms it as ITS first
# statement; with the env unset this import changes nothing)
import nnstreamer_tpu_torch.obs  # noqa: E402,F401

from nnstreamer_tpu_torch.device import (  # noqa: F401
    get_device,
    set_device,
    set_host_device_count,
)
from nnstreamer_tpu_torch.tensors.types import (  # noqa: F401
    TensorType,
    TensorFormat,
    TensorInfo,
    TensorsInfo,
    TensorsConfig,
    NNS_TENSOR_RANK_LIMIT,
    NNS_TENSOR_SIZE_LIMIT,
)
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer  # noqa: F401
from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline  # noqa: F401
from nnstreamer_tpu_torch.pipeline.parse import parse_launch  # noqa: F401
