"""ops — the port's hand-written CUDA kernels, each with its plain PyTorch
version beside it.

Each kernel replaces one Pallas kernel of the JAX package (ROADMAP.md,
queue B). Sources live in ``nnstreamer_tpu_torch/csrc`` and are built by
``nvcc`` at first use (``ops/_build.py``). A wrapper runs the plain version
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
Kernel B2 lives in ``ops.flash_attention`` (the module, not re-exported
here under its function's name), kernel B3 in ``ops.quantize``.
"""

from nnstreamer_tpu_torch.ops._counts import (  # noqa: F401
    LAUNCHES,
    reset_launches,
)
from nnstreamer_tpu_torch.ops.preprocess import (  # noqa: F401
    normalize_chain,
    normalize_chain_reference,
    normalize_u8,
)
