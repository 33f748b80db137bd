"""Model zoo — the JAX package's networks as ``nn.Module``s.

Each factory returns ``(module, in_info, out_info)``, the arguments
``filters.torch_backend.register_torch_model`` takes after the name. The
other models of the JAX package wait for later slices (ROADMAP.md).
"""

from nnstreamer_tpu_torch.models.mobilenet_v2 import (  # noqa: F401
    mobilenet_v2,
    params_from_jax,
)
