"""Model zoo — the JAX package's networks as ``nn.Module``s.

Each factory returns ``(module, in_info, out_info)``, the arguments
``filters.torch_backend.register_torch_model`` takes after the name, and
each model module has a ``params_from_jax`` that maps the JAX model's
variables onto its ``state_dict`` and an ``args_from_state`` that reads
the factory arguments a converted checkpoint's shapes fix.

:data:`FACTORIES` names them as ``custom=module:<factory>`` does: the
JAX package's ``.msgpack`` checkpoints load through :func:`from_jax`.
"""

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from nnstreamer_tpu_torch.models import (
    audio_classifier as _audio,
    lstm as _lstm,
    mobilenet_v2 as _mobilenet_v2,
    posenet as _posenet,
    segmenter as _segmenter,
    ssd_mobilenet as _ssd,
    transformer as _transformer,
    yolo as _yolo,
)
from nnstreamer_tpu_torch.models.mobilenet_v2 import (  # noqa: F401
    mobilenet_v2,
    params_from_jax,
)
from nnstreamer_tpu_torch.models.ssd_mobilenet import ssd_mobilenet  # noqa: F401
from nnstreamer_tpu_torch.models.posenet import posenet  # noqa: F401
from nnstreamer_tpu_torch.models.lstm import lstm_cell  # noqa: F401
from nnstreamer_tpu_torch.models.transformer import transformer_lm  # noqa: F401
from nnstreamer_tpu_torch.models.yolo import yolo_detector  # noqa: F401
from nnstreamer_tpu_torch.models.segmenter import segmenter  # noqa: F401
from nnstreamer_tpu_torch.models.audio_classifier import audio_classifier  # noqa: F401
from nnstreamer_tpu_torch.models.beam import BeamSearcher  # noqa: F401


class ZooModel(NamedTuple):
    #: ``(**kwargs) -> (module, in_info, out_info)``
    factory: Callable
    #: the JAX model's variables (numpy leaves) → the module's state dict
    params_from_jax: Callable
    #: a converted state dict → the factory arguments its shapes fix
    args_from_state: Callable


def _zoo(mod, factory) -> ZooModel:
    return ZooModel(factory, mod.params_from_jax, mod.args_from_state)


#: ``custom=module:<name>`` → the model's factory and converters
FACTORIES: Dict[str, ZooModel] = {
    "mobilenet_v2": _zoo(_mobilenet_v2, mobilenet_v2),
    "ssd_mobilenet": _zoo(_ssd, ssd_mobilenet),
    "posenet": _zoo(_posenet, posenet),
    "lstm_cell": _zoo(_lstm, lstm_cell),
    "yolo_detector": _zoo(_yolo, yolo_detector),
    "segmenter": _zoo(_segmenter, segmenter),
    "audio_classifier": _zoo(_audio, audio_classifier),
    "transformer_lm": _zoo(_transformer, transformer_lm),
}


def _numpy_leaves(tree: Any) -> Any:
    """Every tensor leaf as a numpy array (a bfloat16 one widened to
    float32, exactly), so the converters read it as the JAX package's."""
    if isinstance(tree, dict):
        return {k: _numpy_leaves(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree


def from_jax(name: str, variables: Any) -> Tuple[torch.nn.Module, Any, Any]:
    """The zoo model ``name`` built with the factory arguments the JAX
    variables' shapes fix and loaded with their values: ``(module,
    in_info, out_info)``. Raises ``ValueError`` for an unknown name, and
    for variables that are not the model's or that no factory argument
    fits (naming the tensor)."""
    zoo = FACTORIES.get(name)
    if zoo is None:
        raise ValueError(f"torch: unknown model factory {name!r}")
    try:
        state = zoo.params_from_jax(_numpy_leaves(variables))
    except (KeyError, TypeError, IndexError) as e:
        raise ValueError(f"torch: the checkpoint is not a {name} "
                         f"checkpoint (no leaf {e})") from e
    module, in_info, out_info = zoo.factory(**zoo.args_from_state(state))
    want = module.state_dict()
    missing = sorted(set(want) - set(state))
    extra = sorted(set(state) - set(want))
    if missing or extra:
        raise ValueError(f"torch: the checkpoint does not match {name} "
                         f"(missing {missing[:4]}, unexpected {extra[:4]})")
    for k, v in state.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(
                f"torch: for parameter {k!r} of {name} the factory's "
                f"arguments give shape {tuple(want[k].shape)}, but the "
                f"checkpoint holds shape {tuple(v.shape)}; no argument of "
                "the factory fits it")
    module.load_state_dict(state)
    return module, in_info, out_info
