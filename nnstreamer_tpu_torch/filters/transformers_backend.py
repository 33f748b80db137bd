"""HuggingFace ``transformers`` filter backend.

Port of ``nnstreamer_tpu/filters/transformers_backend.py`` (the
reference's heavyweight framework subplugins, ``tensor_filter_pytorch.cc``
among them): the ``model`` property names a local HF checkpoint directory
or a ``config.json`` (``local_files_only``: nothing is downloaded), and
the backend runs the architecture's PyTorch model on the filter's device.

Inputs map positionally: ``input_ids`` [, ``attention_mask``] (ones when
absent); outputs are the model's output tensors in declaration order
(``last_hidden_state`` and ``pooler_output`` for a bare encoder), left on
the device.

``custom=`` options (comma-separated ``key:value``), the JAX package's:

- ``arch:<AutoModel...>`` — the auto-class to load with (default
  ``AutoModel``); a ``Flax`` prefix is dropped.
- ``backend:flax|torch`` — both run the PyTorch model: the port has no
  Flax (ROADMAP C.48). The JAX package runs the Flax model jitted for
  ``flax`` (its default) and the PyTorch model on the host for ``torch``.
  Flax weights come across with :func:`state_dict_from_flax` (load them
  into the PyTorch model and ``save_pretrained`` the directory this
  filter loads).
- ``from_config:true`` — random weights from the config (made under a
  fixed torch seed, so two opens give the same model).

Output shapes are derived on the meta device. ``transformers`` is
imported at ``open()``: importing the port loads none of it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from nnstreamer_tpu_torch.device import resolve_device
from nnstreamer_tpu_torch.filters.api import (
    FilterFramework,
    FilterProperties,
    parse_custom,
)
from nnstreamer_tpu_torch.filters.torch_backend import _meta_twin
from nnstreamer_tpu_torch.registry import FILTER, subplugin
from nnstreamer_tpu_torch.tensors.buffer import as_torch
from nnstreamer_tpu_torch.tensors.types import TensorInfo, TensorsInfo, TensorType

#: the torch seed of a ``from_config`` model's random weights
FROM_CONFIG_SEED = 0


def state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A Flax parameter tree (nested dicts of numpy arrays, as
    ``jax.tree.map(np.asarray, flax_model.params)`` gives it) as the
    PyTorch model's ``state_dict``: path parts joined by ``.``; ``kernel``
    becomes ``weight``, transposed for a 2-D dense kernel (Flax ``[in,
    out]``) and permuted for a convolution (Flax ``[*spatial, in, out]``
    → ``[out, in, *spatial]``); ``scale`` (a norm) and ``embedding``
    become ``weight``; other leaves keep their names."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, prefix + (str(key),))
                continue
            arr = np.asarray(value)
            name = key
            if key == "kernel":
                name = "weight"
                if arr.ndim == 2:
                    arr = arr.T
                elif arr.ndim > 2:
                    arr = arr.transpose(arr.ndim - 1, arr.ndim - 2,
                                        *range(arr.ndim - 2))
            elif key in ("scale", "embedding"):
                name = "weight"
            out[".".join(prefix + (name,))] = torch.tensor(arr)  # a copy

    walk(params, ())
    return out


@subplugin(FILTER, "transformers")
class TransformersFilter(FilterFramework):
    NAME = "transformers"
    KEEP_ON_DEVICE = True

    def __init__(self):
        super().__init__()
        self._model: Optional[torch.nn.Module] = None
        self._device: Optional[torch.device] = None

    def open(self, props: FilterProperties) -> None:
        super().open(props)
        import transformers

        opts = parse_custom(props.custom)
        backend = opts.get("backend", "flax")
        if backend not in ("flax", "torch"):
            raise ValueError(f"transformers: backend must be flax or torch, "
                             f"got {backend!r}")
        arch = opts.get("arch", "AutoModel")
        if arch.startswith("Flax"):
            arch = arch[len("Flax"):]  # the PyTorch class (ROADMAP C.48)
        if not hasattr(transformers, arch):
            raise ValueError(f"transformers: unknown auto-class {arch!r}")
        cls = getattr(transformers, arch)
        path = props.model
        if not path:
            raise ValueError("transformers: model property required")
        self._device = resolve_device(props.accelerator)
        cfg = transformers.AutoConfig.from_pretrained(
            path, local_files_only=True)
        # eager attention: its mask needs no host read, so the output
        # shapes derive on the meta device (SDPA's mask helper asks
        # whether the mask is all ones)
        if opts.get("from_config", "").lower() in ("1", "true"):
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(FROM_CONFIG_SEED)
                model = cls.from_config(cfg, attn_implementation="eager")
        else:
            model = cls.from_pretrained(path, config=cfg,
                                        local_files_only=True,
                                        attn_implementation="eager")
        self._model = model.eval().to(self._device)

    def close(self) -> None:
        self._model = None
        super().close()

    def _forward(self, model, inputs: Sequence[torch.Tensor]
                 ) -> List[torch.Tensor]:
        ids = inputs[0].long()
        mask = inputs[1].long() if len(inputs) > 1 else torch.ones_like(ids)
        with torch.inference_mode():
            out = model(input_ids=ids, attention_mask=mask)
        return [v for v in out.to_tuple() if isinstance(v, torch.Tensor)]

    def set_input_info(self, in_info: TensorsInfo) -> TensorsInfo:
        meta = torch.device("meta")
        outs = self._forward(_meta_twin(self._model), [
            torch.empty(t.shape, dtype=t.type.torch_dtype, device=meta)
            for t in in_info])
        return TensorsInfo([
            TensorInfo(dim=tuple(reversed(tuple(o.shape))),
                       type=TensorType.from_any(o.dtype))
            for o in outs
        ])

    def invoke(self, inputs: Sequence[Any]) -> List[torch.Tensor]:
        xs = [as_torch(x, self._device, non_blocking=True) for x in inputs]
        with self.global_stats().measure():
            return self._forward(self._model, xs)
