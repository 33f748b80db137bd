"""The PyTorch filter backend — the port's inference path on the card.

The counterpart of the JAX package's ``filters/jax_backend.py``: it
implements the FilterFramework vtable with an ``nn.Module`` on the
package device. It registers as ``framework=torch`` and also answers to
``framework=jax``, so launch strings written for the JAX package run
unchanged.

- **Weights live on the device once.** ``open()`` moves the module to its
  device; every invoke reuses it.
- **Device tensors in, device tensors out.** Inputs move to the module's
  device (a no-op for tensors already there); outputs stay there, computed
  under ``torch.inference_mode()``. CUDA launches are asynchronous, so
  ``invoke()`` returns before the card finishes.
- **Shapes are probed on the meta device**: no data, no kernels.
- ``accelerator=true:cpu`` (or ``false``) runs the same code on the CPU.

Model forms accepted (``model`` property): a name registered with
:func:`register_torch_model`, or a ``.pt``/``.pth`` file holding TorchScript
or a pickled ``nn.Module`` (reference ``tensor_filter_pytorch.cc``), loaded
onto the chosen device.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Sequence

import torch

from nnstreamer_tpu_torch.device import resolve_device
from nnstreamer_tpu_torch.filters.api import FilterFramework, FilterProperties
from nnstreamer_tpu_torch.registry import FILTER, register_subplugin, subplugin
from nnstreamer_tpu_torch.tensors.buffer import as_torch
from nnstreamer_tpu_torch.tensors.types import TensorInfo, TensorsInfo, TensorType

_registered: Dict[str, dict] = {}
_reg_lock = threading.Lock()


def register_torch_model(name: str, module: torch.nn.Module,
                         in_info: Optional[TensorsInfo] = None,
                         out_info: Optional[TensorsInfo] = None) -> None:
    """Register ``module`` under ``name`` for ``tensor_filter model=name``.
    Shapes may be left None: they are then derived from the negotiated
    input caps on the meta device."""
    with _reg_lock:
        _registered[name] = dict(module=module, in_info=in_info,
                                 out_info=out_info)


def unregister_torch_model(name: str) -> bool:
    with _reg_lock:
        return _registered.pop(name, None) is not None


def _load_file(path: str, device: torch.device) -> torch.nn.Module:
    try:
        return torch.jit.load(path, map_location=device)
    except (RuntimeError, ValueError):  # not TorchScript
        loaded = torch.load(path, map_location=device, weights_only=False)
    if not isinstance(loaded, torch.nn.Module):
        raise ValueError(
            f"torch: {path!r} is neither TorchScript nor an nn.Module")
    return loaded


@subplugin(FILTER, "torch")
class TorchFilter(FilterFramework):
    NAME = "torch"
    KEEP_ON_DEVICE = True

    def __init__(self):
        super().__init__()
        self._module: Optional[torch.nn.Module] = None
        self._device: Optional[torch.device] = None
        self._in_info: Optional[TensorsInfo] = None
        self._out_info: Optional[TensorsInfo] = None

    # -- lifecycle -----------------------------------------------------------
    def open(self, props: FilterProperties) -> None:
        super().open(props)
        self._device = resolve_device(props.accelerator)
        model = props.model
        if not model:
            raise ValueError("torch: model not set")
        name = model.split(":", 1)[1] if model.startswith("registered:") \
            else model
        with _reg_lock:
            entry = dict(_registered[name]) if name in _registered else None
        if entry is None:
            if not os.path.isfile(model):
                raise ValueError(f"torch: cannot load model {model!r} (not "
                                 "registered, not a .pt/.pth file)")
            entry = dict(module=_load_file(model, self._device),
                         in_info=None, out_info=None)
        self._module = entry["module"].to(self._device).eval()
        self._in_info = props.input_info or entry["in_info"]
        self._out_info = props.output_info or entry["out_info"]

    def close(self) -> None:
        self._module = None
        super().close()

    # -- model info ----------------------------------------------------------
    def get_model_info(self):
        return self._in_info, self._out_info

    def set_input_info(self, in_info: TensorsInfo) -> TensorsInfo:
        """Derive output shapes on the meta device (no data, no kernels);
        a TorchScript module, which cannot run on meta tensors, is probed
        with one zero forward pass on its device."""
        self._in_info = in_info
        if isinstance(self._module, torch.jit.ScriptModule):
            dev = self._device
        else:
            dev = torch.device("meta")
        ins = [torch.zeros(i.shape, dtype=i.type.torch_dtype, device=dev)
               for i in in_info]
        with torch.inference_mode():
            if dev.type == "meta":
                state = {k: torch.empty_like(v, device="meta")
                         for k, v in self._module.state_dict(
                             keep_vars=True).items()}
                out = torch.func.functional_call(self._module, state,
                                                 tuple(ins))
            else:
                out = self._module(*ins)
        outs = [out] if isinstance(out, torch.Tensor) else list(out)
        self._out_info = TensorsInfo([
            TensorInfo(dim=tuple(reversed(tuple(o.shape))),
                       type=TensorType.from_any(o.dtype))
            for o in outs
        ])
        return self._out_info

    # -- hot path ------------------------------------------------------------
    def invoke(self, inputs: Sequence[Any]) -> List[torch.Tensor]:
        xs = [as_torch(x, self._device, non_blocking=True) for x in inputs]
        with self.global_stats().measure(), torch.inference_mode():
            out = self._module(*xs)
        return [out] if isinstance(out, torch.Tensor) else list(out)


# reference launch strings name framework=jax
register_subplugin(FILTER, "jax", TorchFilter)
