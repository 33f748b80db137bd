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
- **Fusible.** :meth:`TorchFilter.device_stage` hands the module to a
  fused region (``pipeline/fuse.py``), which on the card replays it inside
  one CUDA graph with the elements around it.

Model forms accepted (``model`` property): a name registered with
:func:`register_torch_model`, or a ``.pt``/``.pth`` file holding TorchScript
or a pickled ``nn.Module`` (reference ``tensor_filter_pytorch.cc``), loaded
onto the chosen device.
"""

from __future__ import annotations

import copy
import os
import threading
import weakref
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


#: output shapes probed on a meta twin, per module: {(input shapes and
#: types, the module's weight shapes and types): output info}. The probe
#: is a pure function of those, and a meta forward of a whole model costs
#: every pipeline that names the module its start-up time.
_probed: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_probed_lock = threading.Lock()


def _meta_twin(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``module`` whose parameters and buffers are meta tensors of
    the same shapes and dtypes: shapes probe on it without data, and
    without touching ``module``, which other threads may be running (a
    registered module serves every pipeline that names it)."""
    memo = {}
    for p in module.parameters():
        memo[id(p)] = torch.nn.Parameter(torch.empty_like(p, device="meta"),
                                         requires_grad=p.requires_grad)
    for b in module.buffers():
        memo[id(b)] = torch.empty_like(b, device="meta")
    return copy.deepcopy(module, memo)


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
        key = None
        if dev.type == "meta":
            key = (tuple((tuple(i.shape), i.dtype) for i in ins),
                   tuple((k, tuple(v.shape), v.dtype) for k, v in
                         self._module.state_dict(keep_vars=True).items()))
            with _probed_lock:
                known = _probed.get(self._module, {}).get(key)
            if known is not None:
                self._out_info = known
                return known
        with torch.inference_mode():
            if dev.type == "meta":
                out = _meta_twin(self._module)(*ins)
            else:
                out = self._module(*ins)
        outs = [out] if isinstance(out, torch.Tensor) else list(out)
        self._out_info = TensorsInfo([
            TensorInfo(dim=tuple(reversed(tuple(o.shape))),
                       type=TensorType.from_any(o.dtype))
            for o in outs
        ])
        if key is not None:
            with _probed_lock:
                _probed.setdefault(self._module, {})[key] = self._out_info
        return self._out_info

    # -- region fusion (pipeline/fuse.py) ------------------------------------
    def device_stage(self):
        """The module as a fused-region stage: its consts are the module
        (the weights live in it), its key names the module object, and it
        computes on the backend's device."""
        if self._module is None:
            return None
        from nnstreamer_tpu_torch.pipeline.fuse import DeviceStage

        device = self._device

        def fn(module, tensors):
            xs = [as_torch(x, device, non_blocking=True) for x in tensors]
            with torch.inference_mode():
                out = module(*xs)
            return [out] if isinstance(out, torch.Tensor) else list(out)

        return DeviceStage(consts=self._module, fn=fn,
                           key=("torch", self._module), device=device)

    # -- hot path ------------------------------------------------------------
    def invoke(self, inputs: Sequence[Any]) -> List[torch.Tensor]:
        xs = [as_torch(x, self._device, non_blocking=True) for x in inputs]
        with self.global_stats().measure(), torch.inference_mode():
            out = self._module(*xs)
        return [out] if isinstance(out, torch.Tensor) else list(out)


# reference launch strings name framework=jax
register_subplugin(FILTER, "jax", TorchFilter)
