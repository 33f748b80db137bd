"""The package device: where the port's tensors compute.

The port has one default device, ``cuda:0``. A caller asks for the CPU in
one of three ways: :func:`set_device` (``set_device("cpu")``) for the
whole package; ``NNSTPU_TORCH_DEVICE=cpu`` in the environment of a
process that never calls it (a fleet replica, given it through the
launcher's ``env=``, as the JAX package's replicas take
``JAX_PLATFORMS``); or a filter's ``accelerator`` property (``true:cpu``
or ``false``, the reference grammar of
``nnstreamer_plugin_api_filter.h:547-568``) for that filter. Resolving a
CUDA device when CUDA is unavailable raises: the port never carries on
on the CPU without being asked to.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Union

import torch

DEFAULT_DEVICE = "cuda:0"
#: the environment's package device, for a process that sets none
DEVICE_ENV = "NNSTPU_TORCH_DEVICE"

_lock = threading.Lock()
_device: Optional[torch.device] = None


def set_device(device: Union[str, torch.device, None]) -> None:
    """Set the package device (``"cpu"``, ``"cuda:1"``, ...); ``None``
    restores the default: ``NNSTPU_TORCH_DEVICE``, else ``cuda:0``."""
    global _device
    with _lock:
        _device = None if device is None else torch.device(device)


def get_device() -> torch.device:
    """The package device, as set by :func:`set_device`, else
    ``NNSTPU_TORCH_DEVICE``, else ``cuda:0``."""
    with _lock:
        if _device is not None:
            return _device
    return torch.device(os.environ.get(DEVICE_ENV) or DEFAULT_DEVICE)


def parse_accelerator(accelerator: Optional[str]) -> Optional[torch.device]:
    """Reference accelerator grammar → device, or None for "the package
    device". ``false`` and ``true:cpu`` mean the CPU; ``true:cuda`` and
    ``true:gpu`` the first card; any other accelerator name (``true:tpu``
    in launch strings written for the JAX package) the package device."""
    if not accelerator:
        return None
    parts = accelerator.split(":")
    if parts[0].strip().lower() in ("false", "0", "no"):
        return torch.device("cpu")
    name = parts[1].strip().lower() if len(parts) > 1 else ""
    if name == "cpu":
        return torch.device("cpu")
    if name in ("cuda", "gpu"):
        return torch.device(DEFAULT_DEVICE)
    return None


def resolve_device(accelerator: Optional[str] = None) -> torch.device:
    """The device an element should compute on: its ``accelerator``
    request, else the package device. Raises when that is a CUDA device
    and CUDA is unavailable."""
    dev = parse_accelerator(accelerator) or get_device()
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"nnstreamer_tpu_torch: device {dev} requested but CUDA is not "
            "available; call nnstreamer_tpu_torch.set_device('cpu') (or "
            "set NNSTPU_TORCH_DEVICE=cpu) to run the package on the CPU, "
            "or give a tensor_filter accelerator=true:cpu (a "
            "tensor_transform acceleration=false)")
    return dev
