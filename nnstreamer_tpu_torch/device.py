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

The serving mesh (``parallel/``) spans :func:`mesh_devices`: the visible
cards, or, on the CPU, :func:`set_host_device_count` logical host
devices (default 1), the counterpart of XLA's
``--xla_force_host_platform_device_count``. Logical host devices all
compute on the one CPU; each holds its own shards.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional, Union

import torch

DEFAULT_DEVICE = "cuda:0"
#: the environment's package device, for a process that sets none
DEVICE_ENV = "NNSTPU_TORCH_DEVICE"

_lock = threading.Lock()
_device: Optional[torch.device] = None
_host_devices = 1


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


def set_host_device_count(n: int) -> None:
    """The number of logical host devices a mesh on the CPU spans (XLA's
    ``--xla_force_host_platform_device_count``); ``1`` restores the
    default."""
    global _host_devices
    n = int(n)
    if n < 1:
        raise ValueError(f"host device count must be >= 1, got {n}")
    with _lock:
        _host_devices = n


def host_device_count() -> int:
    with _lock:
        return _host_devices


def mesh_devices() -> List[torch.device]:
    """The devices a serving mesh spans, in order: ``cuda:0`` ..
    ``cuda:<n-1>`` when the package device is a card (raising, as
    :func:`resolve_device`, when CUDA is unavailable), else
    :func:`host_device_count` entries of the CPU, one per logical host
    device."""
    dev = resolve_device()
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * host_device_count()
