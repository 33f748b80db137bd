"""Multi-host (multi-process) runs.

The JAX package's ``parallel/multihost.py`` joins ``jax.distributed`` so
that one SPMD program spans the devices of every host. The port keeps
its single-controller mesh within a process and adds the processes on
the outermost axis: each process is one controller over its own devices
(the visible cards, or the logical host devices on the CPU), ``dp`` is
the outermost mesh axis and spans the processes, and each process feeds
its own rows of the global batch. A train step then adds one
cross-process all-reduce of its summed gradients (:func:`dp_mean`);
nothing else crosses processes.

Usage (the same script in every process)::

    from nnstreamer_tpu_torch.parallel import multihost

    multihost.initialize()            # env-driven; no-op single-process
    mesh = multihost.global_mesh([("dp", -1)])   # this process's part
    rows = multihost.local_batch_slice(global_batch)
    ...                               # make_train_step(cfg, mesh) as usual

Env:
  NNSTPU_COORDINATOR  host:port of process 0 (or MASTER_ADDR and
                      MASTER_PORT)
  NNSTPU_NUM_PROCESSES / NNSTPU_PROCESS_ID

The processes meet through ``torch.distributed``: ``nccl`` when the
package device is a card (one card a process: give each process its own
``CUDA_VISIBLE_DEVICES``), ``gloo`` when the CPU was asked for.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from nnstreamer_tpu_torch import device as _device
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.parallel.sharded import _move

log = get_logger("parallel.multihost")


def _coordinator() -> Optional[str]:
    addr = os.environ.get("NNSTPU_COORDINATOR")
    if addr:
        return addr
    host, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{host}:{port}" if host and port else None


def _joined() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Join the other processes. Explicit args beat env vars; with neither
    (or a single process) this is a no-op returning False — a
    single-process run never pays a coordinator round trip."""
    if _joined():
        return True
    coordinator_address = coordinator_address or _coordinator()
    if num_processes is None:
        env = os.environ.get("NNSTPU_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("NNSTPU_PROCESS_ID")
        process_id = int(env) if env else None
    if not coordinator_address or not num_processes or num_processes <= 1:
        return False
    if process_id is None:
        raise ValueError("multihost: NNSTPU_PROCESS_ID (or process_id=) is "
                         "needed with more than one process")
    import torch.distributed as dist

    dev = _device.resolve_device()
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))
    log.info("joined the process group: process %d/%d via %s (%s)",
             dist.get_rank(), dist.get_world_size(), coordinator_address,
             dist.get_backend())
    return True


def process_info() -> Tuple[int, int]:
    """(process_index, process_count) — (0, 1) when single-process."""
    if not _joined():
        return 0, 1
    import torch.distributed as dist

    return dist.get_rank(), dist.get_world_size()


def global_mesh(axes: Sequence[Tuple[str, int]]):
    """This process's part of a mesh over the devices of every process.
    An axis size of -1 absorbs the remaining device count, so the same
    spec works on any number of processes. Across processes the first
    axis must be ``dp``: it splits over the processes, and the returned
    mesh holds this process's share of it over its own devices."""
    from nnstreamer_tpu_torch.parallel.mesh import make_mesh, mesh_devices

    _, count = process_info()
    total = len(mesh_devices()) * count
    fixed = 1
    wildcard = None
    resolved = []
    for name, size in axes:
        if size == -1:
            if wildcard is not None:
                raise ValueError("only one axis may be -1")
            wildcard = name
            resolved.append((name, -1))
        else:
            fixed *= size
            resolved.append((name, size))
    if wildcard is not None:
        if total % fixed:
            raise ValueError(
                f"{total} devices not divisible by fixed axes ({fixed})")
        resolved = [(n, total // fixed if s == -1 else s)
                    for n, s in resolved]
    if count > 1:
        name, size = resolved[0]
        if name != "dp" or size % count:
            raise ValueError(
                f"across {count} processes the first mesh axis must be dp "
                f"and divide by the process count (got {resolved[0]})")
        resolved[0] = ("dp", size // count)
    return make_mesh(resolved)


def local_batch_slice(global_batch: int) -> slice:
    """Which rows of a global batch THIS process feeds (each process reads
    only its shard)."""
    idx, count = process_info()
    if global_batch % count:
        raise ValueError(
            f"global batch {global_batch} not divisible by {count} hosts")
    per = global_batch // count
    return slice(idx * per, (idx + 1) * per)


def host_local_to_global(arrays, mesh, pspec):
    """This process's rows placed on its part of the mesh: a
    ``ShardedTensor`` (``jax.make_array_from_process_local_data``'s
    counterpart: the global array is the processes' rows in order)."""
    from nnstreamer_tpu_torch.parallel import serve
    from nnstreamer_tpu_torch.parallel.mesh import Placement

    x = arrays if isinstance(arrays, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(arrays))
    return serve.place_on(x, Placement(mesh, pspec), count=False)


def dp_mean(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The mean of each tensor over the processes, by one all-reduce of
    them all flattened (the tensors themselves in a single-process
    run)."""
    if process_info()[1] == 1:
        return tensors
    import torch.distributed as dist

    dev = tensors[0].device
    flat = torch.cat([_move(t, dev).reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(_move(flat[off:off + n].view(t.shape).to(t.dtype), t.device))
        off += n
    return out
