"""Device meshes, placements and sharded tensors: one controller, many
devices.

The JAX package's ``parallel/mesh.py`` builds a ``jax.sharding.Mesh`` and
lets XLA place arrays by ``NamedSharding``. PyTorch's ``DeviceMesh`` and
DTensor are SPMD, one process per rank, which would turn one
``tensor_filter mesh=dp4`` into four processes. The port keeps the JAX
package's element model instead: one pipeline process drives every
device of the mesh.

- :class:`Mesh` is an array of devices with axis names. On the card the
  devices are the visible cards (``cuda:0`` .. ``cuda:<n-1>``); on the
  CPU, asked for with ``set_device("cpu")``, they are
  ``device.host_device_count()`` logical host devices that all compute
  on the one CPU (the counterpart of
  ``--xla_force_host_platform_device_count``).
- :class:`Placement` (``NamedSharding``'s counterpart) names which mesh
  axis splits each tensor dimension (:class:`PartitionSpec`); a
  dimension no axis names is replicated.
- :class:`ShardedTensor` is one tensor per mesh device plus its
  placement: the surface the serving plane reads (``.sharding``,
  ``addressable_shards``, ``nbytes``, :meth:`ShardedTensor.gather`).

The mesh axes used throughout the framework, as in the JAX package:

- ``dp`` — data/batch parallelism (mux-batched frames split over devices);
- ``tp`` — tensor parallelism (attention heads / mlp hidden sharded);
- ``sp`` — sequence/context parallelism (ring attention, ``ring.py``);
- ``pp`` — pipeline stages of the layer stack (``pipeline.py``);
- ``ep`` — expert parallelism (MoE experts, one group per device set).

Every placement is built here or in ``parallel/serve.py`` (lint rule
NNS117): callers name a mesh spec or pass a plan.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, \
    Sequence, Tuple

import numpy as np
import torch

from nnstreamer_tpu_torch import device as _device


class MeshDevice(NamedTuple):
    """One device of a mesh: its index among the mesh-capable devices and
    the torch device it computes on (the CPU for every logical host
    device)."""

    id: int
    device: torch.device

    def __str__(self) -> str:
        return f"{self.device.type}:{self.id}"


def mesh_devices() -> List[MeshDevice]:
    """Every device a mesh may span, in order (``device.mesh_devices``)."""
    return [MeshDevice(i, d) for i, d in enumerate(_device.mesh_devices())]


class Mesh:
    """A named array of :class:`MeshDevice` (``jax.sharding.Mesh``'s
    surface: ``shape``, ``axis_names``, ``size``, ``devices``)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of rank {self.devices.ndim} given "
                             f"{len(self.axis_names)} axis names")
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> List[MeshDevice]:
        """The devices in row-major (flat) order: a sharded tensor's
        shards follow it."""
        return list(self.devices.flat)

    def coords(self) -> List[Dict[str, int]]:
        """Each flat device's coordinate, by axis name."""
        return [dict(zip(self.axis_names, idx))
                for idx in np.ndindex(*self.devices.shape)]

    def _ident(self) -> tuple:
        return (self.axis_names, tuple(self.devices.shape),
                tuple(d.id for d in self.devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._ident() == other._ident()

    def __hash__(self) -> int:
        return hash(self._ident())

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"[{', '.join(str(d) for d in self.devices.flat)}])")


def make_mesh(axes: Sequence[Tuple[str, int]], devices=None) -> Mesh:
    """Build a Mesh from (name, size) pairs; size -1 means "the rest".

    make_mesh([("dp", -1), ("tp", 2)]) on 8 devices → 4×2 mesh. A mesh
    that needs more devices than there are raises: it never narrows."""
    devices = list(devices if devices is not None else mesh_devices())
    total = len(devices)
    sizes = [s for _, s in axes]
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may have size -1")
    known = math.prod(s for s in sizes if s != -1)
    if -1 in sizes:
        if total % known:
            raise ValueError(f"{total} devices not divisible by {known}")
        sizes[sizes.index(-1)] = total // known
    need = math.prod(sizes)
    if need > total:
        raise ValueError(f"mesh {sizes} needs {need} devices, have {total}")
    arr = np.empty(need, dtype=object)
    for i, d in enumerate(devices[:need]):  # subset is fine
        arr[i] = d
    return Mesh(arr.reshape(sizes), axis_names=[n for n, _ in axes])


class PartitionSpec(tuple):
    """The mesh axis (or None) that splits each tensor dimension, leading
    dimensions first; dimensions past its length are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _trim(spec: Sequence[Optional[str]]) -> tuple:
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def _bounds(n: int, parts: int, k: int) -> Tuple[int, int]:
    """Part ``k`` of ``n`` split ``parts`` ways (the first ``n % parts``
    parts one longer, as ``torch.tensor_split``)."""
    base, extra = divmod(n, parts)
    start = k * base + min(k, extra)
    return start, start + base + (1 if k < extra else 0)


class Placement:
    """Where a tensor lives on a mesh: ``jax.sharding.NamedSharding``'s
    counterpart. Two placements are equal when their meshes and their
    specs (trailing replicated dimensions dropped) are."""

    def __init__(self, mesh: Mesh, spec: Sequence[Optional[str]] = ()):
        self.mesh = mesh
        self.spec = PartitionSpec(*_trim(spec))
        for a in self.spec:
            if a is not None and a not in mesh.axis_names:
                raise ValueError(f"placement {self.spec} names axis {a!r} "
                                 f"absent from the mesh {mesh.axis_names}")

    @property
    def replicated(self) -> bool:
        return all(a is None for a in self.spec)

    def local_slices(self, shape: Sequence[int]) -> List[Tuple[slice, ...]]:
        """Each flat mesh device's slice of a tensor of ``shape``."""
        if len(self.spec) > len(shape):
            raise ValueError(f"placement {self.spec} has more dimensions "
                             f"than a tensor of shape {tuple(shape)}")
        out = []
        for coord in self.mesh.coords():
            sl = []
            for dim, n in enumerate(shape):
                axis = self.spec[dim] if dim < len(self.spec) else None
                if axis is None:
                    sl.append(slice(None))
                else:
                    lo, hi = _bounds(int(n), self.mesh.shape[axis],
                                     coord[axis])
                    sl.append(slice(lo, hi))
            out.append(tuple(sl))
        return out

    def __eq__(self, other) -> bool:
        return isinstance(other, Placement) and self.mesh == other.mesh \
            and tuple(self.spec) == tuple(other.spec)

    def __hash__(self) -> int:
        return hash((self.mesh, tuple(self.spec)))

    def __repr__(self) -> str:
        return f"Placement({self.spec!r}, {self.mesh.shape})"


class Shard(NamedTuple):
    """One device's part of a sharded tensor."""

    device: MeshDevice
    data: torch.Tensor


class ShardedTensor:
    """One tensor per mesh device (flat mesh order) and their placement.

    ``shape``/``dtype``/``nbytes`` describe the global tensor; a shard's
    storage is its device's own (a replicated dimension holds a full copy
    on every device). :meth:`gather` assembles the global tensor on one
    device."""

    def __init__(self, shards: Sequence[torch.Tensor], sharding: Placement,
                 shape: Sequence[int]):
        if len(shards) != sharding.mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of "
                             f"{sharding.mesh.size} devices")
        self.shards = list(shards)
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = self.shards[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return int(math.prod(self.shape))

    def element_size(self) -> int:
        return self.shards[0].element_size()

    @property
    def nbytes(self) -> int:
        """Bytes of the global tensor (one copy)."""
        return self.numel() * self.element_size()

    @property
    def device(self) -> torch.device:
        """The first shard's device (where :meth:`gather` assembles)."""
        return self.shards[0].device

    @property
    def addressable_shards(self) -> List[Shard]:
        return [Shard(d, t) for d, t in
                zip(self.sharding.mesh.device_list(), self.shards)]

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default: the first shard's):
        each distinct slice copied once, from the first device that holds
        it."""
        dev = torch.device(device) if device is not None else self.device
        if self.sharding.replicated or self.sharding.mesh.size == 1:
            # one copy holds it all (a one-device mesh: no copy at all)
            return self.shards[0].to(dev)  # nns-lint: disable=NNS113 -- a gather at the mesh's egress: the shards' bytes were placed (and counted) by serve
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        done = set()
        for sl, t in zip(self.sharding.local_slices(self.shape),
                         self.shards):
            key = tuple((s.start, s.stop) for s in sl)
            if key in done:
                continue
            done.add(key)
            out[sl] = t.to(dev)  # nns-lint: disable=NNS113 -- a gather at the mesh's egress: the shards' bytes were placed (and counted) by serve
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, dtype="
                f"{self.dtype}, {self.sharding!r})")


def shard_tensor(x: Any, placement: Placement) -> ShardedTensor:
    """Place ``x`` (a tensor or array, on any device) on ``placement``:
    each mesh device gets its own copy of its slice. A shard that already
    lies on its device (a one-device mesh) is that slice, not a copy."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    shards = []
    for sl, md in zip(placement.local_slices(t.shape),
                      placement.mesh.device_list()):
        part = t[sl]
        if placement.mesh.size > 1 or part.device != md.device:
            part = part.to(md.device, copy=True)  # nns-lint: disable=NNS113 -- a placement: serve.place_* count or register its bytes
        shards.append(part)
    return ShardedTensor(shards, placement, t.shape)


def tree_leaves(tree: Any) -> Iterable[Any]:
    """The tensors (and sharded tensors) of a dict/list/tuple tree or a
    cache object with ``leaves()``."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    elif hasattr(tree, "leaves") and callable(tree.leaves):
        yield from tree.leaves()
    elif tree is not None:
        yield tree


class BatchSharding:
    """Shard the leading (batch) dim of filter I/O over a 1-D mesh axis —
    the torch backend's ``custom=sharding:<axis>`` option."""

    def __init__(self, axis: str = "dp", mesh=None):
        self.axis = axis
        self.mesh = mesh if mesh is not None else make_mesh([(axis, -1)])

    def batched(self) -> Placement:
        return Placement(self.mesh, P(self.axis))

    def replicated(self) -> Placement:
        return Placement(self.mesh, P())

    def sharding_for(self, x) -> Placement:
        """:meth:`batched` when the leading dim splits evenly, else
        :meth:`replicated` (``MeshPlan.sharding_for``'s rule)."""
        shape = getattr(x, "shape", None)
        if shape and len(shape) >= 1 and \
                shape[0] % self.mesh.shape[self.axis] == 0:
            return self.batched()
        return self.replicated()

    @property
    def num_devices(self) -> int:
        return int(np.prod(list(self.mesh.shape.values())))


def batch_sharding(axis: str = "dp", mesh=None) -> BatchSharding:
    return BatchSharding(axis=axis, mesh=mesh)
