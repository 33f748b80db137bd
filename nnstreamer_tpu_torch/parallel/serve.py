"""The mesh-sharded SERVING plane: mesh specs, plans, and placements.

The JAX package's ``parallel/serve.py`` on the port's single-controller
mesh (``parallel/mesh.py``). A ``tensor_filter``'s (or fused region's)
``mesh=`` property names a mesh spec here, and everything that CONSTRUCTS
a placement on its behalf — batch placements for frame I/O, replicated/
rule-based weight placements, reshard moves — lives behind these
helpers. Lint rule NNS117 enforces exactly that: a ``Placement`` or
``ShardedTensor`` built outside ``parallel/`` is a finding, so every
placement decision stays auditable in one package.

Mesh-spec grammar
-----------------
``<axis><size>`` tokens joined with ``x``; axes are the framework's
canonical mesh axes (``dp``/``tp``/``sp``/``ep``/``pp``, see
``parallel.mesh``); size ``-1`` (or ``*``) means "the rest of the
devices". Examples::

    mesh=dp4        # 4-way batch (data) parallel
    mesh=dp8        # the CPU parity tests' 8 logical host devices
    mesh=dp2xtp2    # 2-way batch over a 2x2 mesh, weights replicated
                    # over tp unless the backend supplies param specs
    mesh=dp-1       # batch-shard over every visible device

A spec that needs more devices than there are raises at plan time
(``mesh=dp2`` on one card: "needs 2 devices, have 1"); it never narrows.

Serving semantics: the LEADING (batch) dimension of every frame tensor
shards over ``dp``; weights replicate over the whole mesh (one full copy
per device — which is exactly what the per-shard residency units
account). Each mesh device computes its own shard.

Matched-sharding contract
-------------------------
Two sharded invokers hand buffers to each other through
device-passthrough elements (queues). The hand-off moves ZERO bytes iff
the producer's out-placement equals the consumer's in-placement: the
producer then hands its :class:`~nnstreamer_tpu_torch.parallel.mesh.
ShardedTensor` outputs on as they are. ``pipeline/fuse.py`` verifies the
match at PLAN time (a mismatch is a hard :class:`MeshShardingError`
before any frame flows). Any RUNTIME placement that does move device
bytes between placements goes through :func:`place_batch`, which counts
them in ``nns_reshard_bytes_total`` — the counter that must stay 0
across matched boundaries. A host array (numpy, or a tensor on the CPU)
is scattered, an ingest upload, not a reshard.

Kill switch: ``NNSTPU_MESH=0`` (or no ``mesh=`` property anywhere) keeps
:func:`mesh_enabled` False; every caller then behaves byte-identically to
the single-device path.
"""

from __future__ import annotations

import itertools
import os
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.parallel.mesh import (
    P,
    Placement,
    ShardedTensor,
    make_mesh,
    shard_tensor,
    tree_leaves,
)
from nnstreamer_tpu_torch.tensors import memory as _memory

log = get_logger("mesh-serve")

_ENV = "NNSTPU_MESH"

#: canonical mesh axis names, in the order parallel/mesh.py documents them
MESH_AXES = ("dp", "tp", "sp", "ep", "pp")

#: buffer meta key: the canonical mesh spec whose plan produced the
#: buffer's (sharded) device tensors — stamped by sharded invokers
MESH_SPEC_META = "mesh-spec"


class MeshShardingError(RuntimeError):
    """A sharding contract violation caught at PLAN time: mismatched
    in/out placements across a device-passthrough boundary, mixed mesh
    specs inside one fused region, or an unparseable spec. Deliberately
    NOT a FlowError — fusion fallback must not swallow it."""


def mesh_enabled() -> bool:
    """The ``NNSTPU_MESH`` kill switch (default ON — the mesh only
    engages where a ``mesh=`` property asks for it anyway)."""
    return os.environ.get(_ENV, "1").strip().lower() not in (
        "0", "false", "no", "off"
    )


def parse_mesh_spec(spec: str) -> List[Tuple[str, int]]:
    """``"dp2xtp2"`` → ``[("dp", 2), ("tp", 2)]`` (see module docstring
    for the grammar). Raises :class:`MeshShardingError` on malformed
    specs so a typo is a plan-time error, not a silent single-device
    fallback."""
    text = str(spec or "").strip().lower()
    if not text:
        raise MeshShardingError("empty mesh spec")
    axes: List[Tuple[str, int]] = []
    seen = set()
    for token in text.split("x"):
        token = token.strip()
        name = None
        for cand in MESH_AXES:
            if token.startswith(cand):
                name = cand
                break
        if name is None:
            raise MeshShardingError(
                f"mesh spec {spec!r}: token {token!r} does not start with "
                f"one of the mesh axes {'/'.join(MESH_AXES)}")
        if name in seen:
            raise MeshShardingError(
                f"mesh spec {spec!r}: duplicate axis {name!r}")
        seen.add(name)
        size_text = token[len(name):]
        if size_text in ("*", ""):
            size = -1
        else:
            try:
                size = int(size_text)
            except ValueError:
                raise MeshShardingError(
                    f"mesh spec {spec!r}: bad size {size_text!r} for axis "
                    f"{name!r}") from None
        if size == 0 or size < -1:
            raise MeshShardingError(
                f"mesh spec {spec!r}: axis {name!r} size must be positive "
                f"or -1, got {size}")
        axes.append((name, size))
    return axes


class MeshPlan:
    """One parsed-and-built mesh spec: the Mesh plus the (cached)
    placements serving needs. Implements the same ``batched()`` /
    ``replicated()`` / ``num_devices`` surface as
    ``parallel.mesh.BatchSharding`` so filter backends treat either as
    "the sharding"."""

    def __init__(self, spec: str):
        self.spec = canonical_spec(spec)
        self.axes = parse_mesh_spec(spec)
        self.mesh = make_mesh(self.axes)
        self._batched = None
        self._replicated = None

    @property
    def shard_count(self) -> int:
        """Total devices in the mesh (= the dp fan-out times any inner
        axes; what ``nns_shard_count`` reports)."""
        return int(self.mesh.size)

    @property
    def num_devices(self) -> int:  # BatchSharding-compatible alias
        return self.shard_count

    @property
    def batch_axis(self) -> Optional[str]:
        return "dp" if any(n == "dp" for n, _ in self.axes) else None

    @property
    def dp_size(self) -> int:
        return int(self.mesh.shape["dp"]) if self.batch_axis else 1

    def sharding_for(self, x) -> Placement:
        """The placement for one frame tensor: :meth:`batched` when its
        leading dim splits evenly over ``dp``, else :meth:`replicated`
        — a ragged or sub-mesh batch (e.g. a flush tail, or a
        single-frame pipeline someone put ``mesh=dp8`` on) runs
        replicated instead of erroring. The mesh must never make a
        legal single-device pipeline illegal; it only speeds up the
        batches that actually split."""
        shape = getattr(x, "shape", None)
        if self.batch_axis and shape and len(shape) >= 1 \
                and shape[0] % self.dp_size == 0:
            return self.batched()
        return self.replicated()

    def batched(self) -> Placement:
        """Leading-dim (batch) placement over ``dp``; replicated when the
        mesh has no dp axis (still a valid — if pointless — plan)."""
        if self._batched is None:
            self._batched = Placement(
                self.mesh, P(self.batch_axis) if self.batch_axis else P())
        return self._batched

    def replicated(self) -> Placement:
        if self._replicated is None:
            self._replicated = Placement(self.mesh, P())
        return self._replicated

    def __repr__(self):
        return f"<MeshPlan {self.spec} {dict(self.mesh.shape)}>"


def canonical_spec(spec: str) -> str:
    """Normalized spec text (lowercased, stripped) — the comparison key
    for the matched-sharding contract and the plan cache."""
    return str(spec or "").strip().lower()


#: plan cache: one plan per spec and device set (the CPU's logical
#: device count can change between runs of one process)
_plans: Dict[tuple, MeshPlan] = {}
_plans_lock = threading.Lock()


def _plan_key(spec: str) -> tuple:
    from nnstreamer_tpu_torch.device import host_device_count, resolve_device

    dev = resolve_device()
    count = torch.cuda.device_count() if dev.type == "cuda" \
        else host_device_count()
    return canonical_spec(spec), dev.type, count


def get_mesh_plan(spec: str) -> MeshPlan:
    key = _plan_key(spec)
    with _plans_lock:
        plan = _plans.get(key)
    if plan is not None:
        return plan
    # build OUTSIDE the lock (mesh construction enumerates devices);
    # a racing builder loses to setdefault and its plan is dropped —
    # plans for one spec are interchangeable, so that is harmless
    built = MeshPlan(key[0])
    with _plans_lock:
        plan = _plans.setdefault(key, built)
    if plan is built:
        # the reshard counter exports (at 0) as soon as any mesh plan
        # exists: the matched-boundary gate asserts on it
        _reshard_counter()
        log.info("mesh plan %s: %d devices %s", key[0], plan.shard_count,
                 dict(plan.mesh.shape))
    return plan


# --------------------------------------------------------------------------
# reshard accounting — nns_reshard_bytes_total
# --------------------------------------------------------------------------
_m_reshard = None


def _reshard_counter():
    global _m_reshard
    if _m_reshard is None:
        from nnstreamer_tpu_torch.obs import get_registry

        _m_reshard = get_registry().counter(
            "nns_reshard_bytes_total",
            "Device bytes moved to FIX a placement mismatch at runtime "
            "(a device tensor re-placed onto a different placement). "
            "Stays 0 across matched boundaries — the zero-copy hand-off "
            "contract.")
    return _m_reshard


def reshard_bytes_total() -> int:
    """Current counter value (0 when no mesh plan ever resharded)."""
    return int(_m_reshard.value) if _m_reshard is not None else 0


def shardings_match(a, b) -> bool:
    """Whether two placements place data identically (the zero-copy
    hand-off test). None compares unequal to everything."""
    if a is None or b is None:
        return False
    try:
        return bool(a == b)
    except Exception:  # noqa: BLE001 — foreign placement types: not equal
        return False


def is_device_tensor(x) -> bool:
    """A tensor a mesh placement would MOVE (a reshard): a sharded tensor
    or a tensor on a card. Numpy arrays and CPU tensors are host data."""
    return isinstance(x, ShardedTensor) or (
        isinstance(x, torch.Tensor) and x.device.type != "cpu")


def place_batch(x, plan, shard_span: Optional[list] = None):
    """Place one frame tensor for a sharded invoke.

    - already a :class:`ShardedTensor` with the plan's placement for its
      shape → returned as-is, ZERO bytes moved (the matched hand-off);
    - a device tensor with any OTHER placement (a sharded tensor of
      another mesh, or a tensor on a card) → re-placed, and the moved
      bytes count into ``nns_reshard_bytes_total``;
    - a host array (numpy or a CPU tensor) → scattered (an ingest
      upload, counted upstream like every other, NOT a reshard).

    ``shard_span``, when given, collects ``(kind, nbytes)`` tuples so the
    caller can emit one flight-recorder ``shard`` span per invoke."""
    tgt = plan.sharding_for(x)
    if isinstance(x, ShardedTensor):
        if shardings_match(x.sharding, tgt):
            return x
        moved = int(x.nbytes)
        _reshard_counter().inc(moved)
        if shard_span is not None:
            shard_span.append(("reshard", moved))
        return shard_tensor(x.gather(), tgt)
    if is_device_tensor(x):
        moved = int(x.numel() * x.element_size())
        _reshard_counter().inc(moved)
        if shard_span is not None:
            shard_span.append(("reshard", moved))
        return shard_tensor(x, tgt)
    if shard_span is not None:
        shard_span.append(("scatter", int(getattr(x, "nbytes", 0))))
    return shard_tensor(x, tgt)


def place_on(x, sharding, count: bool = True):
    """``x`` on ``sharding``: a mesh plan or ``BatchSharding`` (its
    placement for ``x``'s shape) or a Placement. With ``count``, a device
    tensor moved off another placement counts into
    ``nns_reshard_bytes_total``, as in :func:`place_batch`; the JAX
    backend's ``custom=sharding:`` placement counts nothing."""
    tgt = sharding.sharding_for(x) if hasattr(sharding, "sharding_for") \
        else sharding
    if isinstance(x, ShardedTensor) and shardings_match(x.sharding, tgt):
        return x
    if count and is_device_tensor(x):
        _reshard_counter().inc(int(x.numel() * x.element_size()))
    return shard_tensor(gather(x), tgt)


def shard_outputs(per_device: List[List[torch.Tensor]],
                  inputs: List[ShardedTensor], mesh) -> List[ShardedTensor]:
    """One device's outputs per mesh device → one sharded tensor per
    output. An output whose leading dim is the first input's local batch
    keeps that input's batch placement; any other is replicated (every
    device computed the same)."""
    ref = inputs[0] if inputs else None
    out = []
    for shards in zip(*per_device):
        local = shards[0]
        if ref is not None and not ref.sharding.replicated and \
                local.dim() >= 1 and ref.shards[0].dim() >= 1 and \
                local.shape[0] == ref.shards[0].shape[0]:
            place = ref.sharding if len(ref.sharding.spec) == 1 else \
                Placement(mesh, P(ref.sharding.spec[0]))
            shape = (ref.shape[0],) + tuple(local.shape[1:])
        else:
            place, shape = Placement(mesh, P()), tuple(local.shape)
        out.append(ShardedTensor(list(shards), place, shape))
    return out


def gather(x, device=None):
    """``x`` as one tensor: a sharded tensor gathered onto ``device``
    (default its first shard's), anything else as it is."""
    return x.gather(device) if isinstance(x, ShardedTensor) else x


# --------------------------------------------------------------------------
# weight placement + per-shard accounting
# --------------------------------------------------------------------------
_place_ids = itertools.count()


def _per_device_nbytes(leaves) -> Dict[Any, int]:
    """Actual bytes each mesh device holds for ``leaves`` (from the
    tensors' addressable shards — exact for replicated AND rule-sharded
    placements)."""
    per: Dict[Any, int] = {}
    for leaf in leaves:
        shards = getattr(leaf, "addressable_shards", None)
        if not shards:
            continue
        for sh in shards:
            per[sh.device] = per.get(sh.device, 0) + \
                sh.data.numel() * sh.data.element_size()
    return per


def account_placement(placed: Any, label: str) -> None:
    """Register an externally-held sharded placement's per-device bytes
    with the active HBM accountant as PINNED per-shard residency units
    (the bytes show in ``nns_mem_used_bytes`` instead of hiding). The
    units un-register when the placed tree's first sharded tensor dies —
    they are accounting, not an eviction target, because the caller (the
    serving engine) holds the tensors and an eviction here could not
    actually free them."""
    acct = _memory.ACTIVE
    if acct is None:
        return
    leaves = [x for x in tree_leaves(placed) if isinstance(x, ShardedTensor)]
    if not leaves:
        return
    per = _per_device_nbytes(leaves)
    if not per:
        return
    base = f"place:{next(_place_ids)}:{label}"
    keys = []
    for k, (_dev, nbytes) in enumerate(sorted(
            per.items(), key=lambda kv: kv[0].id)):
        key = f"{base}:shard{k}"
        acct.residency.adopt(key, nbytes, label=f"{label}#shard{k}")
        keys.append(key)
    weakref.finalize(leaves[0], _release_placement, weakref.ref(acct),
                     tuple(keys))


def _release_placement(acct_ref, keys: Tuple[str, ...]) -> None:
    """Module-level finalizer target: retire a dead placement's pinned
    units against the SAME accountant that adopted them."""
    acct = acct_ref()
    if acct is None:
        return
    for key in keys:
        acct.residency.unregister(key)


def place_params(params: Dict[str, Any], mesh, specs: Dict[str, Any],
                 label: str = "params") -> Dict[str, ShardedTensor]:
    """Rule-sharded param placement WITH accounting: place each entry per
    its PartitionSpec and register the per-shard bytes with the budget
    accountant (when active)."""
    placed = {k: shard_tensor(v, Placement(mesh, specs[k]))
              for k, v in params.items()}
    account_placement(placed, label)
    return placed


def place_tree(tree: Any, mesh, spec_of: Callable[[Any], Any],
               label: str = "tree", register: bool = False) -> Any:
    """Mesh placement for a dict/list/tuple tree of tensors:
    ``spec_of(leaf)`` names each leaf's PartitionSpec. ``register=True``
    additionally accounts the per-shard bytes (off by default — e.g. a
    KV cache is working state the engine sizes on its own schedule)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if node is None:
            return None
        return shard_tensor(node, Placement(mesh, spec_of(node)))

    placed = walk(tree)
    if register:
        account_placement(placed, label)
    return placed

