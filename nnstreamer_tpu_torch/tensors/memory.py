"""HBM budget accountant + weight/slab residency (the device-memory
resilience layer).

Port of ``nnstreamer_tpu/tensors/memory.py``; the accounting is the JAX
package's, held to it by ``tests/test_torch_memory.py``:

- **Budget accountant** (:class:`HbmBudget`). ``NNSTPU_HBM_BUDGET``
  (bytes; ``k``/``m``/``g`` suffixes) installs a process-wide accountant
  (``ACTIVE``). Every tracked entry point — ``TensorBuffer.to_device`` /
  ``upload_many`` frame transfers, ``BufferPool`` slabs, the torch
  backend's weights, the serving engine's paged arena and prefix cache —
  registers its bytes against the budget, keeping per-category used
  counters, a high-water mark, and the ``nns_mem_*`` gauges live.

- **Residency ladder** (:class:`ResidencyManager`). Model weights register
  as *evictable units*: a host copy of the state dict is kept as staging,
  the device copy is dropped under pressure (LRU) and re-loaded the next
  time the owning filter touches it. Two models whose weights sum past
  the budget thrash between resident and staged but keep serving
  byte-identical results from one pipeline.

- **Pressure accounting for the degrade ladder.** On budget breach the
  accountant first reclaims cold residency units inline (rung 1 of the
  pressure ladder in ``pipeline/supervise.py``); the remaining overage
  feeds :meth:`HbmBudget.admission_backlog`, the memory-backlog term the
  SLO scheduler adds to its admission estimate.

**What "memory" means on CUDA.** The budget counts registered bytes, as
the JAX accountant does. Nothing here decides from
``torch.cuda.mem_get_info`` or ``memory_reserved``: the caching allocator
keeps freed blocks, and each CUDA graph keeps a private pool.
:meth:`HbmBudget.snapshot` reports the allocator's own figures
(``allocator``: ``memory_allocated``, ``memory_reserved``,
``mem_get_info``) beside the accountant's, under their own names, when a
card is present.

Kill switch: with ``NNSTPU_HBM_BUDGET`` unset ``ACTIVE`` stays ``None``
and every hook in pool/buffer/backend code is one module-attribute read
plus an ``is None`` test.
"""

from __future__ import annotations

import contextlib
import os
import threading
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

from nnstreamer_tpu_torch.log import get_logger

log = get_logger("memory")

_ENV = "NNSTPU_HBM_BUDGET"

#: process-wide accountant; ``None`` (the default) means no budget and
#: zero accounting on any hot path. Hot sites read this directly
#: (``memory.ACTIVE``).
ACTIVE: Optional["HbmBudget"] = None

#: the degrade rungs, in escalation order — shared with
#: ``pipeline/supervise.py``. The JAX package's last rung, ``cpu``, has no
#: counterpart: the port halts after ``shed`` (ROADMAP C.29)
PRESSURE_RUNGS = ("evict", "pool", "shed")


def parse_bytes(text: str) -> int:
    """``"512m"`` → bytes. Accepts a plain integer or a ``k``/``m``/``g``
    (KiB/MiB/GiB) suffix, case-insensitive."""
    s = str(text).strip().lower()
    mult = 1
    for suf, m in (("g", 1 << 30), ("m", 1 << 20), ("k", 1 << 10),
                   ("b", 1)):
        if s.endswith(suf):
            s = s[: -len(suf)].strip()
            mult = m
            break
    try:
        val = float(s)
    except ValueError:
        raise ValueError(f"{_ENV}: cannot parse byte size {text!r}") \
            from None
    if val <= 0:
        raise ValueError(f"{_ENV}: byte size must be positive, got {text!r}")
    return int(val * mult)


def nbytes_of(obj: Any) -> int:
    """Byte size of a tensor, an array, a ``torch.nn.Module`` (its
    parameters and buffers), a state dict, or a list/tuple/dict of those
    (the registration size of a residency unit)."""
    import numpy as np
    import torch

    if isinstance(obj, torch.nn.Module):
        obj = obj.state_dict()
    if isinstance(obj, torch.Tensor):
        return int(obj.numel() * obj.element_size())
    if isinstance(obj, dict):
        return sum(nbytes_of(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(nbytes_of(v) for v in obj)
    n = getattr(obj, "nbytes", None)
    if n is None:
        n = np.asarray(obj).nbytes
    return int(n)


#: device-slot sentinel for PINNED units (adopted external placements):
#: "resident" without this manager holding the real arrays
_PINNED = object()


class ResidencyUnit:
    """One evictable device allocation: host staging + a loader that
    re-creates the device copy. The unit is the ONLY holder of the
    device reference — owners fetch it per use via :meth:`value` (which
    touches the LRU and reloads after an eviction), so dropping the
    unit's reference genuinely frees the HBM.

    Two mesh-serving variants:

    - ``group``: per-shard units of ONE sharded/replicated placement.
      The group loads as a whole (one loader call installs the device
      value into every member) and evicts as a whole — a single chip's
      slice of a mesh placement cannot be freed alone, so accounting
      must not pretend it can.
    - ``pinned``: accounting-only adoption of a placement whose arrays
      the OWNER holds (training params, a serving engine). Counted in
      ``nns_mem_used_bytes`` but never an eviction victim — evicting
      would free nothing while the owner's references live.
    - ``on_drop``: a DROPPABLE unit — owner-held bytes (like ``pinned``)
      that the owner can surrender on demand (a prefix-cache entry, a
      regenerable scratch buffer). Eviction calls ``on_drop(key)`` so
      the owner releases its reference, un-registers the bytes, and
      removes the unit — there is no host staging and no reload.

    ``category`` names the budget bucket the unit's bytes count under
    (``weights`` by default; the serving prefix/KV caches use
    ``kvcache``), so ``nns_mem_used_bytes`` splits honestly by owner
    kind instead of lumping every residency unit into weights.

    New in the port: ``on_evict`` frees the device storage when the unit
    is evicted or unregistered. A module's parameters are owned by the
    module, not by a value the unit could drop, so the torch backend
    swaps them for meta tensors there (``filters/torch_backend.py``).
    ``busy`` counts :meth:`ResidencyManager.hold` scopes: a unit whose
    weights a dispatch is reading is never an eviction victim, and one
    unregistered meanwhile keeps its storage until the last hold ends.
    """

    __slots__ = ("key", "label", "nbytes", "_host", "_loader", "_device",
                 "loads", "evictions", "group", "pinned", "category",
                 "on_drop", "on_evict", "busy", "retired")

    def __init__(self, key: str, host_value: Any, nbytes: int,
                 loader: Optional[Callable[[Any], Any]], label: str = "",
                 group: Optional[str] = None, pinned: bool = False,
                 category: str = "weights",
                 on_drop: Optional[Callable[[str], None]] = None,
                 on_evict: Optional[Callable[[], None]] = None):
        self.key = key
        self.label = label or key
        self.nbytes = int(nbytes)
        self._host = host_value
        self._loader = loader
        self._device: Any = None
        self.loads = 0
        self.evictions = 0
        self.group = group
        self.pinned = bool(pinned)
        self.category = category
        self.on_drop = on_drop
        self.on_evict = on_evict
        self.busy = 0
        #: unregistered while held: its bytes and storage go when the
        #: last hold ends
        self.retired = False

    @property
    def resident(self) -> bool:
        return self._device is not None

    def value(self) -> Any:
        """The device copy, loading it (back) in if evicted. Delegates to
        the manager so eviction-to-fit and LRU touch stay under one
        lock."""
        mgr = ACTIVE.residency if ACTIVE is not None else None
        if mgr is None:
            # accountant deactivated after registration (tests): serve
            # the host value; callers move it to the device
            return self._device if self._device is not None else self._host
        return mgr._ensure(self)


class ResidencyManager:
    """LRU over :class:`ResidencyUnit`\\ s. Eviction drops the device
    reference (the host staging copy persists), un-registers the bytes,
    and counts ``nns_mem_evictions_total``; the next :meth:`value` on the
    unit reclaims space from colder units and reloads — byte-identical
    because the loader round-trips the SAME host values."""

    def __init__(self, budget: "HbmBudget"):
        self._budget = budget
        self._lock = threading.RLock()
        #: key → unit, ordered coldest-first (OrderedDict as LRU)
        self._units: "OrderedDict[str, ResidencyUnit]" = OrderedDict()
        #: group name → member units (mesh per-shard groups)
        self._groups: Dict[str, list] = {}

    # -- registration -------------------------------------------------------
    def register(self, key: str, host_value: Any, nbytes: int,
                 loader: Callable[[Any], Any],
                 label: str = "", group: Optional[str] = None,
                 on_evict: Optional[Callable[[], None]] = None
                 ) -> ResidencyUnit:
        """Adopt a reloadable device allocation. Does NOT load — the
        first :meth:`ResidencyUnit.value` does, under the budget.
        ``group`` names a per-shard group: one loader call loads (and one
        eviction drops) every member together. ``on_evict`` frees the
        device storage the loader made."""
        unit = ResidencyUnit(key, host_value, int(nbytes), loader, label,
                             group=group, on_evict=on_evict)
        with self._lock:
            old = self._units.pop(key, None)
            if old is not None:
                self._evict_locked(old)
                self._drop_from_group(old)
            self._units[key] = unit
            if group is not None:
                self._groups.setdefault(group, []).append(unit)
        return unit

    def adopt(self, key: str, nbytes: int, label: str = ""
              ) -> ResidencyUnit:
        """Account an externally-held device placement (mesh-sharded
        training params, serving-engine weights) as a PINNED unit: the
        bytes register now and un-register at :meth:`unregister`; the
        unit is never an eviction victim because this manager does not
        hold the arrays and could free nothing."""
        unit = ResidencyUnit(key, None, int(nbytes), None, label,
                             pinned=True)
        unit._device = _PINNED
        with self._lock:
            old = self._units.pop(key, None)
            if old is not None:
                self._evict_locked(old)
                self._drop_from_group(old)
            self._units[key] = unit
        self._budget.register(unit.nbytes, "weights")
        return unit

    def register_droppable(self, key: str, nbytes: int,
                           on_drop: Callable[[str], None],
                           label: str = "", category: str = "kvcache"
                           ) -> ResidencyUnit:
        """Account owner-held bytes the owner can SURRENDER on demand (a
        prefix-cache entry, a regenerable scratch buffer). Unlike
        :meth:`adopt` the unit IS an eviction victim: under pressure the
        manager calls ``on_drop(key)`` (outside no locks the owner
        needs), un-registers the bytes and forgets the unit — there is
        no host staging and no reload. Registers under ``category`` so
        cache bytes show up as ``kvcache``, not ``weights``."""
        unit = ResidencyUnit(key, None, int(nbytes), None, label,
                             category=category, on_drop=on_drop)
        unit._device = _PINNED      # resident from creation, owner-held
        with self._lock:
            old = self._units.pop(key, None)
            if old is not None:
                self._evict_locked(old)
                self._drop_from_group(old)
            self._units[key] = unit
        self._budget.register(unit.nbytes, category)
        return unit

    def unregister(self, key: str) -> None:
        """Drop a unit (owner closed): its device bytes un-register and
        the host staging reference is released. A unit that a dispatch
        holds keeps its storage and its bytes until the hold ends."""
        with self._lock:
            unit = self._units.pop(key, None)
            if unit is None:
                return
            self._drop_from_group(unit)
            if unit.busy:
                unit.retired = True
                return
            self._retire_locked(unit)

    def _retire_locked(self, unit: ResidencyUnit) -> None:
        if unit.resident:
            unit._device = None
            self._budget.unregister(unit.nbytes, unit.category)
            if unit.on_evict is not None:
                unit.on_evict()
        unit._host = None

    def _drop_from_group(self, unit: ResidencyUnit) -> None:
        if unit.group is None:
            return
        members = self._groups.get(unit.group)
        if members is not None:
            members[:] = [u for u in members if u is not unit]
            if not members:
                self._groups.pop(unit.group, None)

    def _peers_locked(self, unit: ResidencyUnit) -> list:
        if unit.group is None:
            return [unit]
        return list(self._groups.get(unit.group, ())) or [unit]

    # -- residency ----------------------------------------------------------
    def _ensure(self, unit: ResidencyUnit) -> Any:
        with self._lock:
            if unit.resident:
                self._units.move_to_end(unit.key)  # LRU touch
                return unit._device
            # prefetch-on-route: make room among COLDER units, then load.
            # A grouped (per-shard) unit loads its WHOLE group in one
            # loader call — the placement is one sharded/replicated
            # pytree, so partial residency does not exist.
            peers = self._peers_locked(unit)
            needed = sum(p.nbytes for p in peers if not p.resident)
            self.reclaim(needed, keep=unit)
            dev = unit._loader(unit._host)
            unit.loads += 1
            if unit.loads > 1:
                self._budget._m["prefetches"].inc()
                _mark("mem_prefetch", unit=unit.label, nbytes=needed)
            for p in peers:
                if p.resident:
                    continue
                p._device = dev
                if p is not unit:
                    p.loads += 1
                self._units.move_to_end(p.key)
                self._budget.register(p.nbytes, p.category, reclaim=False)
            self._units.move_to_end(unit.key)
            return dev

    @contextlib.contextmanager
    def hold(self, unit: ResidencyUnit):
        """Load ``unit`` if evicted and keep it resident for the scope (a
        dispatch reading its weights); yields the unit's load count, which
        changes whenever its device storage was made anew."""
        with self._lock:
            self._ensure(unit)
            unit.busy += 1
            loads = unit.loads
        try:
            yield loads
        finally:
            with self._lock:
                unit.busy -= 1
                if unit.retired and not unit.busy:
                    self._retire_locked(unit)

    def _evict_locked(self, unit: ResidencyUnit) -> int:
        """Drop ``unit`` (and, for a grouped unit, its whole per-shard
        group) to host staging. Returns bytes freed. A unit held by a
        dispatch (:meth:`hold`) is skipped."""
        if not unit.resident or unit.pinned:
            return 0
        if any(p.busy for p in self._peers_locked(unit)):
            return 0
        if unit.on_drop is not None:
            # Droppable unit: no host staging — surrender the owner's
            # allocation entirely and forget the unit.
            unit._device = None
            unit.evictions += 1
            self._budget.unregister(unit.nbytes, unit.category)
            self._budget._m["evictions"].inc()
            self._units.pop(unit.key, None)
            try:
                unit.on_drop(unit.key)
            except Exception:  # noqa: BLE001 — owner callback, best-effort
                log.warning("on_drop callback for %s raised", unit.label,
                            exc_info=True)
            _mark("mem_evict", unit=unit.label, nbytes=unit.nbytes)
            log.info("dropped cache unit %s (%d bytes)", unit.label,
                     unit.nbytes)
            return unit.nbytes
        freed = 0
        for p in self._peers_locked(unit):
            if not p.resident:
                continue
            p._device = None
            p.evictions += 1
            freed += p.nbytes
            self._budget.unregister(p.nbytes, p.category)
            self._budget._m["evictions"].inc()
            if p.on_evict is not None:
                p.on_evict()
        _mark("mem_evict", unit=unit.label, nbytes=freed)
        log.info("evicted residency unit %s (%d bytes) to host staging",
                 unit.label, freed)
        return freed

    def reclaim(self, needed: int, keep: Optional[ResidencyUnit] = None
                ) -> int:
        """Evict coldest-first until ``needed`` bytes fit under the
        budget (or no evictable units remain). Returns bytes freed."""
        freed = 0
        with self._lock:
            keep_group = keep.group if keep is not None else None
            for unit in list(self._units.values()):
                if self._budget.headroom() >= needed:
                    break
                if unit is keep or unit.pinned or not unit.resident:
                    continue
                if keep_group is not None and unit.group == keep_group:
                    continue  # the touched unit's own shard peers
                freed += self._evict_locked(unit)
        return freed

    def evict_all(self) -> int:
        """Pressure-ladder rung 1: drop every resident unit to host
        staging. They reload on their next touch. Pinned units stay —
        their arrays are owner-held and an eviction would free
        nothing."""
        freed = 0
        with self._lock:
            # list(): droppable units delete themselves from _units
            # mid-eviction, which would break a live dict iterator.
            for unit in list(self._units.values()):
                if unit.resident and not unit.pinned:
                    freed += self._evict_locked(unit)
        return freed

    def resident_count(self) -> int:
        with self._lock:
            return sum(1 for u in self._units.values() if u.resident)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            units = [{"key": u.key, "label": u.label, "nbytes": u.nbytes,
                      "resident": u.resident, "loads": u.loads,
                      "evictions": u.evictions, "group": u.group,
                      "pinned": u.pinned, "category": u.category}
                     for u in self._units.values()]
        return {"units": units,
                "resident": sum(1 for u in units if u["resident"])}

    # -- serving continuity --------------------------------------------------
    # (checkpoint_state/restore_state, distinct from the reporting
    # snapshot() above)
    def checkpoint_state(self) -> Dict[str, Any]:
        """Durable state for ``Pipeline.checkpoint()``: the LRU order,
        coldest-first, by LABEL. Unit keys embed ``id()``s and are not
        stable across processes; labels (the model identity) are."""
        with self._lock:
            return {"lru": [u.label for u in self._units.values()]}

    def restore_state(self, state: Dict[str, Any]) -> None:
        """Re-impose a saved LRU order onto the units the new process
        registered: each saved label's first matching unit moves to the
        warm end in saved order, so the first pressure event evicts the
        same victims the old process would have. Units with no saved
        label (new models) end up coldest — they have no history to
        claim warmth from."""
        order = state.get("lru") or []
        with self._lock:
            by_label: Dict[str, list] = {}
            for key, u in self._units.items():
                by_label.setdefault(u.label, []).append(key)
            for label in order:
                keys = by_label.get(label)
                if keys:
                    self._units.move_to_end(keys.pop(0))


class HbmBudget:
    """Process-wide device-memory budget: tracked entry points register
    and un-register bytes per category (``weights`` / ``pool`` /
    ``frames``); a register that breaches the limit reclaims cold
    residency units inline and counts a pressure event. The budget is
    advisory accounting, not an allocator — a breach degrades (evict,
    shed) rather than fails the allocation."""

    def __init__(self, limit_bytes: int):
        self.limit = int(limit_bytes)
        if self.limit <= 0:
            raise ValueError("HBM budget must be positive")
        self._lock = threading.RLock()
        self._used: Dict[str, int] = {}
        self.high_water = 0
        self.pressure_events = 0
        #: EWMA of per-frame H2D bytes — converts memory overage into the
        #: synthetic frame backlog the SLO scheduler adds at admission
        self._frame_bytes_ewma = 0.0
        self.residency = ResidencyManager(self)
        self._m = self._make_metrics()

    def _make_metrics(self) -> Dict[str, Any]:
        from nnstreamer_tpu_torch.obs import get_registry

        reg = get_registry()
        ref = weakref.ref(self)
        reg.gauge("nns_mem_budget_bytes",
                  "Configured HBM budget (NNSTPU_HBM_BUDGET)",
                  fn=lambda: (ref().limit if ref() is not None else 0))
        reg.gauge("nns_mem_used_bytes",
                  "Bytes currently registered against the HBM budget "
                  "(weights + pool slabs + in-flight frame transfers)",
                  fn=lambda: (ref().used_bytes() if ref() is not None
                              else 0))
        reg.gauge("nns_mem_high_water_bytes",
                  "High-water mark of registered device bytes",
                  fn=lambda: (ref().high_water if ref() is not None
                              else 0))
        reg.gauge("nns_mem_resident_units",
                  "Residency units currently holding a device copy",
                  fn=lambda: (ref().residency.resident_count()
                              if ref() is not None else 0))
        return {
            "evictions": reg.counter(
                "nns_mem_evictions_total",
                "Residency units evicted to host staging under budget "
                "pressure"),
            "prefetches": reg.counter(
                "nns_mem_prefetches_total",
                "Evicted residency units reloaded to the device on "
                "route"),
            "pressure": {
                rung: reg.counter(
                    "nns_mem_pressure_events_total",
                    "Pressure-ladder rungs taken (budget breach or "
                    "injected OOM)", rung=rung)
                for rung in PRESSURE_RUNGS
            },
        }

    # -- accounting (hot path) ----------------------------------------------
    def register(self, nbytes: int, category: str = "frames",
                 reclaim: bool = True) -> None:
        """Account ``nbytes`` of device memory to ``category``. On breach
        the accountant reclaims cold residency units inline (pressure
        rung 1); any remaining overage is visible to the scheduler via
        :meth:`admission_backlog`."""
        n = int(nbytes)
        if n <= 0:
            return
        with self._lock:
            self._used[category] = self._used.get(category, 0) + n
            used = sum(self._used.values())
            if used > self.high_water:
                self.high_water = used
            breached = used > self.limit
        if breached and reclaim:
            self.pressure_events += 1
            self.count_pressure("evict")
            _mark("mem_pressure", used=used, limit=self.limit,
                  category=category)
            self.residency.reclaim(0)

    def unregister(self, nbytes: int, category: str = "frames") -> None:
        n = int(nbytes)
        if n <= 0:
            return
        with self._lock:
            cur = self._used.get(category, 0) - n
            if cur <= 0:
                self._used.pop(category, None)
                if cur < 0:
                    log.warning("HBM budget underflow in category %r "
                                "(%d bytes over-released)", category, -cur)
            else:
                self._used[category] = cur

    def note_h2d(self, nbytes: int, owner: Any = None) -> None:
        """Register an H2D frame transfer. ``owner`` (the Python wrapper
        holding the device tensors — a (Device)Buffer, not a tensor)
        un-registers the bytes when it dies, so frame bytes track the
        live working set, not cumulative traffic."""
        n = int(nbytes)
        if n <= 0:
            return
        with self._lock:
            a = 0.2
            self._frame_bytes_ewma = (
                n if self._frame_bytes_ewma == 0.0
                else (1 - a) * self._frame_bytes_ewma + a * n)
        self.register(n, "frames")
        if owner is not None:
            try:
                weakref.finalize(owner, _finalize_frames, weakref.ref(self),
                                 n)
            except TypeError:
                # not weakref-able: count the transfer but let the bytes
                # expire immediately rather than leak forever
                self.unregister(n, "frames")

    # -- state --------------------------------------------------------------
    def used_bytes(self) -> int:
        with self._lock:
            return sum(self._used.values())

    def headroom(self) -> int:
        return self.limit - self.used_bytes()

    def overage(self) -> int:
        return max(0, -self.headroom())

    def breached(self) -> bool:
        return self.used_bytes() > self.limit

    def admission_backlog(self) -> int:
        """The memory-backlog term for ``SloScheduler.decide``: current
        overage expressed in frames (via the per-frame H2D byte EWMA), so
        sustained pressure inflates the admission estimate and new work
        sheds at the door. Pure state read — no waits, no clock."""
        over = self.overage()
        if over <= 0:
            return 0
        with self._lock:
            per_frame = self._frame_bytes_ewma
        if per_frame <= 0:
            return 1
        return max(1, int(over / per_frame))

    def count_pressure(self, rung: str) -> None:
        c = self._m["pressure"].get(rung)
        if c is not None:
            c.inc()

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            used = dict(self._used)
        res = self.residency.snapshot()
        out = {
            "budget_bytes": self.limit,
            "used_bytes": sum(used.values()),
            "used_by_category": used,
            "high_water_bytes": self.high_water,
            "headroom_bytes": self.limit - sum(used.values()),
            "evictions": int(self._m["evictions"].value),
            "prefetches": int(self._m["prefetches"].value),
            "pressure_events": self.pressure_events,
            "resident_units": res["resident"],
            "units": res["units"],
        }
        alloc = allocator_snapshot()
        if alloc is not None:
            out["allocator"] = alloc
        return out


def allocator_snapshot() -> Optional[Dict[str, int]]:
    """The CUDA caching allocator's own figures for the package device,
    for reports only (never a decision input: freed blocks stay reserved,
    and a live CUDA graph's private pool is invisible to the budget).
    None without a card."""
    import torch

    from nnstreamer_tpu_torch.device import get_device

    dev = get_device()
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    free, total = torch.cuda.mem_get_info(dev)
    return {"memory_allocated": int(torch.cuda.memory_allocated(dev)),
            "memory_reserved": int(torch.cuda.memory_reserved(dev)),
            "max_memory_allocated":
                int(torch.cuda.max_memory_allocated(dev)),
            "mem_get_info_free": int(free),
            "mem_get_info_total": int(total)}


def _finalize_frames(budget_ref, nbytes: int) -> None:
    """Module-level finalizer target: un-register a dead frame wrapper's
    H2D bytes against the SAME accountant that registered them (a
    re-activated accountant must not absorb stale releases)."""
    budget = budget_ref()
    if budget is not None:
        budget.unregister(nbytes, "frames")


def _mark(kind: str, **args) -> None:
    from nnstreamer_tpu_torch.obs import timeline as _timeline

    tl = _timeline.ACTIVE
    if tl is not None:
        tl.mark(kind, None, track="memory", **args)


# --------------------------------------------------------------------------
# activation (the NNSTPU_FAULTS/NNSTPU_TRACE kill-switch discipline)
# --------------------------------------------------------------------------
def activate(limit_bytes: int) -> HbmBudget:
    """Install a fresh process-wide accountant and return it."""
    global ACTIVE
    ACTIVE = HbmBudget(int(limit_bytes))
    log.info("HBM budget active: %d bytes", ACTIVE.limit)
    return ACTIVE


def deactivate() -> None:
    global ACTIVE
    ACTIVE = None


def maybe_activate_env() -> Optional[HbmBudget]:
    """``Pipeline.start()`` hook: honor ``NNSTPU_HBM_BUDGET`` without
    code changes. Idempotent; an explicitly installed accountant wins."""
    if ACTIVE is not None:
        return ACTIVE
    spec = os.environ.get(_ENV, "").strip()
    if not spec:
        return None
    return activate(parse_bytes(spec))
