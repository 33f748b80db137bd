"""Ingest buffer pool — recycled, aligned host staging buffers.

Port of ``nnstreamer_tpu/tensors/pool.py``. Per-frame payloads (a
``videotestsrc`` frame, a converter stack, an aggregator window) come out
of a reused allocation instead of a fresh numpy array per buffer, as the
reference's ``tensor_allocator`` and GStreamer's ``GstBufferPool`` do:

- **Size-classed free lists.** Requests round up to a power-of-two byte
  class; a released slab serves any same-class request regardless of
  shape/dtype (the view is re-derived per acquire).
- **Aligned.** Views start on ``align`` (default 64) byte boundaries.
- **Page-locked on the card.** When the package device is CUDA, a slab is
  a ``torch.empty(..., dtype=torch.uint8, pin_memory=True)`` and the pool
  hands out numpy views of its ``.numpy()``: only a copy from page-locked
  memory with ``non_blocking=True`` is an asynchronous DMA. A failed pin
  raises; the pool never falls back to pageable memory on the card. On a
  CPU device, or with no card at all, a slab is a plain numpy array.
- **Safe recycling.** ``acquire`` registers a GC finalizer on the view it
  hands out: a buffer that flows to the end of a pipeline and is dropped
  returns its slab to the free list when its last reference dies. The
  finalizer never takes the pool's lock: the cyclic GC can run it on a
  thread that is inside one of the pool's locked blocks (any allocation
  there may start a collection), and a plain ``Lock`` would then wait on
  itself forever. It appends ``(token, seq)`` to a ``deque`` (``append``
  is atomic), and every locked block drains those tokens first
  (:meth:`BufferPool._drain_locked`). An ``RLock`` would also end the
  hang, but the finalizer would then change ``_out``/``_free``/``_pinned``
  in the middle of the outer block; draining at the top of a block keeps
  every block's view of them whole. ``seq`` tells a dead view's token
  from a live view that reuses its ``id()``.
  ``release`` is the explicit fast path for owners that know the array is
  dead (the dispatch window fencing the batch that read a staging
  buffer); it detaches the finalizer so a recycled id can never
  double-free. Both paths refcount-check the slab before recycling: numpy
  collapses view chains (``frame[None].base`` is the slab), so a live
  derived view downstream means the slab is dropped to plain GC instead of
  being handed to the next acquire.
- **Copies in flight.** ``copy_(…, non_blocking=True)`` returns before the
  DMA has read the slab, and the pool's recycling bypasses PyTorch's
  caching host allocator, which would otherwise protect the block. So
  every host→device copy from a pool array records a CUDA event after the
  copy (:func:`note_copy`, called by ``tensors/buffer.py``), and
  ``acquire`` hands a free slab out only once its event has completed.
  The copies read the slab through :func:`pinned_view`, a tensor view of
  the slab's own storage, so the caching host allocator also records them
  and keeps a dropped slab's memory until they are done.

Instrumented with ``nns_pool_hits_total`` / ``nns_pool_misses_total`` /
``nns_pool_grows_total`` counters and ``nns_pool_outstanding`` /
``nns_pool_bytes_held`` gauges. Disable with ``NNSTPU_POOL=0`` (acquire
then returns plain ``np.empty``).

**Window slabs.** ``tensors/buffer.py`` ``upload_many`` stages one
drained run's frames in ONE contiguous slab: ``acquire_window`` carves
per-frame slot views out of a single pool allocation so the whole run
crosses H2D as one copy. ``contiguous_window_view`` is the zero-copy fast
path for frames already written into consecutive slots of one slab.

**Lane arenas.** :func:`get_lane_pool` gives each ingest lane
(``pipeline/lanes.py``) its own arena, distinct from :func:`get_pool`, so
N lane workers never serialize on one free-list lock. A lane slab that
reaches an H2D copy is gated exactly as a shared one: :func:`note_copy`
records the copy's event with whichever arena holds the slab, and that
arena's ``acquire`` waits it out. A lane worker calls CUDA only to
page-lock a new slab (``cudaHostAlloc``) and, in ``acquire``, to query a
copy event; a CUDA-graph capture on another thread in ``thread_local``
mode (``pipeline/fuse.py``) permits both.

The ``pool.alloc`` fault hook (``_alloc_fault_check``) fires on the
slab-growth path only. Under an HBM budget (``tensors/memory.py``) every
slab the pool holds counts under the accountant's ``pool`` category
(:func:`_mem_account`): registered when it is made, unregistered when it
leaves the pool.
"""

from __future__ import annotations

import collections
import functools
import itertools
import os
import sys
import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

#: smallest size class in bytes — tiny requests all share one class
_MIN_CLASS = 256


def pool_enabled() -> bool:
    return os.environ.get("NNSTPU_POOL", "1").strip().lower() not in (
        "0", "false", "no", "off"
    )


def _size_class(nbytes: int) -> int:
    if nbytes <= _MIN_CLASS:
        return _MIN_CLASS
    return 1 << (nbytes - 1).bit_length()


def _pin_slabs() -> bool:
    """Slabs are page-locked while the package device is a card that is
    there (without one, host-only pipelines stage in pageable memory and
    every element that needs the card raises on its own)."""
    from nnstreamer_tpu_torch.device import get_device

    return get_device().type == "cuda" and torch.cuda.is_available()


def _alloc_fault_check() -> None:
    """``pool.alloc`` chaos hook on the slab-growth (miss) path only —
    the recycled-slab hot path never pays. Resolved via sys.modules so
    the tensors layer never imports the pipeline layer: an injector can
    only exist once its module is imported."""
    faults = sys.modules.get("nnstreamer_tpu_torch.pipeline.faults")
    if faults is None:
        return
    fi = faults.ACTIVE
    if fi is not None:
        fi.check("pool.alloc")


def _mem_account(nbytes: int, grow: bool) -> None:
    """Register (``grow``) or unregister slab bytes with the HBM budget
    accountant under its ``pool`` category, so the pressure ladder's
    ``pool`` rung has a number to reclaim. Resolved through
    ``sys.modules``: with no accountant this is one dict lookup."""
    mem = sys.modules.get("nnstreamer_tpu_torch.tensors.memory")
    acct = mem.ACTIVE if mem is not None else None
    if acct is None:
        return
    if grow:
        acct.register(nbytes, "pool")
    else:
        acct.unregister(nbytes, "pool")


def _new_slab(nbytes: int, pinned: bool) -> np.ndarray:
    if not pinned:
        return np.empty(nbytes, np.uint8)
    # raises when the memory cannot be page-locked: no pageable fallback
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True).numpy()


@functools.lru_cache(maxsize=None)
def _torch_dtype(np_dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


def _slab_of(arr) -> Optional[np.ndarray]:
    """The 1-D uint8 slab behind a pool view or a view derived from one
    (numpy collapses ``.base`` to the slab), else None."""
    base = getattr(arr, "base", None)
    if isinstance(base, np.ndarray) and base.ndim == 1 and \
            base.dtype == np.uint8:
        return base
    return None


def pinned_view(arr) -> Optional[torch.Tensor]:
    """A CPU tensor over the same bytes as ``arr`` in the storage of the
    tensor that owns them (a page-locked pool slab's), or None when
    ``arr`` is not a C-contiguous view of a tensor's memory.
    ``torch.from_numpy`` would wrap the same bytes under numpy's
    ownership, where the caching host allocator cannot see a copy in
    flight."""
    if not isinstance(arr, np.ndarray) or not arr.flags.c_contiguous:
        return None
    slab = _slab_of(arr)
    owner = getattr(slab, "base", None) if slab is not None else None
    if not isinstance(owner, torch.Tensor) or owner.device.type != "cpu":
        return None
    dtype = _torch_dtype(arr.dtype)
    off = arr.ctypes.data - owner.data_ptr()
    size = owner.numel()
    if off % arr.itemsize or size % arr.itemsize or \
            off + arr.nbytes > size:
        return None
    flat = owner.view(dtype)
    return flat[off // arr.itemsize:(off + arr.nbytes) // arr.itemsize] \
        .view(arr.shape)


class BufferPool:
    """Thread-safe, size-classed pool of aligned host staging buffers."""

    def __init__(self, align: int = 64, max_per_class: int = 32,
                 name: str = "ingest"):
        self.align = int(align)
        self.max_per_class = int(max_per_class)
        self.name = name
        self._lock = threading.Lock()
        #: size class → list of free slabs (uint8 arrays, len = class+align)
        self._free: Dict[int, List[np.ndarray]] = {}
        #: id(view) → (class, slab, finalizer) for live pool-owned views
        self._out: Dict[int, Tuple[int, np.ndarray, Any]] = {}
        #: id(view) → pin count: views adopted as a DeviceBuffer's cached
        #: host view; explicit release is refused while pinned
        self._pinned: Dict[int, int] = {}
        #: ids of the slabs this pool holds (free or behind a view)
        self._slab_ids: set = set()
        #: (token, seq) of views whose finalizer ran; drained under the
        #: lock by every locked block (finalizers never take the lock)
        self._pending: "collections.deque" = collections.deque()
        self._seq = itertools.count()
        #: id(slab) → event recorded after the last copy that reads it
        self._copy_events: Dict[int, Any] = {}
        self.hits = 0
        self.misses = 0
        self.grows = 0
        #: free slabs passed over because a copy still read them
        self.copy_waits = 0
        self._metrics = None

    # -- obs ----------------------------------------------------------------
    def _obs(self):
        if self._metrics is None:
            from nnstreamer_tpu_torch.obs import get_registry

            reg = get_registry()
            labels = {"pool": self.name}
            ref = weakref.ref(self)
            self._metrics = {
                "hits": reg.counter(
                    "nns_pool_hits_total",
                    "Acquires served from a recycled slab", **labels),
                "misses": reg.counter(
                    "nns_pool_misses_total",
                    "Acquires that found no free slab in the class",
                    **labels),
                "grows": reg.counter(
                    "nns_pool_grows_total",
                    "Fresh slab allocations (pool footprint growth)",
                    **labels),
            }
            reg.gauge(
                "nns_pool_outstanding",
                "Pool-owned buffers currently held by the pipeline",
                fn=lambda: (len(ref()._out) if ref() is not None else 0),
                **labels)
            reg.gauge(
                "nns_pool_bytes_held",
                "Bytes the pool currently holds (free slabs + slabs "
                "backing outstanding views)",
                fn=lambda: (ref().bytes_held() if ref() is not None else 0),
                **labels)
        return self._metrics

    def _forget(self, slab: np.ndarray) -> None:
        """The slab leaves the pool (caller holds the lock)."""
        try:
            self._slab_ids.remove(id(slab))
        except KeyError:
            pass  # never counted (a slab from before the accountant)
        else:
            _mem_account(slab.nbytes, grow=False)
        self._copy_events.pop(id(slab), None)

    def _pop_ready(self, cls: int) -> Optional[np.ndarray]:
        """A free slab of ``cls`` that no copy still reads, newest first
        (caller holds the lock)."""
        free = self._free.get(cls)
        if not free:
            return None
        for i in range(len(free) - 1, -1, -1):
            ev = self._copy_events.get(id(free[i]))
            if ev is not None:
                if not ev.query():
                    self.copy_waits += 1
                    continue
                del self._copy_events[id(free[i])]
            return free.pop(i)
        return None

    # -- hot path -----------------------------------------------------------
    def acquire(self, shape, dtype) -> np.ndarray:
        """An uninitialized, ``align``-byte-aligned array of (shape, dtype)
        backed by a recycled slab when one is free."""
        shape = tuple(int(s) for s in shape)
        dt = np.dtype(dtype)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        if not pool_enabled() or nbytes == 0:
            return np.empty(shape, dt)
        cls = _size_class(nbytes)
        obs = self._obs()
        with self._lock:
            self._drain_locked()
            slab = self._pop_ready(cls)
        grown = slab is None
        if grown:
            self.misses += 1
            self.grows += 1
            obs["misses"].inc()
            obs["grows"].inc()
            _alloc_fault_check()
            slab = _new_slab(cls + self.align, _pin_slabs())
            _mem_account(slab.nbytes, grow=True)
        else:
            self.hits += 1
            obs["hits"].inc()
        off = (-slab.ctypes.data) % self.align
        view = slab[off:off + nbytes].view(dt).reshape(shape)
        token, seq = id(view), next(self._seq)
        fin = weakref.finalize(view, self._pending.append, (token, seq))
        with self._lock:
            # a dead view whose id ``view`` reuses leaves ``_out`` first
            self._drain_locked()
            self._slab_ids.add(id(slab))
            self._out[token] = (cls, slab, fin, seq)
        return view

    def _recycle(self, cls: int, slab: np.ndarray) -> None:
        """Free-list entry for a slab nothing else references (caller
        holds the lock)."""
        free = self._free.setdefault(cls, [])
        if len(free) < self.max_per_class:
            free.append(slab)
        else:
            self._forget(slab)

    def _drain_locked(self) -> None:
        """Take back the slabs of views that died without an explicit
        release (caller holds the lock). A slab is recycled ONLY when
        nothing else references it: a derived view (``frame[None]``, a
        slice) may still read it."""
        while self._pending:
            token, seq = self._pending.popleft()
            entry = self._out.get(token)
            if entry is None or entry[3] != seq:
                continue  # released explicitly, or the id was reused
            del self._out[token]
            # the view is dead, so any pin on it is moot
            self._pinned.pop(token, None)
            cls, slab = entry[0], entry[1]
            del entry
            # refs now: local `slab` + getrefcount's argument == 2; more
            # means a derived view is still live (or the dying view has
            # not dropped its .base yet on another thread: the slab is
            # then dropped, never aliased)
            if sys.getrefcount(slab) > 2:
                self._forget(slab)
                continue
            self._recycle(cls, slab)

    def owns(self, arr) -> bool:
        """True if ``arr`` is a view this pool handed out (not a derived
        view — those pin the slab out of circulation until they die)."""
        with self._lock:
            self._drain_locked()
            return id(arr) in self._out

    def pin(self, arr) -> bool:
        """Pin a pool-owned view against explicit release: a DeviceBuffer
        adopted it as its host-view cache. A pinned view's slab recycles
        only through the GC fallback once the view truly dies. Returns
        False (no-op) for arrays this pool does not own."""
        with self._lock:
            self._drain_locked()
            token = id(arr)
            if token not in self._out:
                return False
            self._pinned[token] = self._pinned.get(token, 0) + 1
            return True

    def unpin(self, token: int) -> None:
        """Drop one pin; ``token`` is the ``id()`` of the pinned view."""
        with self._lock:
            n = self._pinned.get(token, 0)
            if n <= 1:
                self._pinned.pop(token, None)
            else:
                self._pinned[token] = n - 1

    def release(self, arr) -> bool:
        """Explicitly return ``arr``'s slab to the free list. Only call
        when no host reader can still touch the memory (a copy still in
        flight is waited out by ``acquire``). Unknown arrays are ignored
        (False); pinned arrays are refused."""
        with self._lock:
            self._drain_locked()
            if id(arr) in self._pinned:
                return False
            entry = self._out.pop(id(arr), None)
            if entry is None:
                return False
            cls, slab, fin = entry[:3]
            del entry
            fin.detach()  # a future acquire may reuse this id
            # refs now: local `slab` + getrefcount arg + `arr.base` == 3;
            # more means a derived view is still live somewhere
            if sys.getrefcount(slab) > 3:
                self._forget(slab)
                return True
            self._recycle(cls, slab)
            return True

    def release_many(self, arrs) -> int:
        return sum(1 for a in (arrs or ()) if self.release(a))

    def note_copy(self, arr, event) -> bool:
        """Record that a copy reading ``arr`` is in flight until ``event``
        (anything with ``query() -> bool``) completes: ``acquire`` hands
        its slab out again only after that. Returns False for arrays not
        backed by a slab of this pool."""
        slab = _slab_of(arr)
        if slab is None:
            return False
        with self._lock:
            if id(slab) not in self._slab_ids:
                return False
            self._copy_events[id(slab)] = event
            return True

    # -- window staging -----------------------------------------------------
    def acquire_window(self, frames: int, shape, dtype) -> np.ndarray:
        """One contiguous ``(frames,) + shape`` staging view backed by a
        SINGLE pool slab: the host side of a batched multi-frame H2D
        upload. Slot ``i`` is ``view[i]``, whose ``.base`` is the slab, so
        the refcount guard keeps the slab out of circulation while any
        slot view is still read."""
        return self.acquire((int(frames),) + tuple(shape), dtype)

    def bytes_held(self) -> int:
        with self._lock:
            self._drain_locked()
            free_b = sum((cls + self.align) * len(v)
                         for cls, v in self._free.items())
            out_b = sum(e[0] + self.align for e in self._out.values())
        return int(free_b + out_b)

    # -- introspection ------------------------------------------------------
    def hit_rate(self) -> Optional[float]:
        total = self.hits + self.misses
        return (self.hits / total) if total else None

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            self._drain_locked()
            free = sum(len(v) for v in self._free.values())
            out = len(self._out)
            pinned = len(self._pinned)
        rate = self.hit_rate()
        return {"hits": self.hits, "misses": self.misses,
                "grows": self.grows, "outstanding": out, "free": free,
                "pinned": pinned, "copy_waits": self.copy_waits,
                "hit_rate": None if rate is None else round(rate, 4)}

    def clear(self) -> None:
        """Drop every free slab (outstanding views are untouched).
        ``Pipeline.stop()`` calls this so a stopped pipeline does not hold
        peak-rate slab bytes for the life of the process; a dropped pinned
        slab's memory stays with the caching host allocator until the
        copies it recorded are done."""
        with self._lock:
            self._drain_locked()
            for slabs in self._free.values():
                for slab in slabs:
                    self._forget(slab)
            self._free.clear()


def release_all_pools() -> None:
    """Free the free lists of every process-wide arena (the shared ingest
    pool and each lane's) — the ``Pipeline.stop()`` footprint hook."""
    if _default is not None:
        _default.clear()
    with _lane_pools_lock:
        pools = list(_lane_pools.values())
    for p in pools:
        p.clear()


def note_copy(arr, event) -> bool:
    """Record an H2D copy reading ``arr`` with the arena that holds its
    slab (the shared pool or a lane's), so that arena's ``acquire`` waits
    for ``event``. False when no arena holds it."""
    if _default is not None and _default.note_copy(arr, event):
        return True
    with _lane_pools_lock:
        pools = list(_lane_pools.values())
    return any(p.note_copy(arr, event) for p in pools)


def contiguous_window_view(arrays) -> Optional[np.ndarray]:
    """Zero-copy host side of a batched upload: if ``arrays`` are
    equally-shaped C-contiguous views laid out back-to-back in ONE pool
    slab, return the single ``(k,) + shape`` view spanning them; else None
    (the caller copies into a fresh window slab)."""
    k = len(arrays)
    if k < 2:
        return None
    first = arrays[0]
    base = getattr(first, "base", None)
    if base is None or not isinstance(first, np.ndarray):
        return None
    # fast path only for the pool's own slab layout: 1-D uint8 backing
    if not (isinstance(base, np.ndarray) and base.ndim == 1
            and base.dtype == np.uint8 and base.flags["C_CONTIGUOUS"]):
        return None
    shape, dtype, step = first.shape, first.dtype, first.nbytes
    if step == 0 or not first.flags["C_CONTIGUOUS"]:
        return None
    addr0 = first.ctypes.data
    for i, a in enumerate(arrays):
        if (not isinstance(a, np.ndarray) or a.base is not base
                or a.shape != shape or a.dtype != dtype
                or not a.flags["C_CONTIGUOUS"]
                or a.ctypes.data != addr0 + i * step):
            return None
    off = addr0 - base.ctypes.data
    if off < 0 or off + k * step > base.nbytes:
        return None
    return base[off:off + k * step].view(dtype).reshape((k,) + shape)


_default: Optional[BufferPool] = None
_default_lock = threading.Lock()


def get_pool() -> BufferPool:
    """Process-wide ingest pool (sources, converters and aggregators share
    it so a pipeline's steady-state working set converges on a few
    slabs)."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = BufferPool()
    return _default


_lane_pools: Dict[int, BufferPool] = {}
_lane_pools_lock = threading.Lock()


def get_lane_pool(lane: int) -> BufferPool:
    """Per-lane staging arena for the ingest lane executor
    (``pipeline/lanes.py``): each worker lane copies its frames into its
    own pool, so N lanes never serialize on one free-list lock or trip
    each other's slab refcount guards. Keyed process-wide by lane index
    (lane k of every pipeline shares arena k), so metric label
    cardinality stays bounded by the lane count."""
    pool = _lane_pools.get(lane)
    if pool is None:
        with _lane_pools_lock:
            pool = _lane_pools.get(lane)
            if pool is None:
                pool = BufferPool(name=f"ingest-lane{lane}")
                _lane_pools[lane] = pool
    return pool
