"""Paged KV-cache allocator: one preallocated device arena, block tables.

The JAX package's ``serving/kvpool.py`` on the card. The monolithic
serving cache gives every one of ``max_streams`` batch slots the full
``max_seq`` window; this module carves the same bytes into fixed
``block_tokens``-sized blocks instead:

- **Arena** — one preallocated tensor per codec leaf
  (``models.transformer.KVCache``): values ``[L, NTOT + 1, 2, T, h, dh]``
  (the int8 codec adds fp32 scales ``[L, NTOT + 1, 2, T, h]``). ``NTOT =
  num_blocks + 1``: index ``num_blocks`` is the permanent ZERO block,
  never allocated and never written. Index ``NTOT`` is a private TRASH
  block, never read: where the JAX package drops an out-of-range write
  (``mode="drop"``), the port sends it there, because an out-of-range
  index on a CUDA tensor is a device-side assert that poisons the
  context, and a masked write of data-dependent shape cannot be captured.
  The arena is written in place and never rebound: a CUDA graph replay
  reads it where it was captured, so :meth:`BlockPool.reset` zeroes it.
- **Sentinel** — unallocated block-table entries hold ``SENTINEL =
  NTOT``: gathers clamp it onto the ZERO block (reads are exact zeros,
  finite and masked anyway) and scatters land in the TRASH block. One
  sentinel serves empty batch lanes, bucket padding and not-yet-allocated
  tail blocks alike.
- **Free list / refcounts** — a LIFO free list and per-block refcounts,
  so copy-on-write prefix sharing is a ``retain``; a block returns to the
  free list when its last owner releases it. Allocation is
  all-or-nothing.

Under the HBM accountant (``tensors/memory.py``) the arena's bytes,
:attr:`BlockPool.nbytes`, register under the ``kvcache`` category when
the pool is made and unregister at :meth:`BlockPool.close` (or when the
pool is collected), against the accountant that registered them.

Under a serving mesh (``mesh=``) each leaf is a
``parallel.mesh.ShardedTensor``: blocks over ``dp`` (``NTOT`` must divide;
the trash block rides on the first shard) and heads over ``tp``, as the
JAX package places its arena. The in-place helpers then run on each tp
rank's block-gathered view (``parallel.sharded.ShardedLM.blocks``).

Kill switch: ``NNSTPU_PAGED_KV=0`` (or ``block_tokens=0`` on the engine)
keeps the engine on its monolithic cache.
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import List, Optional, Sequence

import numpy as np
import torch

from nnstreamer_tpu_torch.device import resolve_device
from nnstreamer_tpu_torch.tensors import memory as _memory

_FALSY = ("0", "false", "no", "off")


def paged_enabled() -> bool:
    """Environment kill switch (default ON; the engine additionally
    requires ``block_tokens > 0``, which defaults off)."""
    return os.environ.get("NNSTPU_PAGED_KV", "1").strip().lower() \
        not in _FALSY


class BlockPool:
    """Allocator and device arena for one engine's paged KV cache.

    Host-side state (free list, refcounts) is guarded by a lock so the
    engine thread and observers can touch it concurrently; the arena is
    written by the engine loop only, in place.
    """

    def __init__(self, cfg, num_blocks: int, block_tokens: int,
                 kv_codec: Optional[str] = None, mesh=None,
                 owner: str = "kvpool", device=None):
        from nnstreamer_tpu_torch.models.transformer import _kv_codec

        if num_blocks <= 0:
            raise ValueError(f"BlockPool: num_blocks must be positive, "
                             f"got {num_blocks}")
        if block_tokens <= 0:
            raise ValueError(f"BlockPool: block_tokens must be positive, "
                             f"got {block_tokens}")
        self.cfg = cfg
        self.num_blocks = int(num_blocks)
        self.block_tokens = int(block_tokens)
        self.ntot = self.num_blocks + 1       # + the permanent zero block
        self.SENTINEL = self.ntot             # the trash block's index
        self.kv_codec = kv_codec
        self.owner = owner
        # under a mesh the arena lives on the mesh's devices (_place)
        self.device = torch.device(device) if device is not None else \
            None if mesh is not None else resolve_device()
        self._codec = _kv_codec(cfg, kv_codec)
        self._lock = threading.Lock()
        self._free: List[int] = list(range(self.num_blocks))
        self._ref = np.zeros(self.num_blocks, np.int64)
        self.mesh = mesh
        #: the mesh's sharded views (parallel/sharded.py); None unmeshed
        self._lm = None
        self.arena = self._codec.paged_init(
            cfg.n_layers, self.ntot, self.block_tokens, cfg.n_heads,
            cfg.head_dim, device="cpu" if mesh is not None else self.device)
        if mesh is not None:
            self.arena = self._place(self.arena)
        #: the arena's device bytes (trash block included), registered
        #: with the HBM accountant under "kvcache"
        self.nbytes = int(self.arena.nbytes)
        acct = _memory.ACTIVE
        if acct is not None:
            acct.register(self.nbytes, "kvcache")
            self._acct_finalizer = weakref.finalize(
                self, _unregister_arena, weakref.ref(acct), self.nbytes)
        else:
            self._acct_finalizer = None

    def _place(self, arena):
        from nnstreamer_tpu_torch.models.transformer import KVCache
        from nnstreamer_tpu_torch.parallel import serve as _serve
        from nnstreamer_tpu_torch.parallel.mesh import P
        from nnstreamer_tpu_torch.parallel.sharded import ShardedLM

        names = set(self.mesh.axis_names)
        dp = "dp" if "dp" in names else None
        tp = "tp" if "tp" in names else None
        if dp and self.ntot % self.mesh.shape["dp"]:
            raise ValueError(
                f"BlockPool: arena block count {self.ntot} (incl. zero "
                f"block) must divide over dp={self.mesh.shape['dp']} — "
                f"pad num_blocks")
        self._lm = ShardedLM(self.cfg, self.mesh, {})
        self.device = self._lm.device
        # [L, NTOT + 1, 2, T, h(, dh)] — blocks over dp, heads over tp
        head = (None, dp, None, None, tp)
        return KVCache(*_serve.place_tree(
            list(arena.leaves()), self.mesh,
            lambda leaf: P(*head), label=f"{self.owner}:kvpool"))

    def close(self) -> None:
        """Unregister the arena's bytes (idempotent)."""
        if self._acct_finalizer is not None:
            self._acct_finalizer()

    # -- host-side bookkeeping ----------------------------------------

    @property
    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    def alloc(self, k: int) -> Optional[List[int]]:
        """All-or-nothing: ``k`` fresh blocks (refcount 1 each) or None."""
        if k <= 0:
            return []
        with self._lock:
            if len(self._free) < k:
                return None
            ids = [self._free.pop() for _ in range(k)]
            for i in ids:
                self._ref[i] = 1
            return ids

    def retain(self, ids: Sequence[int]) -> None:
        with self._lock:
            for i in ids:
                if self._ref[i] <= 0:
                    raise RuntimeError(
                        f"BlockPool.retain: block {i} is not live")
                self._ref[i] += 1

    def release(self, ids: Sequence[int]) -> None:
        with self._lock:
            for i in ids:
                if self._ref[i] <= 0:
                    raise RuntimeError(
                        f"BlockPool.release: block {i} over-released")
                self._ref[i] -= 1
                if self._ref[i] == 0:
                    self._free.append(i)

    def live_blocks(self) -> int:
        with self._lock:
            return int(np.count_nonzero(self._ref))

    # -- device-side helpers (in place) --------------------------------

    def _ids(self, ids: Sequence[int]) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(ids, np.int64))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)  # nns-lint: disable=NNS113 -- control data: a few token ids or block indices per dispatch; the cache and weights are the tracked bytes
        return t.to(self.device)  # nns-lint: disable=NNS113 -- control data: a few token ids or block indices per dispatch; the cache and weights are the tracked bytes

    def scatter_prefill(self, cache1, block_ids: Sequence[int]) -> None:
        """Move a batch-1 prefill cache (``KVCache`` leaves ``[L, 2, 1, S,
        ...]``) into ``block_ids``: block i receives slots ``[i*T,
        (i+1)*T)``, including any trailing bucket-pad values in the last
        data block, which stay masked until the owning stream overwrites
        them (the padded-prefill contract of the monolithic cache)."""
        k = len(block_ids)
        if k == 0:
            return
        T = self.block_tokens
        idx = self._ids(block_ids)

        def scatter(arena, cache):
            for dst, c in zip(arena.leaves(), cache.leaves()):
                L, S = c.shape[0], c.shape[3]
                u = c[:, :, 0].reshape((L, 2, S // T, T) +
                                       tuple(c.shape[4:]))
                # a tp rank's heads of the prefill cache, on its device
                dst[:, idx.to(dst.device)] = u[:, :, :k].movedim(2, 1).to(  # nns-lint: disable=NNS113 -- block ids and the prefill cache's KV moving into the arena, whose bytes are registered under kvcache
                    dst.device, dst.dtype)

        if self._lm is None:
            scatter(self.arena, cache1)
        else:
            self._lm.scatter_prefill(self.arena, cache1, scatter)

    def copy_block(self, src: int, dst: int) -> None:
        """COW fault: duplicate physical block ``src`` into ``dst`` across
        every layer and leaf."""
        def copy(arena):
            for leaf in arena.leaves():
                leaf[:, dst].copy_(leaf[:, src])

        if self._lm is None:
            copy(self.arena)
        else:
            self._lm.each_arena(self.arena, copy)

    def reset(self) -> None:
        """Drop every allocation and zero the arena in place (the engine's
        recovery path; a captured graph keeps reading the same storage)."""
        with self._lock:
            self._free = list(range(self.num_blocks))
            self._ref[:] = 0
        for leaf in self.arena.leaves():
            for t in getattr(leaf, "shards", [leaf]):
                t.zero_()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "num_blocks": self.num_blocks,
                "block_tokens": self.block_tokens,
                "free_blocks": len(self._free),
                "live_blocks": int(np.count_nonzero(self._ref)),
                "nbytes": self.nbytes,
            }


def _unregister_arena(acct_ref, nbytes: int) -> None:
    acct = acct_ref()
    if acct is not None:
        acct.unregister(nbytes, "kvcache")
