"""DispatchWindow — bounded asynchronous dispatch per filter / fused region.

Port of ``nnstreamer_tpu/pipeline/dispatch.py``. CUDA launches are
asynchronous: a filter's invoke (or a region's graph replay) returns
before the card has finished. The window lets up to ``inflight=K``
dispatched batches be outstanding per dispatching element; the producer
thread blocks only when the window is full, by fencing the OLDEST
outstanding batch — bounded pipelining, same ordering. ``inflight=0``
fences every batch.

The fence of a batch is a ``torch.cuda.Event`` recorded on the current
stream of the batch's device right after the dispatch and its output
copies were enqueued (:meth:`DispatchWindow.admit`); :meth:`_fence_oldest`
waits on it with ``event.synchronize()`` where the JAX package calls
``block_until_ready()``. A batch of CPU tensors has nothing outstanding:
the window admits and fences it at once.

The window also owns the staging-buffer recycle point: the pooled host
arrays a batch's H2D copies read (``tensors/pool.py``, carried in
``meta["pool_stash"]``) go back to the pool when the batch fences, since
the dispatch that read them and the copies before it are complete by
then. A batched window upload parks its one window slab on the run's LAST
buffer's stash, so the in-order fence releases it after every dispatch
that read any slot of it.

Instrumented as ``nns_filter_inflight`` (current occupancy) and
``nns_filter_fence_wait_seconds`` (time blocked in each fence: near zero
means the card finishes before the window fills; large means the pipeline
is device-bound at this element). The JAX window's fault-injection and
timeline hooks wait for ROADMAP A.11.
"""

from __future__ import annotations

import collections
import time
import weakref
from typing import Any, Deque, List, Optional, Tuple

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.tensors.buffer import (
    H2D_EXCLUSIVE_META,
    is_device_array,
)

log = get_logger("dispatch")

#: meta key carrying pool-owned host staging arrays whose release waits
#: for the fence of the dispatch that read them (set by a prefetch-device
#: queue; a batched upload adds its window slab to the run's last buffer)
POOL_STASH_META = "pool_stash"


def release_shed_payload(buf) -> None:
    """Release a dropped frame's pool stash and exclusive device payload
    now: a frame a leaky queue drops never reaches a fence. Pops the
    ``pool_stash`` back to the pool, and clears the device tensor list
    only when an upload point created it for this one consumer
    (``h2d_exclusive``)."""
    meta = getattr(buf, "meta", None)
    if meta is None or not hasattr(meta, "pop"):
        return
    stash = meta.pop(POOL_STASH_META, None)
    if stash:
        from nnstreamer_tpu_torch.tensors.pool import get_pool

        get_pool().release_many(stash)
    if meta.pop(H2D_EXCLUSIVE_META, None):
        tensors = getattr(buf, "tensors", None)
        if tensors and all(is_device_array(t) for t in tensors):
            tensors.clear()


def batch_event(tensors):
    """An event recorded on the current stream of the first CUDA tensor's
    device, or None when no tensor lies on a card."""
    for t in tensors:
        if is_device_array(t) and t.device.type == "cuda":
            import torch

            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(t.device))
            return ev
    return None


class DispatchWindow:
    """Per-element window of outstanding (dispatched, unfenced) batches.

    Not thread-safe on its own: a window belongs to one element whose
    chain runs on one streaming thread at a time (the contract every
    element's ``chain`` already has).
    """

    def __init__(self, owner):
        #: weakly bound: the window must not keep a dead element alive
        #: through the metrics registry
        self._owner = weakref.ref(owner)
        self._entries: Deque[Tuple[Any, Optional[list]]] = \
            collections.deque()
        self._m_fence = None

    def __len__(self) -> int:
        return len(self._entries)

    def _inflight(self) -> int:
        owner = self._owner()
        if owner is None:
            return 1
        try:
            return max(0, int(owner.get_property("inflight")))
        except (KeyError, TypeError, ValueError):
            return 2

    def _obs(self):
        if self._m_fence is None:
            owner = self._owner()
            if owner is None:
                return None
            from nnstreamer_tpu_torch.obs import get_registry

            reg = get_registry()
            labels = {"pipeline": getattr(owner.pipeline, "name", "") or "",
                      "element": owner.name}
            self._m_fence = reg.histogram(
                "nns_filter_fence_wait_seconds",
                "Time blocked fencing the oldest outstanding dispatch "
                "(window full or EOS)", **labels)
            ref = weakref.ref(self)
            reg.gauge(
                "nns_filter_inflight",
                "Dispatched device batches currently outstanding",
                fn=lambda: (len(ref()) if ref() is not None else 0),
                **labels)
        return self._m_fence

    # -- hot path -----------------------------------------------------------
    def admit(self, tensors: List[Any], stash: Optional[list] = None,
              event=None) -> None:
        """Register a just-dispatched batch; fence the oldest entries until
        at most ``inflight`` remain outstanding. ``tensors`` is the batch's
        output list (or a whole buffer); ``event`` defaults to one
        recorded now on the current stream of their card (anything with
        ``synchronize()`` will do). Without one the batch is complete: its
        stash is released at once."""
        tensors = getattr(tensors, "tensors", tensors)
        if event is None:
            event = batch_event(tensors)
        if event is None:
            self._release(stash)
            return
        self._entries.append((event, stash))
        limit = self._inflight()
        while len(self._entries) > limit:
            self._fence_oldest()

    @staticmethod
    def _release(stash: Optional[list]) -> None:
        if stash:
            # the fenced dispatch (and the H2D feeding it) is complete:
            # its pooled staging arrays have no device reader left; a
            # stash array adopted as a DeviceBuffer's host view stays
            # pinned (release refuses it) until that buffer dies
            from nnstreamer_tpu_torch.tensors.pool import get_pool

            get_pool().release_many(stash)

    def _fence_oldest(self) -> None:
        """Fence the oldest outstanding batch. A failing fence (a device
        error surfacing at the wait) poisons only that batch: its entry is
        already popped and its stash still released; the error reaches
        the dispatching element's chain."""
        event, stash = self._entries.popleft()
        hist = self._obs()
        t0 = time.monotonic()
        try:
            event.synchronize()
        finally:
            if hist is not None:
                hist.observe(time.monotonic() - t0)
            self._release(stash)

    def drain(self, on_error: str = "raise") -> None:
        """Fence everything outstanding (EOS / stop / invalidate). Every
        entry is fenced (stashes released) and the FIRST failure re-raises
        at the end — or is only logged with ``on_error="log"``, the
        teardown mode."""
        first: Optional[BaseException] = None
        while self._entries:
            try:
                self._fence_oldest()
            except Exception as e:  # noqa: BLE001 — keep fencing: the
                # remaining entries' stashes must still release
                if first is None:
                    first = e
        if first is not None:
            if on_error == "log":
                log.warning("dispatch drain: failed batch during "
                            "teardown: %s", first)
                return
            raise first

    def snapshot(self) -> dict:
        out = {"inflight_now": len(self._entries),
               "inflight_limit": self._inflight()}
        h = self._m_fence
        if h is not None and h.count:
            out["fence_wait_p50_ms"] = round(
                (h.percentile(50) or 0.0) * 1e3, 3)
            out["fence_wait_p99_ms"] = round(
                (h.percentile(99) or 0.0) * 1e3, 3)
            out["fence_wait_s"] = h.sum
        return out
