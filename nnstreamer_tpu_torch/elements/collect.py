"""CollectPads + timestamp-sync policies for N-to-1 elements.

Port of ``nnstreamer_tpu/elements/collect.py``. Reference:
``gst/nnstreamer/tensor_common_pipeline.c`` — the four pad-sync policies
shared by tensor_mux/tensor_merge (``tensor_time_sync_mode``,
tensor_common.h:62-69;
Documentation/synchronization-policies-at-mux-merge.md):

- ``nosync``  — combine in arrival order; one output per full set.
- ``slowest`` — sync to the slowest pad: output timestamp is the max of the
  collected pts; every pad contributes its buffer closest to that time.
- ``basepad`` — sync to a chosen pad (option ``<pad>:<duration>``): output
  per base-pad buffer, others contribute their latest buffer within the
  duration window (stale ones are reused).
- ``refresh`` — output whenever ANY pad receives a buffer, reusing the
  last-known buffer of the other pads.

Mechanics: producer threads call :meth:`CollectPads.push`; the policy
decides when a full frame-set is ready and which buffers compose it. All
control flow is on the host; payloads (CUDA tensors included) are routed
by reference, never copied.

Frame-sets leave one at a time, in the order they were collected: the
collecting and the hand-off to ``on_ready`` happen under one lock. A
consumer downstream need not be re-entrant — a fused region copies each
frame into the static inputs of one CUDA graph and replays it, and two
producer threads handing it frame-sets at once would overwrite each
other's inputs.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

SYNC_POLICIES = ("nosync", "slowest", "basepad", "refresh")

#: buffer-meta key carrying the CollectPads arrival stamp (popped when
#: the buffer leaves in a frame-set, so it never travels downstream)
_ARRIVE_KEY = "_collect_arrive_t"


class CollectPads:
    """Collects one buffer per pad according to a sync policy and emits
    combined frame-sets via ``on_ready([(pad_index, buffer), ...])``.

    ``observe_wait`` (optional) receives, per emitted frame-set, the
    sync-wait in seconds: how long the set's EARLIEST-arriving buffer
    sat waiting for its peers — the pipeline-visible cost of the sync
    policy (a slow pad shows up here before it shows up as fps loss).
    """

    def __init__(self, num_pads: int, policy: str = "slowest",
                 option: str = "",
                 on_ready: Optional[Callable[[List[tuple]], None]] = None,
                 observe_wait: Optional[Callable[[float], None]] = None):
        if policy not in SYNC_POLICIES:
            raise ValueError(f"unknown sync policy {policy!r}")
        self.num_pads = num_pads
        self.policy = policy
        self.on_ready = on_ready
        self.observe_wait = observe_wait
        # reentrant: a consumer may call recheck() from inside on_ready
        self._lock = threading.RLock()
        self._queues: Dict[int, List[TensorBuffer]] = {
            i: [] for i in range(num_pads)
        }
        self._last: Dict[int, Optional[TensorBuffer]] = {
            i: None for i in range(num_pads)
        }
        self._eos: Dict[int, bool] = {i: False for i in range(num_pads)}
        self.base_pad = 0
        self.base_window_ns = 0
        if policy == "basepad" and option:
            parts = str(option).split(":")
            self.base_pad = int(parts[0])
            if len(parts) > 1:
                self.base_window_ns = int(parts[1])

    def add_pad(self) -> int:
        with self._lock:
            i = self.num_pads
            self.num_pads += 1
            self._queues[i] = []
            self._last[i] = None
            self._eos[i] = False
            return i

    # -- input ---------------------------------------------------------------
    def push(self, pad_index: int, buf: TensorBuffer) -> None:
        if self.observe_wait is not None:
            buf.meta[_ARRIVE_KEY] = time.monotonic()
        with self._lock:
            self._queues[pad_index].append(buf)
            self._last[pad_index] = buf
            self._dispatch(self._collect_locked(pad_index))

    def _dispatch(self, ready: List[List[tuple]]) -> None:
        """Hand ``ready`` to ``on_ready`` in order (under the lock)."""
        if ready and self.on_ready:
            for frame in ready:
                self._observe_frame(frame)
                self.on_ready(frame)

    def _observe_frame(self, frame: List[tuple]) -> None:
        """Report the frame-set's sync wait (earliest arrival → now).
        Stamps are popped so a buffer reused by the ``refresh`` policy
        contributes its wait only once."""
        if self.observe_wait is None:
            return
        stamps = [b.meta.pop(_ARRIVE_KEY, None) for _, b in frame]
        stamps = [t for t in stamps if t is not None]
        if stamps:
            self.observe_wait(time.monotonic() - min(stamps))

    def requeue_front(self, pad_index: int, buf: TensorBuffer) -> None:
        """Put a buffer back at the head of a pad's queue (no collect
        trigger) — for consumers that reject a pairing and keep the newer
        buffer for the next one. Follow with :meth:`recheck` once the
        rejection is fully handled."""
        with self._lock:
            self._queues[pad_index].insert(0, buf)

    def recheck(self) -> List[List[tuple]]:
        """Re-run collection without a new arrival (after requeue_front or
        EOS) and dispatch any now-ready frames. Not for the ``refresh``
        policy, which is strictly arrival-driven."""
        if self.policy == "refresh":
            raise ValueError("recheck() is undefined for policy 'refresh'")
        with self._lock:
            ready = self._collect_locked(-1)
            self._dispatch(ready)
        return ready

    def set_eos(self, pad_index: int) -> bool:
        """Mark a pad EOS; returns True when ALL pads are EOS."""
        with self._lock:
            self._eos[pad_index] = True
            return all(self._eos.values())

    # -- policies ------------------------------------------------------------
    def _collect_locked(self, arrived: int) -> List[List[tuple]]:
        frames = []
        if self.policy in ("nosync", "slowest"):
            # both need a full set; slowest additionally aligns timestamps
            while all(q or self._eos[i]
                      for i, q in self._queues.items()) and any(
                          q for q in self._queues.values()):
                if not all(self._queues[i] for i in self._queues
                           if not self._eos[i]):
                    break
                live = [i for i in self._queues if self._queues[i]]
                if len(live) < sum(1 for i in self._eos if not self._eos[i]):
                    break
                if self.policy == "slowest" and len(live) > 1:
                    # drop buffers older than the slowest head timestamp
                    base = max(
                        (self._queues[i][0].pts or 0) for i in live
                    )
                    for i in live:
                        q = self._queues[i]
                        while len(q) > 1 and (q[1].pts or 0) <= base:
                            q.pop(0)
                frames.append([(i, self._queues[i].pop(0)) for i in live])
        elif self.policy == "basepad":
            while self._queues[self.base_pad]:
                base_buf = self._queues[self.base_pad][0]
                others_ready = True
                for i in self._queues:
                    if i == self.base_pad or self._eos[i]:
                        continue
                    if not self._queues[i] and self._last[i] is None:
                        others_ready = False
                        break
                if not others_ready:
                    break
                self._queues[self.base_pad].pop(0)
                frame = [(self.base_pad, base_buf)]
                base_ts = base_buf.pts or 0
                for i in self._queues:
                    if i == self.base_pad:
                        continue
                    q = self._queues[i]
                    # advance to the newest buffer not beyond the window
                    chosen = self._last[i]
                    while q:
                        cand = q[0]
                        if self.base_window_ns and cand.pts is not None and \
                                cand.pts > base_ts + self.base_window_ns:
                            break
                        chosen = q.pop(0)
                    if chosen is not None:
                        frame.append((i, chosen))
                frames.append(sorted(frame, key=lambda e: e[0]))
        elif self.policy == "refresh":
            if all(self._last[i] is not None or self._eos[i]
                   for i in self._queues):
                frame = [(i, self._last[i]) for i in self._queues
                         if self._last[i] is not None]
                self._queues[arrived].clear()
                frames.append(frame)
        return frames

    def flush_remaining(self) -> List[List[tuple]]:
        """At EOS: emit any complete-as-possible leftover sets (nosync)."""
        with self._lock:
            frames = []
            while any(q for q in self._queues.values()):
                frame = [(i, q.pop(0)) for i, q in self._queues.items() if q]
                if self.policy in ("nosync",) and frame:
                    frames.append(frame)
                else:
                    break
            return frames
