"""tensor_aggregator — temporal frame aggregation / dis-aggregation.

Port of ``nnstreamer_tpu/elements/aggregator.py`` (reference
``gst/nnstreamer/elements/gsttensoraggregator.c``): collects ``frames-in``
frames per input buffer, emits ``frames-out`` frames per output,
advancing by ``frames-flush`` (sliding windows when flush < out),
concatenating along ``frames-dim`` (innermost-first). The flagship's
batch 8 is ``frames-in=1 frames-out=8 frames-flush=8 frames-dim=3``.

``latency-budget-ms`` adds latency-budget adaptive batching: a window that
would otherwise hold frames past the budget waiting to fill is flushed
EARLY, padded to ``frames-out`` by repeating the last frame so the
downstream consumer keeps its one input shape (one CUDA-graph capture in
a fused region). The padded output carries ``meta["valid_frames"]=k``;
``tensor_sink`` trims the padding at materialization and reports
latencies for the real frames only. With ``pad-device=true`` the window
carries only the k real frames plus ``meta["pad_rows"]``, and a
downstream ``prefetch-device`` queue adds the zero rows on the device
(``TensorBuffer.pad_rows_device``), so the padding never crosses the H2D
link.

Host windows concatenate into a pool slab (``tensors/pool.py``: page-
locked on the card, so the upload that reads it is asynchronous); device
windows concatenate with ``torch.cat`` on their device.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np
import torch

from nnstreamer_tpu_torch.pipeline.element import Element, not_ported
from nnstreamer_tpu_torch.registry import ELEMENT, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensors.pool import get_pool


@subplugin(ELEMENT, "tensor_aggregator")
class TensorAggregator(Element):
    ELEMENT_NAME = "tensor_aggregator"
    #: batch-drain opt-in: a queue backlog arrives as one list, windowed
    #: under ONE lock acquisition (see chain_list)
    HANDLES_LIST = True
    DEVICE_PASSTHROUGH = True  # device windows concat on the device
    PROPERTIES = {
        **Element.PROPERTIES,
        "frames_in": 1,
        "frames_out": 1,
        "frames_flush": 0,   # 0 → == frames_out (no overlap)
        "frames_dim": 0,     # innermost-first dim index to aggregate along
        "concat": True,
        # >0: flush a PARTIAL window (padded to frames-out, with
        # meta["valid_frames"]) once the oldest queued frame has waited
        # this many ms. A budget flush emits everything queued (sliding
        # overlap does not apply to it); the tail is flushed at EOS.
        "latency_budget_ms": 0,
        # partial-flush padding placement: false pads on the host to
        # frames-out; true emits only the k real frames plus
        # meta["pad_rows"] for a downstream prefetch-device queue to pad
        # on the device (without one the consumer sees [k])
        "pad_device": False,
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        #: one window per tensor position in the frame
        self._windows: List[list] = []
        self._pts: Optional[int] = None
        #: capture stamps of the unit frames in flight, parallel to the
        #: windows — emitted as meta["create_ts"]
        self._create_ts: List[Optional[float]] = []
        #: admission stamps (meta["admitted_t"]) in lockstep, emitted as
        #: meta["admitted_ts"]
        self._admit_ts: List[Optional[float]] = []
        #: budget clock per queued unit frame: its create stamp when one
        #: flowed, else its arrival time here
        self._held_since: List[float] = []
        #: serializes chain() with the budget flusher thread
        self._lock = threading.RLock()
        self._flusher: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()

    def start(self):
        super().start()
        budget = float(self.get_property("latency_budget_ms"))
        if budget > 0:
            self._stop_evt.clear()
            self._flusher = threading.Thread(
                target=self._flush_loop, args=(budget / 1e3,),
                daemon=True, name=f"{self.name}-budget")
            self._flusher.start()

    def stop(self):
        self._stop_evt.set()
        if self._flusher is not None:
            self._flusher.join(timeout=5)
            self._flusher = None
        super().stop()

    def note_mesh_quantum(self, quantum: int) -> None:
        """Mesh-wide batch forming rounds frames-out to the data-parallel
        shard count: not ported (the port serves on one card)."""
        raise not_ported("mesh-wide batch forming (note_mesh_quantum)",
                         "A.24 multi-GPU serving")

    def transform_caps(self, pad, caps):
        return None  # announced from the first output (shape changes)

    def _axis(self, arr) -> int:
        return arr.ndim - 1 - int(self.get_property("frames_dim"))

    def chain(self, pad, buf):
        with self._lock:
            return self._chain_locked(pad, buf)

    def chain_list(self, pad, bufs):
        """Batch-drain fast path: the whole queue backlog windows under one
        lock acquisition."""
        ret = None
        with self._lock:
            for b in bufs:
                ret = self._chain_locked(pad, b)
        return ret

    def _chain_locked(self, pad, buf):
        fin = int(self.get_property("frames_in"))
        fout = int(self.get_property("frames_out"))
        flush = int(self.get_property("frames_flush")) or fout
        if not buf.tensors:
            return None  # empty frame: nothing to window
        if not self._windows:
            self._windows = [[] for _ in buf.tensors]
        elif len(buf.tensors) != len(self._windows):
            raise ValueError(
                f"tensor_aggregator: frame has {len(buf.tensors)} tensors, "
                f"stream started with {len(self._windows)}")
        if self._pts is None:
            self._pts = buf.pts
        n = max(fin, 1)
        # validate every tensor BEFORE mutating windows or stamps
        for arr in buf.tensors:
            axis = self._axis(arr)
            if arr.shape[axis] % n:
                raise ValueError(
                    f"tensor_aggregator: dim "
                    f"{self.get_property('frames_dim')} size "
                    f"{arr.shape[axis]} not divisible by frames-in {n}")
        stamps = buf.create_stamps()
        if stamps and len(stamps) != n:
            # one stamp per unit frame keeps stamps in lockstep with the
            # windows; a count that does not match the split uses the
            # earliest for all of them (reports the longest latency)
            stamps = [min(stamps)] * n
        if stamps or self._create_ts:
            # mixed stamped/unstamped upstreams must not shift stamp →
            # window attribution: pad with None placeholders
            deficit = max(0, len(self._windows[0]) - len(self._create_ts))
            self._create_ts.extend([None] * deficit)
            self._create_ts.extend(stamps if stamps else [None] * n)
        adm = buf.meta.get("admitted_t")
        if adm is not None or self._admit_ts:
            deficit = max(0, len(self._windows[0]) - len(self._admit_ts))
            self._admit_ts.extend([None] * deficit)
            self._admit_ts.extend([adm] * n)
        budget = float(self.get_property("latency_budget_ms"))
        if budget > 0:
            now = time.monotonic()
            self._held_since.extend(
                (stamps[i] if stamps and stamps[i] is not None else now)
                for i in range(n))
        for ti, arr in enumerate(buf.tensors):
            axis = self._axis(arr)
            # split the incoming tensor into its `frames_in` unit frames
            per = arr.shape[axis] // n
            for k in range(n):
                sl = [slice(None)] * arr.ndim
                sl[axis] = slice(k * per, (k + 1) * per)
                self._windows[ti].append(arr[tuple(sl)])
        ret = None
        while all(len(w) >= fout for w in self._windows):
            outs = self._concat_windows([w[:fout] for w in self._windows])
            self._announce_caps(outs)
            meta = {}
            out_ts = [s for s in self._create_ts[:fout] if s is not None]
            if out_ts:
                meta["create_ts"] = out_ts
            out_adm = [s for s in self._admit_ts[:fout] if s is not None]
            if out_adm:
                meta["admitted_ts"] = out_adm
            ret = self.srcpad.push(TensorBuffer(outs, pts=self._pts,
                                                meta=meta))
            self._windows = [w[flush:] for w in self._windows]
            self._create_ts = self._create_ts[flush:]
            self._admit_ts = self._admit_ts[flush:]
            self._held_since = self._held_since[flush:]
            self._pts = buf.pts
        if budget > 0 and self._held_since and \
                time.monotonic() - self._held_since[0] >= budget / 1e3 \
                and self._downstream_ready():
            ret = self._emit_partial() or ret
        return ret

    def _downstream_ready(self) -> bool:
        """Backpressure gate for budget flushes: while the downstream queue
        is full, flushing more, smaller windows compounds the backlog, so
        the window keeps filling toward a full batch instead. Full windows
        flush through the normal (blocking) path regardless."""
        peer = self.srcpad.peer
        ready = getattr(getattr(peer, "element", None), "accepts_now",
                        None)
        return True if ready is None else bool(ready())

    def _flush_loop(self, budget_s: float):
        """Budget watchdog: chain() only runs on arrivals, so a stalled
        upstream would otherwise hold queued frames past the budget. Ticks
        at budget/4, so a frame overstays by at most about 25%."""
        tick = max(budget_s / 4, 0.005)
        while not self._stop_evt.wait(tick):
            with self._lock:
                if self._held_since and \
                        time.monotonic() - self._held_since[0] >= budget_s \
                        and self._downstream_ready():
                    self._emit_partial()

    def _concat_windows(self, chunks):
        """One concatenated tensor per window (concat=true) or the unit
        frames as separate tensors."""
        outs = []
        for chunk in chunks:
            if not self.get_property("concat"):
                outs.extend(chunk)
                continue
            axis = self._axis(chunk[0])
            if isinstance(chunk[0], torch.Tensor):
                outs.append(torch.cat(list(chunk), dim=axis))
            elif all(c.dtype == chunk[0].dtype for c in chunk):
                # the ingest path's one per-window allocation: a recycled
                # staging slab, released once the upload that reads it
                # fences downstream
                shape = list(chunk[0].shape)
                shape[axis] = sum(c.shape[axis] for c in chunk)
                dst = get_pool().acquire(shape, chunk[0].dtype)
                np.concatenate(chunk, axis=axis, out=dst)
                outs.append(dst)
            else:
                # mixed dtypes promote — let numpy own the result
                outs.append(np.concatenate(chunk, axis=axis))
        return outs

    def _announce_caps(self, outs):
        if self.srcpad.caps is None:
            from nnstreamer_tpu_torch.tensors.types import TensorsConfig

            self.srcpad.set_caps(TensorsConfig.from_arrays(outs).to_caps())

    def _emit_partial(self):
        """Flush the queued k < frames-out frames. With concat=true on a
        leading (axis-0) frame axis the window is padded to frames-out and
        ``meta["valid_frames"]=k`` lets the sink trim the padding;
        ``pad-device`` defers that pad to a downstream prefetch-device
        queue. Non-leading concat axes and concat=false emit the k real
        frames unpadded. Caller holds ``self._lock``."""
        fout = int(self.get_property("frames_out"))
        k = len(self._windows[0]) if self._windows else 0
        if not k:
            return None
        pad_ok = (self.get_property("concat") and k < fout and
                  self._axis(self._windows[0][0]) == 0)
        # the device-pad path needs announced caps (set below from a
        # host-padded first window)
        on_device_pad = (pad_ok and bool(self.get_property("pad_device"))
                         and self.srcpad.caps is not None)
        pad_n = (fout - k) if (pad_ok and not on_device_pad) else 0
        outs = self._concat_windows(
            [list(w) + [w[-1]] * pad_n for w in self._windows])
        if not on_device_pad:
            self._announce_caps(outs)
        meta = {}
        if pad_ok:
            meta["valid_frames"] = k
            if on_device_pad:
                meta["pad_rows"] = fout - k
        out_ts = [s for s in self._create_ts[:k] if s is not None]
        if out_ts:
            meta["create_ts"] = out_ts
        out_adm = [s for s in self._admit_ts[:k] if s is not None]
        if out_adm:
            meta["admitted_ts"] = out_adm
        ret = self.srcpad.push(TensorBuffer(outs, pts=self._pts, meta=meta))
        self._windows = [[] for _ in self._windows]
        self._create_ts = []
        self._admit_ts = []
        self._held_since = []
        self._pts = None
        return ret

    def handle_eos(self):
        with self._lock:
            if float(self.get_property("latency_budget_ms")) > 0:
                # budget mode promises every frame a bounded exit: the
                # partial tail flushes instead of being dropped
                self._emit_partial()
            self._windows.clear()
            self._create_ts.clear()
            self._admit_ts.clear()
            self._held_since.clear()
            self._pts = None
