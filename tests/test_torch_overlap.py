"""The overlap layer of the PyTorch port: the queue's ``prefetch-device``,
``batch-h2d``, ``drain-batch`` and ``materialize-host``, the list hand-off
(``Pad.push_list`` / ``chain_list``), and the staged transfers of
``tensors/buffer.py`` (``upload_many``, ``materialize_many``,
``pad_rows_device``, ``DeviceBuffer(host_view=)``).

The cases of the JAX package's ``tests/test_overlap.py::TestQueueOptIns``
and ``TestBatchDrain`` run against the port: pipelining must be
observably free — per-frame results and their order are unchanged,
events stay serialized with the data, a list hand-off keeps per-buffer
stats. Here the package device is the CPU, so an "upload" is a copy into a
fresh CPU tensor; a grouped fetch is byte-identical to per-buffer
``to_host()``, and its one synchronisation a run is counted on the card
(``chip_smoke.py``, ``pipeline_batched``).
"""

import threading
import time

import numpy as np
import pytest
import torch

import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu_torch.pipeline.dispatch import POOL_STASH_META
from nnstreamer_tpu_torch.pipeline.element import (
    Element,
    EosEvent,
    FlowReturn,
)
from nnstreamer_tpu_torch.pipeline.pipeline import Queue, SourceElement
from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline
from nnstreamer_tpu_torch.tensors.buffer import (
    H2D_EXCLUSIVE_META,
    DeviceBuffer,
    TensorBuffer,
    materialize_many,
    transfer_snapshot,
    upload_many,
)
from nnstreamer_tpu_torch.tensors.pool import get_pool
from nnstreamer_tpu_torch.tensors.types import TensorsConfig

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


class _NumSrc(SourceElement):
    """Counts 0..n-1 as 1-element float32 tensors."""

    ELEMENT_NAME = "_numsrc"
    PROPERTIES = {**SourceElement.PROPERTIES, "num_buffers": 5}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.i = 0

    def negotiate(self):
        self.srcpad.set_caps(TensorsConfig.from_arrays(
            [np.zeros((1,), np.float32)]).to_caps())

    def create(self):
        if self.i >= self.get_property("num_buffers"):
            return None
        buf = TensorBuffer([np.array([float(self.i)], np.float32)],
                           pts=self.i * 1000)
        self.i += 1
        return buf


class _Collect(Element):
    ELEMENT_NAME = "_collect"

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.buffers = []
        self.got_eos = False

    def chain(self, pad, buf):
        self.buffers.append(buf)
        return FlowReturn.OK

    def sink_event(self, pad, event):
        if isinstance(event, EosEvent):
            self.got_eos = True


# -- queue opt-ins × deferred finalize ----------------------------------------
class _DeferredProbe(Element):
    """HANDLES_DEFERRED sink recording finalize state and payload type at
    arrival, then materializing."""

    ELEMENT_NAME = "_defprobe"
    HANDLES_DEFERRED = True

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.arrived = []   # (finalize pending, payload is a tensor)
        self.values = []
        self.metas = []

    def chain(self, pad, buf):
        self.arrived.append((buf.finalize is not None,
                             isinstance(buf.tensors[0], torch.Tensor)))
        self.metas.append(dict(buf.meta))
        host = buf.to_host()
        self.values.append(np.asarray(host.tensors[0]).copy())
        return FlowReturn.OK


class _FinalizeSrc(SourceElement):
    """Buffers carrying a deferred finalize that doubles the payload."""

    ELEMENT_NAME = "_finsrc"
    PROPERTIES = {**SourceElement.PROPERTIES, "num_buffers": 4,
                  "pooled": False}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.i = 0

    def negotiate(self):
        self.srcpad.set_caps(TensorsConfig.from_arrays(
            [np.zeros((2,), np.float32)]).to_caps())

    def create(self):
        if self.i >= self.get_property("num_buffers"):
            return None
        if self.get_property("pooled"):
            arr = get_pool().acquire((2,), np.float32)
            arr[:] = float(self.i)
        else:
            arr = np.full((2,), float(self.i), np.float32)
        buf = TensorBuffer([arr], pts=self.i).replace(
            finalize=lambda b: b.with_tensors(
                [np.asarray(t) * 2 for t in b.tensors]))
        self.i += 1
        return buf


def _run_finalize_pipe(queue_props, n=4, pooled=False):
    src = _FinalizeSrc(num_buffers=n, pooled=pooled)
    probe = _DeferredProbe()
    pipe = Pipeline().add_linked(src, Queue(**queue_props), probe)
    msg = pipe.run(timeout=30)
    assert msg is not None and msg.kind == "eos"
    return probe


def _doubled(probe, n=4):
    assert len(probe.values) == n
    for i, v in enumerate(probe.values):
        np.testing.assert_array_equal(v, np.full((2,), 2.0 * i))


class TestQueueOptIns:
    def test_plain_queue_keeps_finalize_lazy(self):
        probe = _run_finalize_pipe({})
        assert all(pending for pending, _ in probe.arrived)
        _doubled(probe)

    def test_materialize_host_applies_finalize_at_queue(self):
        probe = _run_finalize_pipe({"materialize_host": True})
        assert all(not pending and not tensor
                   for pending, tensor in probe.arrived)
        _doubled(probe)

    @pytest.mark.parametrize("batch_h2d", [True, False])
    def test_prefetch_device_keeps_finalize_and_moves_payload(self,
                                                              batch_h2d):
        probe = _run_finalize_pipe({"prefetch_device": True,
                                    "batch_h2d": batch_h2d})
        assert all(pending and tensor for pending, tensor in probe.arrived)
        assert all(m.get(H2D_EXCLUSIVE_META) for m in probe.metas)
        _doubled(probe)

    def test_prefetch_host_preserves_results(self):
        probe = _run_finalize_pipe({"prefetch_host": True})
        _doubled(probe)

    def test_prefetch_device_stamps_pool_stash(self):
        """A pool-owned host array crossing a prefetch-device queue rides
        on as a stash claim, to be released at a fence downstream."""
        probe = _run_finalize_pipe({"prefetch_device": True,
                                    "batch_h2d": False}, n=3, pooled=True)
        assert len(probe.values) == 3
        assert all(len(m[POOL_STASH_META]) == 1 for m in probe.metas)


# -- batch drain ----------------------------------------------------------------
class _ListCollect(Element):
    """HANDLES_LIST consumer recording list vs single hand-offs; the first
    call stalls so a backlog builds behind it."""

    ELEMENT_NAME = "_listcollect"
    HANDLES_LIST = True

    def __init__(self, name=None, stall_s=0.0, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.values = []
        self.list_sizes = []
        self.singles = 0
        self._stall_s = stall_s
        self._stalled = False

    def _maybe_stall(self):
        if self._stall_s and not self._stalled:
            self._stalled = True
            time.sleep(self._stall_s)

    def chain(self, pad, buf):
        self._maybe_stall()
        self.singles += 1
        self.values.append(float(np.asarray(buf.tensors[0])[0]))
        return FlowReturn.OK

    def chain_list(self, pad, bufs):
        self._maybe_stall()
        self.list_sizes.append(len(bufs))
        for b in bufs:
            self.values.append(float(np.asarray(b.tensors[0])[0]))
        return FlowReturn.OK


def _drain_run(n, sink, **queue_props):
    q = Queue(max_size_buffers=n, **queue_props)
    pipe = Pipeline().add_linked(_NumSrc(num_buffers=n), q, sink)
    msg = pipe.run(timeout=30)
    assert msg is not None and msg.kind == "eos"
    return q


class TestBatchDrain:
    def test_backlog_drains_as_ordered_list(self):
        sink = _ListCollect(stall_s=0.3)
        _drain_run(40, sink)
        assert sink.values == [float(i) for i in range(40)]
        assert sink.list_sizes and max(sink.list_sizes) > 1

    def test_drain_batch_1_disables_gathering(self):
        sink = _ListCollect(stall_s=0.2)
        _drain_run(20, sink, drain_batch=1)
        assert sink.values == [float(i) for i in range(20)]
        assert sink.list_sizes == [] and sink.singles == 20

    def test_non_list_peer_gets_per_buffer_chain(self):
        sink = _Collect()
        _drain_run(30, sink)
        assert [float(b.tensors[0][0]) for b in sink.buffers] == \
            [float(i) for i in range(30)]
        assert sink.got_eos

    def test_list_handoff_keeps_invoke_stats_per_buffer(self):
        sink = _ListCollect(stall_s=0.2)
        _drain_run(24, sink)
        assert sink.stats.total_invokes == 24

    def test_drain_size_metric_recorded(self):
        q = _drain_run(32, _ListCollect(stall_s=0.3))
        assert q.obs_snapshot().get("drain_size_p50") is not None

    def test_batched_upload_through_a_backlog(self):
        """A stalled consumer behind a prefetch-device queue: the backlog
        crosses as staged window uploads, in order, values unchanged."""
        sink = _ListCollect(stall_s=0.3)
        _drain_run(24, sink, prefetch_device=True)
        assert sink.values == [float(i) for i in range(24)]
        assert max(sink.list_sizes) > 1


def test_accepts_now_reports_a_full_queue():
    q = Queue(max_size_buffers=2)
    assert q.accepts_now()  # not started: passthrough
    q._worker = object()  # as if started, with the worker stalled
    q._q.maxsize = 2
    q._q.put(1)
    assert q.accepts_now()
    q._q.put(2)
    assert not q.accepts_now()


def test_leaky_drop_releases_the_stash():
    """A frame a leaky queue drops never reaches a fence: its staged
    arrays go back to the pool when it is dropped."""
    pool = get_pool()
    gate = threading.Event()

    class _Block(Element):
        ELEMENT_NAME = "_block"

        def __init__(self):
            super().__init__()
            self.add_sink_pad("sink")

        def chain(self, pad, buf):
            gate.wait(10)

    q = Queue(max_size_buffers=1, leaky="downstream")
    q.srcpad.link(_Block().sinkpad)
    q.start()
    try:
        staged = [pool.acquire((2,), np.float32) for _ in range(3)]
        bufs = [TensorBuffer([np.zeros(2, np.float32)],
                             meta={POOL_STASH_META: [s]}) for s in staged]
        q.chain(q.sinkpad, bufs[0])
        deadline = time.monotonic() + 5
        while q._q.qsize() and time.monotonic() < deadline:
            time.sleep(0.005)  # the worker holds frame 0 downstream
        q.chain(q.sinkpad, bufs[1])
        q.chain(q.sinkpad, bufs[2])  # drops frame 1, the oldest queued
        assert not pool.owns(staged[1])
        assert pool.owns(staged[0]) and pool.owns(staged[2])
        assert q.obs_snapshot()["drops"] == 1
    finally:
        gate.set()
        q.stop()


# -- staged transfers -----------------------------------------------------------
def _host_bufs(k, seed=0, pooled=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(k):
        a = rng.integers(0, 255, (2, 3, 4)).astype(np.uint8)
        if pooled:
            p = get_pool().acquire(a.shape, a.dtype)
            p[:] = a
            a = p
        out.append(TensorBuffer([a, np.float32(i) * np.ones(3, np.float32)],
                                pts=i, meta={"i": i},
                                finalize=lambda b: b.replace(
                                    meta={**b.meta, "done": True})))
    return out


def test_upload_many_equals_per_buffer_upload():
    bufs = _host_bufs(5, pooled=True)
    devs, slabs = upload_many(bufs, CPU)
    assert len(slabs) == 2  # one window slab per tensor index
    assert slabs[0].shape == (5, 2, 3, 4)
    for b, d in zip(bufs, devs):
        assert d.pts == b.pts and d.meta["i"] == b.meta["i"]
        assert d.meta[H2D_EXCLUSIVE_META] and d.finalize is b.finalize
        for h, t in zip(b.tensors, d.tensors):
            assert isinstance(t, torch.Tensor)
            assert t.numpy().tobytes() == np.asarray(h).tobytes()
            assert t.data_ptr() != np.asarray(h).ctypes.data  # a copy


def test_upload_many_from_consecutive_slots_copies_nothing():
    slab = get_pool().acquire_window(3, (4,), np.float32)
    slab[:] = np.arange(12, dtype=np.float32).reshape(3, 4)
    bufs = [TensorBuffer([slab[i]], pts=i) for i in range(3)]
    devs, slabs = upload_many(bufs, CPU)
    assert slabs == []  # zero-copy staging: no window slab taken
    assert [d.tensors[0].tolist() for d in devs] == slab.tolist()


def test_materialize_many_equals_per_buffer_to_host():
    bufs = _host_bufs(4, seed=1)
    dev = [b.replace(tensors=[torch.from_numpy(np.asarray(t).copy())
                              for t in b.tensors]) for b in bufs]
    dev.append(DeviceBuffer(tensors=[torch.ones(2)], pts=9,
                            finalize=lambda b: b.replace(meta={"last": 1})))
    before = transfer_snapshot()
    grouped = materialize_many(dev)
    single = [b.to_host() for b in dev]
    assert transfer_snapshot()["d2h_batched_events"] == \
        before["d2h_batched_events"]  # nothing lay on a card
    assert len(grouped) == len(single) == 5
    for g, s in zip(grouped, single):
        assert g.pts == s.pts and g.meta == s.meta
        assert [np.asarray(t).tobytes() for t in g.tensors] == \
            [np.asarray(t).tobytes() for t in s.tensors]
    assert grouped[-1] is dev[-1].to_host()  # the cache was filled


def test_device_buffer_host_view_is_zero_copy_and_pinned():
    pool = get_pool()
    host = pool.acquire((3,), np.float32)
    host[:] = 4.0
    # meta tensors stand in for a card's: "on the device", no data
    buf = DeviceBuffer(tensors=[torch.zeros(3, device="meta")],
                       host_view=[host],
                       finalize=lambda b: b.replace(meta={"f": 1}))
    assert pool.release(host) is False  # pinned by the host view
    out = buf.to_host()
    assert out.tensors[0] is host and out.meta == {"f": 1}
    assert buf.replace(meta={"x": 1})._host_src == [host]
    assert buf.replace(tensors=[torch.ones(3, device="meta")]) \
        ._host_src is None
    del buf, out
    import gc

    gc.collect()
    assert pool.release(host) is True  # the pin lifted with the buffer


def test_pad_rows_device():
    buf = TensorBuffer([torch.arange(6, dtype=torch.float32).reshape(3, 2)],
                       meta={"pad_rows": 2, "valid_frames": 3})
    out = buf.pad_rows_device()
    assert "pad_rows" not in out.meta and out.meta["valid_frames"] == 3
    assert out.tensors[0].tolist() == [[0, 1], [2, 3], [4, 5], [0, 0],
                                       [0, 0]]
    assert TensorBuffer([torch.ones(1)]).pad_rows_device().tensors[0] \
        .tolist() == [1.0]
