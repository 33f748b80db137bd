"""Ingest lanes in the PyTorch port (``pipeline/lanes.py``), held to the JAX
package's.

- Lanes 1, 2 and 4 are byte-identical to the JAX package's lanes 1, 2 and 4
  and to each other, in order, with the EOS drained: on a seeded
  ``videotestsrc`` chain, under per-frame jitter that finishes frames out
  of order, and on the flagship at batch 8 (bench.py's launch string at
  32×32, weights converted from the JAX model: labels exactly, scores to
  rtol 1e-4 and atol 1e-4 × max|score|).
- ``plan_lane_segments`` picks the same elements as the JAX planner.
- ``NNSTPU_LANES`` and ``effective_lanes`` behave as the JAX package's.
- Each lane stages frames in its own pool arena, and an H2D copy still in
  flight gates that arena's ``acquire`` as it gates the shared pool's (on
  the CPU with a stand-in event; on the card, in a ``gpu`` test, behind a
  long kernel).
"""

import random
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.elements.sink import TensorSink as JaxSink
from nnstreamer_tpu.filters.jax_backend import (
    register_jax_model,
    unregister_jax_model,
)
from nnstreamer_tpu.models.mobilenet_v2 import mobilenet_v2 as jax_mobilenet_v2
from nnstreamer_tpu.pipeline import element as jelement
from nnstreamer_tpu.pipeline import lanes as jlanes
from nnstreamer_tpu.pipeline import pipeline as jpipeline
from nnstreamer_tpu.tensors.buffer import TensorBuffer as JaxBuffer
from nnstreamer_tpu.tensors.types import TensorsConfig as JaxConfig
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2, params_from_jax
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.pipeline import element
from nnstreamer_tpu_torch.pipeline import lanes
from nnstreamer_tpu_torch.pipeline import pipeline as tpipeline
from nnstreamer_tpu_torch.pipeline.lanes import (
    effective_lanes,
    plan_lane_segments,
)
from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline
from nnstreamer_tpu_torch.tensors import pool as tpool
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensors.pool import get_lane_pool
from nnstreamer_tpu_torch.tensors.types import TensorsConfig

SIZE, CLASSES = 32, 10
PKGS = {
    "jax": dict(pkg=jnt, el=jelement, pipe=jpipeline, sink=JaxSink,
                buf=JaxBuffer, cfg=JaxConfig, lanes=jlanes),
    "port": dict(pkg=tnt, el=element, pipe=tpipeline, sink=TensorSink,
                 buf=TensorBuffer, cfg=TensorsConfig, lanes=lanes),
}


@pytest.fixture(autouse=True)
def _cpu():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


# -- a seeded chain through both packages ---------------------------------------
CHAIN = ("videotestsrc pattern=ball num-buffers=24 width={s} height={s} ! "
         "tensor_converter ! tensor_transform mode=arithmetic "
         "option=typecast:float32,add:-3.0 ! queue ! tensor_sink name=out")


def _chain_outputs(pkg, n_lanes, desc=CHAIN):
    pipe = PKGS[pkg]["pkg"].parse_launch(desc.format(s=SIZE), lanes=n_lanes)
    outs = []
    pipe.get("out").connect(lambda b: outs.append(
        (b.pts, [np.asarray(t).copy() for t in b.tensors])))
    msg = pipe.run(timeout=120)
    assert msg is not None and msg.kind == "eos"
    assert pipe.get("out").eos
    return outs, pipe


@pytest.mark.parametrize("n_lanes", [1, 2, 4])
def test_chain_byte_identical_to_jax_and_serial(n_lanes):
    ref, _ = _chain_outputs("jax", n_lanes)
    got, pipe = _chain_outputs("port", n_lanes)
    serial, _ = _chain_outputs("port", 1)
    assert len(got) == len(ref) == len(serial) == 24
    for (pg, tg), (pr, tr), (ps, ts) in zip(got, ref, serial):
        assert pg == pr == ps
        for a, b, c in zip(tg, tr, ts):
            assert a.dtype == b.dtype == c.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes() == c.tobytes()
    if n_lanes > 1:
        (ex,) = pipe._lane_execs
        assert ex.n == n_lanes and ex._delivered == ex._seq == 24
        with ex._cv:
            assert ex._pending == {}
    else:
        assert pipe._lane_execs == []


def _classes(pkg):
    """The JAX test's index source and jittered pure transform on
    ``pkg``'s base classes: frames finish out of order across lanes."""
    m = PKGS[pkg]

    class SeqSrc(m["pipe"].SourceElement):
        ELEMENT_NAME = "_laneseqsrc"
        REORDER_SAFE = True
        PROPERTIES = {**m["pipe"].SourceElement.PROPERTIES,
                      "num_buffers": 24}

        def __init__(self, name=None, **props):
            super().__init__(name, **props)
            self.i = 0

        def negotiate(self):
            cfg = m["cfg"].from_arrays([np.zeros((4,), np.float32)])
            self.srcpad.set_caps(cfg.to_caps())

        def create(self):
            if self.i >= self.get_property("num_buffers"):
                return None
            buf = m["buf"]([np.full((4,), float(self.i), np.float32)],
                           pts=self.i * 1000)
            self.i += 1
            return buf

    class Jitter(m["el"].Element):
        ELEMENT_NAME = "_lanejitter"
        REORDER_SAFE = True
        PROPERTIES = {**m["el"].Element.PROPERTIES, "max_delay_ms": 4.0}

        def __init__(self, name=None, **props):
            super().__init__(name, **props)
            self.add_sink_pad("sink")
            self.add_src_pad("src")

        def chain(self, pad, buf):
            time.sleep(random.uniform(
                0.0, self.get_property("max_delay_ms")) / 1e3)
            self.srcpad.push(buf.with_tensors(
                [np.asarray(t) * 2.0 + 1.0 for t in buf.tensors]))
            return m["el"].FlowReturn.OK

    return SeqSrc, Jitter


def _jitter_run(pkg, n_lanes, n=24, max_delay_ms=4.0):
    random.seed(7)
    m = PKGS[pkg]
    SeqSrc, Jitter = _classes(pkg)
    pipe = m["pipe"].Pipeline(name=f"lanes-jitter-{pkg}-{n_lanes}",
                              lanes=n_lanes)
    sink = m["sink"](name="out")
    pipe.add_linked(SeqSrc(num_buffers=n), Jitter(max_delay_ms=max_delay_ms),
                    sink)
    outs = []
    sink.connect(lambda b: outs.append(
        (b.pts, np.asarray(b.tensors[0]).tobytes())))
    msg = pipe.run(timeout=60)
    assert msg is not None and msg.kind == "eos"
    return outs, pipe


@pytest.mark.parametrize("n_lanes", [2, 4, 8])
def test_out_of_order_lanes_reassemble_as_jax(n_lanes):
    ref, _ = _jitter_run("jax", n_lanes, n=32)
    got, pipe = _jitter_run("port", n_lanes, n=32)
    serial, _ = _jitter_run("port", 1, n=32)
    assert got == ref == serial and len(got) == 32
    (ex,) = pipe._lane_execs
    assert ex._delivered == ex._seq == 32


def test_pipe_lanes_attribute_after_parse_and_the_constructor():
    pipe = tnt.parse_launch(CHAIN.format(s=8))
    pipe.lanes = 4  # as bench.py sets it after parse_launch
    pipe.run(timeout=60)
    assert pipe._lane_execs[0].n == 4
    p2 = Pipeline(name="lanes-ctor", lanes=4)
    assert p2.lanes == 4


# -- the flagship at batch 8 ------------------------------------------------------
def _flagship(model, labels, n, ingress="queue max-size-buffers=16 "
              "stamp-admission=true"):
    """bench.py's default string at 32×32, with a blocking ingress (a
    leaky one drops frames by timing, which no parity test can hold)."""
    return (
        f"videotestsrc num-buffers={n} width={SIZE} height={SIZE} "
        f"pattern=ball ! tensor_converter ! {ingress} ! "
        "tensor_aggregator frames-in=1 frames-out=8 frames-flush=8 "
        "frames-dim=3 concat=true ! "
        "queue max-size-buffers=8 prefetch-device=true ! "
        "tensor_transform mode=arithmetic "
        "option=typecast:float32,add:-127.5,div:127.5 ! "
        f"tensor_filter framework=jax model={model} name=filter "
        "inflight=2 ! "
        f"tensor_decoder mode=image_labeling option1={labels} "
        "option2=batched ! "
        "queue max-size-buffers=64 materialize-host=true ! "
        "tensor_sink name=out to-host=true")


@pytest.fixture
def labels(tmp_path):
    path = tmp_path / "labels.txt"
    path.write_text("".join(f"label_{i}\n" for i in range(CLASSES)))
    return str(path)


@pytest.fixture(scope="module")
def parity_model():
    apply_fn, variables, in_info, out_info = jax_mobilenet_v2(
        num_classes=CLASSES, image_size=SIZE, dtype=jnp.float32, seed=5,
        batch=8)
    module = MobileNetV2(num_classes=CLASSES)
    module.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                        variables)))
    register_jax_model("lanes_parity", apply_fn, variables, in_info=in_info,
                       out_info=out_info)
    register_torch_model("lanes_parity", module.eval())
    yield "lanes_parity"
    unregister_jax_model("lanes_parity")
    unregister_torch_model("lanes_parity")


def _metas(pipe):
    got = []
    pipe.get("out").connect(lambda buf: got.append(buf.meta))
    msg = pipe.run(timeout=300)
    assert msg is not None and msg.kind == "eos"
    return got


@pytest.mark.parametrize("n_lanes", [1, 2, 4])
def test_flagship_lanes_match_jax(parity_model, labels, n_lanes):
    n = 24
    ref = _metas(jnt.parse_launch(_flagship(parity_model, labels, n),
                                  lanes=n_lanes))
    pipe = tnt.parse_launch(_flagship(parity_model, labels, n),
                            lanes=n_lanes)
    got = _metas(pipe)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g["label"] == r["label"] and len(g["label"]) == 8
        assert g["label_index"] == r["label_index"]
        rs = np.array(r["score"])
        np.testing.assert_allclose(g["score"], rs, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(rs).max()))
        # one admission stamp a frame rode through the window
        assert len(g["admitted_ts"]) == 8
    snap = pipe.metrics_snapshot()
    assert ("lanes" in snap) == (n_lanes > 1)
    if n_lanes > 1:
        (lanes_snap,) = snap["lanes"].values()
        assert lanes_snap["forwarded"] == n and lanes_snap["lanes"] == n_lanes
    # every lane count of the port gives the same bytes
    serial = _metas(tnt.parse_launch(_flagship(parity_model, labels, n)))
    assert [(m["label"], m["label_index"], m["score"]) for m in got] == \
        [(m["label"], m["label_index"], m["score"]) for m in serial]


def test_plan_picks_the_jax_segments(parity_model, labels):
    """The planner's walk from each source: the flagship string (its
    ingress queue ends the segment), and chains a converter or a queue
    cuts short, before and after fusion."""
    descs = [
        _flagship(parity_model, labels, 8),
        CHAIN.format(s=8),
        "videotestsrc num-buffers=2 ! tensor_converter ! "
        "tensor_transform mode=arithmetic option=add:1.0 ! tensor_sink",
        "videotestsrc num-buffers=2 ! tensor_converter frames-per-tensor=2 "
        "! tensor_sink",
        "appsrc ! tensor_converter ! tensor_sink",
    ]
    for desc in descs:
        seg = {}
        for pkg in ("jax", "port"):
            pipe = PKGS[pkg]["pkg"].parse_launch(desc)
            plans = PKGS[pkg]["lanes"].plan_lane_segments(pipe)
            seg[pkg] = [(src.ELEMENT_NAME,
                         [el.ELEMENT_NAME for el in segment])
                        for src, segment in plans]
        assert seg["port"] == seg["jax"], desc
    # after fusion, as start() plans: the flagship's segment is the
    # converter alone in both packages
    got = {}
    for pkg in ("jax", "port"):
        pipe = PKGS[pkg]["pkg"].parse_launch(
            _flagship(parity_model, labels, 8), lanes=4)
        pipe.start()
        try:
            (ex,) = pipe._lane_execs
            got[pkg] = [el.ELEMENT_NAME for el in ex.segment]
        finally:
            pipe.stop()
    assert got["port"] == got["jax"] == ["tensor_converter"]


# -- env override -----------------------------------------------------------------
def test_kill_switch_restores_the_serial_path(monkeypatch):
    monkeypatch.setenv("NNSTPU_LANES", "1")
    outs, pipe = _chain_outputs("port", 8)
    assert pipe._lane_execs == [] and len(outs) == 24
    src = next(e for e in pipe.elements if e.ELEMENT_NAME == "videotestsrc")
    assert src.srcpad.peer.element.ELEMENT_NAME == "tensor_converter"
    assert "lanes" not in pipe.metrics_snapshot()


def test_env_forces_the_lane_count(monkeypatch):
    monkeypatch.setenv("NNSTPU_LANES", "3")
    _, pipe = _chain_outputs("port", 1)
    assert pipe._lane_execs[0].n == 3


@pytest.mark.parametrize("env,requested", [
    (None, 4), (None, 0), (None, None), ("2", 8), ("bogus", 5), ("0", 3),
])
def test_effective_lanes_as_jax(monkeypatch, env, requested):
    if env is None:
        monkeypatch.delenv("NNSTPU_LANES", raising=False)
    else:
        monkeypatch.setenv("NNSTPU_LANES", env)
    assert effective_lanes(requested) == jlanes.effective_lanes(requested)
    assert lanes.lanes_override() == jlanes.lanes_override()


# -- lane arenas and the slab gate -----------------------------------------------
def test_lane_pools_are_distinct_arenas():
    p0, p1 = get_lane_pool(0), get_lane_pool(1)
    assert p0 is not p1 and p0 is get_lane_pool(0)
    assert p0.name == "ingest-lane0" and p1.name == "ingest-lane1"
    assert p0 is not tpool.get_pool()
    p0.clear()
    p1.clear()
    a = p0.acquire((64,), np.float32)
    assert p0.release(a)
    del a
    assert p0.snapshot()["free"] == 1
    misses = p1.snapshot()["misses"]
    p1.acquire((64,), np.float32)
    assert p1.snapshot()["misses"] == misses + 1
    assert p0.snapshot()["free"] == 1


def test_release_all_pools_frees_the_lane_arenas():
    p = get_lane_pool(2)
    p.clear()
    a = p.acquire((32,), np.uint8)
    p.release(a)
    del a
    assert p.snapshot()["free"] == 1
    tpool.release_all_pools()
    assert p.snapshot()["free"] == 0


def test_lanes_stage_through_their_own_pool():
    for k in range(2):
        get_lane_pool(k).clear()
    before = [get_lane_pool(k).snapshot() for k in range(2)]
    outs, _ = _jitter_run("port", 2, n=16, max_delay_ms=0.5)
    assert len(outs) == 16
    for k in range(2):
        snap = get_lane_pool(k).snapshot()
        assert snap["hits"] + snap["misses"] - \
            before[k]["hits"] - before[k]["misses"] >= 1


class _Pending:
    """A copy event that has not completed until told."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done


def test_copy_in_flight_gates_a_lane_slab():
    """``note_copy`` finds the lane arena that holds a slab, and that
    arena's ``acquire`` passes the slab over until the copy's event has
    completed — the shared pool's gate, on a lane arena."""
    pool = get_lane_pool(3)
    pool.clear()
    win = pool.acquire_window(8, (4, 4, 3), np.uint8)
    slot = win[2]
    ev = _Pending()
    assert tpool.note_copy(slot, ev)
    assert not tpool.get_pool().owns(win)
    del slot
    assert pool.release(win)
    del win
    waits = pool.snapshot()["copy_waits"]
    fresh = pool.acquire_window(8, (4, 4, 3), np.uint8)
    assert pool.snapshot()["copy_waits"] == waits + 1  # passed over
    ev.done = True
    pool.release(fresh)
    del fresh
    again = pool.acquire_window(8, (4, 4, 3), np.uint8)
    assert again is not None and pool.snapshot()["free"] >= 0


def test_pool_alloc_fault_fires_on_growth_only():
    from nnstreamer_tpu_torch.pipeline import faults

    pool = get_lane_pool(4)
    pool.clear()
    a = pool.acquire((16,), np.float32)
    pool.release(a)
    del a
    faults.activate("pool.alloc:every=1")
    try:
        held = pool.acquire((16,), np.float32)  # recycled: no fault
        with pytest.raises(faults.InjectedFault, match="pool.alloc"):
            pool.acquire((16,), np.float32)
        assert held is not None
    finally:
        faults.deactivate()


# -- metrics ----------------------------------------------------------------------
def test_lanes_metrics_match_the_jax_series():
    _, pipe = _jitter_run("port", 4, n=20, max_delay_ms=0.5)
    snap = pipe.metrics_snapshot()
    (s,) = snap["lanes"].values()
    assert s["lanes"] == 4 and s["forwarded"] == 20
    assert s["reorder_depth"] == 0 and s["reorder_stall_s"] >= 0.0
    _, jpipe = _jitter_run("jax", 4, n=20, max_delay_ms=0.5)
    (js,) = jpipe.metrics_snapshot()["lanes"].values()
    assert set(s) == set(js)
    labels = pipe._lane_execs[0]._obs_labels()
    reg = get_registry()
    for name in ("nns_lane_reorder_stall_seconds", "nns_lane_occupancy",
                 "nns_ingest_fps"):
        assert reg.get(name, **labels) is not None


def test_splice_persists_and_state_resets_across_restart():
    SeqSrc, Jitter = _classes("port")
    pipe = Pipeline(name="lanes-restart", lanes=2)
    sink = TensorSink(name="out")
    pipe.add_linked(SeqSrc(num_buffers=6), Jitter(max_delay_ms=0.5), sink)
    outs = []
    sink.connect(lambda b: outs.append(float(np.asarray(b.tensors[0])[0])))
    assert pipe.run(timeout=30).kind == "eos"
    assert outs == [1.0, 3.0, 5.0, 7.0, 9.0, 11.0]
    (ex,) = pipe._lane_execs
    assert ex._seq == 6 and ex._delivered == 6
    pipe.start()
    try:
        assert pipe._lane_execs[0] is ex
        assert ex._seq == 0 and ex._next == 0 and ex._delivered == 0
    finally:
        pipe.stop()


# -- on the card ----------------------------------------------------------------------
@pytest.mark.gpu
def test_lane_slab_gate_holds_behind_a_long_kernel():
    """A lane slab whose H2D copy is queued behind a long kernel is passed
    over by its arena's ``acquire`` until the copy completes, so a recycled
    slab can never be rewritten under the copy that reads it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: page-locked lane slabs and CUDA "
                    "events")
    from nnstreamer_tpu_torch.tensors.buffer import as_torch

    tnt.set_device(None)
    pool = get_lane_pool(5)
    pool.clear()
    win = pool.acquire_window(8, (64, 64, 3), np.uint8)
    win[:] = 7
    dev = torch.device("cuda:0")
    a = torch.randn(4096, 4096, device=dev)
    for _ in range(20):  # a long kernel queue ahead of the copy
        a = a @ a
        a = a / a.norm()
    out = as_torch(win, dev, non_blocking=True)  # records the copy event
    assert tpool.pinned_view(win) is not None
    pool.release(win)
    del win
    waits = pool.snapshot()["copy_waits"]
    other = pool.acquire_window(8, (64, 64, 3), np.uint8)
    assert pool.snapshot()["copy_waits"] == waits + 1
    other[:] = 9  # a fresh slab: the copy's source is untouched
    torch.cuda.synchronize()
    assert bool((out == 7).all())


@pytest.mark.gpu
def test_lane_arena_grows_safely_during_a_capture():
    """Lane workers page-lock new slabs while another thread captures a
    CUDA graph in ``thread_local`` mode (the fused region's); the capture
    and its replay stay intact."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA-graph capture")
    import threading

    tnt.set_device(None)
    dev = torch.device("cuda:0")
    pool = get_lane_pool(6)
    pool.clear()
    x = torch.ones(1024, device=dev)
    stream = torch.cuda.Stream(dev)
    stop = threading.Event()
    grown = []

    def grow():
        k = 0
        while not stop.is_set():
            grown.append(pool.acquire_window(8, (32 + k % 7, 32, 3),
                                             np.uint8))
            k += 1

    t = threading.Thread(target=grow, daemon=True)
    graph = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream(dev))
    t.start()
    try:
        with torch.cuda.stream(stream):
            for _ in range(3):
                y = x * 2 + 1
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode="thread_local"):
                for _ in range(200):
                    y = y * 1.0 + 0.0
    finally:
        stop.set()
        t.join(timeout=10)
    graph.replay()
    torch.cuda.synchronize()
    assert grown and bool((y == 3).all())
