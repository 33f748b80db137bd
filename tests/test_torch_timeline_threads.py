"""The frame ledger's thread spans, its one clock with ``torch.profiler``,
and the thread, GC and pool counters of the port (``obs/timeline.py``,
``obs/collectors.py``, ``pipeline/pipeline.py``, ``tensors/pool.py``).

- A ledger span mapped onto the profiler's clock lands inside the
  ``record_function`` span it was taken in, within 1 ms; the export on
  the profiler's clock is the default export moved onto that clock.
- Thread spans are off by default: a default ledger and the always-on
  flight recorder record exactly the records of the JAX package's, frame
  by frame and in all.
- On, each pipeline thread of the flagship's batch-8 string is covered
  90-100 % by its ``wait_*``, ``gc`` and outermost ``chain`` spans over
  a 1-s slice, and a GC pause is a ``gc`` span of the thread that ran it.
- ``nns_queue_blocked_seconds_total`` counts a producer held ~20 ms by
  its consumer whole, and the ``wait_output`` span is the same reading.
- ``nns_thread_cpu_seconds_total``, ``nns_gc_pause_seconds`` and
  ``nns_pool_copy_waits_total`` exist and only go up.
- On the card: a ledger span around the synchronisation binding lines up
  with the profiler's ``cudaDeviceSynchronize`` within 50 µs at both ends.
"""

import gc
import json
import threading
import time

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.obs import timeline as jtimeline
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.obs import timeline as _timeline
from nnstreamer_tpu_torch.obs.timeline import THREAD_KINDS, Timeline
from nnstreamer_tpu_torch.pipeline import element
from nnstreamer_tpu_torch.pipeline import pipeline as tpipeline
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

GOLDEN = ("videotestsrc pattern=ball num-buffers=24 width=16 height=16 ! "
          "tensor_converter ! queue ! tensor_sink name=sink")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.delenv("NNSTPU_FLIGHT", raising=False)
    monkeypatch.delenv("NNSTPU_TRACE", raising=False)
    _timeline.deactivate()
    jtimeline.deactivate()
    tnt.set_device("cpu")
    yield
    _timeline.deactivate()
    jtimeline.deactivate()
    tnt.set_device(None)


def _union(spans):
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


# -- one clock ----------------------------------------------------------------
def test_a_ledger_span_lands_inside_its_record_function_span():
    from torch.profiler import ProfilerActivity, profile, record_function

    tl = Timeline()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with record_function(f"ledger_probe{i}"):
                t0 = time.monotonic()
                time.sleep(0.005)
                t1 = time.monotonic()
            tl.span("chain", None, t0, t1, element=f"probe{i}")
    events = {ev.name(): (ev.start_ns(), ev.end_ns())
              for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith("ledger_probe")}
    assert len(events) == 3
    recs = tl.profiler_records()
    assert len(recs) == 3
    for _thread, _kind, _seq, a, b, _track, args in recs:
        start, end = events["ledger_" + args["element"]]
        assert start - 1_000_000 <= a and b <= end + 1_000_000, \
            (a - start, end - b)
        assert b - a >= 5_000_000


def test_profiler_clock_export_is_the_default_export_moved():
    tl = Timeline()
    t = time.monotonic()
    tl.span("chain", None, t, t + 0.002, element="x")
    tl.span("sink", 0, t + 0.002, t + 0.003, track="out", e2e_s=0.003)
    wall_us = time.time_ns() / 1e3
    ledger, prof = tl.to_chrome(), tl.to_chrome(clock="profiler")
    assert ledger == tl.to_chrome("ledger")
    xs = [e for e in prof["traceEvents"] if e["ph"] == "X"]
    assert abs(xs[0]["ts"] - wall_us) < 1e3
    shift = prof["traceEvents"][-1]["ts"] - ledger["traceEvents"][-1]["ts"]
    for a, b in zip(ledger["traceEvents"], prof["traceEvents"]):
        if "ts" in a:
            assert abs(b["ts"] - a["ts"] - shift) < 1.0
        else:
            assert a["args"]["name"] == b["args"]["name"]
    named = [e for e in prof["traceEvents"] if e["name"] == "thread_name"]
    assert any(e["args"].get("native_tid") == threading.get_native_id()
               for e in named)
    with pytest.raises(ValueError, match="clock"):
        tl.to_chrome(clock="wall")


def test_profiler_correlation_writes_the_ledger_on_its_clock(tmp_path):
    with _timeline.tracing() as tl, \
            _timeline.profiler_correlation(str(tmp_path)) as prof:
        tnt.parse_launch(GOLDEN).run(timeout=60)
    assert prof.ledger_path == str(tmp_path / "ledger.json")
    ledger = json.loads((tmp_path / "ledger.json").read_text())
    trace = json.loads((tmp_path / "profiler.json").read_text())
    base = trace["baseTimeNanoseconds"]
    assert ledger["baseTimeNanoseconds"] == base == \
        _timeline.trace_base_ns(prof.trace_path)
    ours = [(e["ts"], e["ts"] + e["dur"]) for e in ledger["traceEvents"]
            if e["ph"] == "X"]
    theirs = [(e["ts"], e["ts"] + e.get("dur", 0))
              for e in trace["traceEvents"] if e.get("ph") == "X"]
    assert ours and theirs
    # one time axis: the ledger's spans fall inside the profiled run
    assert min(theirs)[0] - 1e3 <= min(ours)[0]
    assert max(b for _, b in ours) <= max(b for _, b in theirs) + 1e3
    assert tl.stage_breakdown()["frames"] == 24


# -- off by default -----------------------------------------------------------
def test_thread_spans_are_off_by_default():
    assert _timeline.THREADS is None
    _timeline.activate()
    assert _timeline.THREADS is None
    _timeline.deactivate()
    with _timeline.tracing() as tl:
        tnt.parse_launch(GOLDEN).run(timeout=60)
    assert not [r for r in tl._snapshot() if r[1] in THREAD_KINDS]
    with _timeline.tracing(threads=True) as tl:
        assert _timeline.THREADS is tl
        tnt.parse_launch(GOLDEN).run(timeout=60)
    assert _timeline.THREADS is None
    kinds = {r[1] for r in tl._snapshot() if r[2] is None}
    assert {"wait_input", "chain"} <= kinds
    # the stage reports read frames only: the same as with spans off
    assert tl.stage_breakdown()["frames"] == 24


def _records(tl):
    per_frame = {}
    for _thread, kind, seq, _t0, t1, _track, _args in tl._snapshot():
        if seq is not None and t1 is not None:
            per_frame.setdefault(seq, []).append(kind)
    return {k: sorted(v) for k, v in per_frame.items()}, len(tl._snapshot())


@pytest.mark.parametrize("recorder", ["ledger", "flight"])
def test_records_per_frame_equal_the_jax_package(recorder):
    got = {}
    for pkg, mod, tl_mod in (("jax", jnt, jtimeline),
                             ("port", tnt, _timeline)):
        if recorder == "ledger":
            with tl_mod.tracing() as tl:
                mod.parse_launch(GOLDEN).run(timeout=60)
        else:
            pipe = mod.parse_launch(GOLDEN)
            pipe.run(timeout=60)
            tl = pipe._flight
            assert tl is not None
            assert pkg == "jax" or _timeline.THREADS is not tl
        got[pkg] = _records(tl)
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == 24


# -- on: coverage of each pipeline thread -------------------------------------
class _Scores(torch.nn.Module):
    """[N, H, W, C] → [N, 4]: a frame's mean times four weights."""

    def __init__(self):
        super().__init__()
        self.register_buffer("w", torch.arange(1.0, 5.0)[None])

    def forward(self, x):
        return x.float().mean(dim=(1, 2, 3))[:, None] * self.w


@pytest.fixture
def flagship_b8(tmp_path):
    """The benchmark's batch-8 string at 16×16 with a small model: appsrc,
    converter, ingress 16, aggregator of 8, staging queue, the fused
    transform ! filter ! decoder, the materialize-host drain."""
    labels = tmp_path / "labels.txt"
    labels.write_text("".join(f"l{i}\n" for i in range(4)))
    register_torch_model("thr_flag", _Scores())
    yield ("appsrc name=src caps=video/x-raw,format=RGB,width=16,height=16,"
           "framerate=0/1 max-buffers=64 block=true ! tensor_converter ! "
           "queue max-size-buffers=16 ! tensor_aggregator frames-in=1 "
           "frames-out=8 frames-flush=8 frames-dim=3 concat=true ! "
           "queue max-size-buffers=8 prefetch-device=true ! "
           "tensor_transform mode=arithmetic "
           "option=typecast:float32,add:-127.5,div:127.5 ! "
           "tensor_filter framework=torch model=thr_flag inflight=2 ! "
           f"tensor_decoder mode=image_labeling option1={labels} "
           "option2=batched ! queue max-size-buffers=64 "
           "materialize-host=true ! tensor_sink name=sink to-host=true")
    unregister_torch_model("thr_flag")


def _closed_loop(desc, seconds, name, at=0.3, threads=True):
    """Push as fast as appsrc takes frames; the ledger on from ``at`` s
    for ``seconds``. Returns the timeline, the pipeline, its thread names
    and the ledger's bounds."""
    pipe = tnt.parse_launch(desc, pipeline=tpipeline.Pipeline(name=name))
    pipe.start()
    names = [t.name for t in pipe.threads()]
    src, stop = pipe.get("src"), threading.Event()
    frame = np.arange(16 * 16 * 3, dtype=np.uint8).reshape(16, 16, 3)

    def push():
        while not stop.is_set():
            src.push([frame])
        for _ in range(7):  # whole windows
            src.push([frame])

    pusher = threading.Thread(target=push, daemon=True)
    pusher.start()
    try:
        time.sleep(at)
        tl = _timeline.activate(1 << 18, threads=threads)
        t0 = time.monotonic()
        time.sleep(seconds)
        t1 = time.monotonic()
        _timeline.deactivate()
    finally:
        stop.set()
        pusher.join(timeout=30)
        src.end_of_stream()
        msg = pipe.wait(timeout=60)
        pipe.stop()
    assert msg is not None and msg.kind == "eos", msg
    return tl, pipe, names, (t0, t1)


def test_each_pipeline_thread_is_covered_by_its_spans(flagship_b8):
    tl, pipe, names, (t0, t1) = _closed_loop(
        flagship_b8, 1.4, f"thr-cover-{time.monotonic_ns()}")
    assert len(names) == 4  # the source and three queue workers
    s0, s1 = t0 + 0.2, t0 + 1.2
    by_thread = {}
    for thread, kind, seq, a, b, _track, _args in tl._snapshot():
        if kind in THREAD_KINDS and b is not None and a < s1 and b > s0:
            by_thread.setdefault(thread, []).append((max(a, s0), min(b, s1)))
    for name in names:
        cover = _union(by_thread.get(name, [])) / (s1 - s0)
        assert 0.90 <= cover <= 1.0 + 1e-9, (name, cover)
    # the window's frames reached the sink and were counted by the ledger
    assert tl.stage_breakdown()["frames"] > 0
    assert pipe.get("sink").buffers


def test_a_gc_pause_is_a_span_of_the_collecting_thread():
    pipe = tnt.parse_launch(
        "appsrc name=src ! queue ! tensor_sink name=sink",
        pipeline=tpipeline.Pipeline(name=f"thr-gc-{time.monotonic_ns()}"))
    reg = get_registry()
    pipe.start()
    try:
        hist = reg.get("nns_gc_pause_seconds", generation="2")
        before = hist.count
        done, snapped = threading.Event(), threading.Event()

        def probe():
            gc.collect()
            done.set()
            snapped.wait(timeout=30)

        with _timeline.tracing(threads=True) as tl:
            worker = threading.Thread(target=probe, name="thr-gc-probe")
            worker.start()
            assert done.wait(timeout=30)
        # a thread without a ring is named while it lives
        spans = [r for r in tl._snapshot() if r[1] == "gc"]
        snapped.set()
        worker.join()
        reg.collect()  # a scrape observes the pauses the hook holds
        assert hist.count == before + 1
    finally:
        pipe.get("src").end_of_stream()
        pipe.wait(timeout=30)
        pipe.stop()
    assert [(r[0], r[6]["generation"]) for r in spans] == \
        [("thr-gc-probe", 2)]
    assert "thr-gc-probe" in tl.native_ids
    # the hook leaves with the last running pipeline
    assert _timeline._GC_HOOK not in gc.callbacks


def test_a_collection_inside_a_scrape_of_the_gc_histogram_ends():
    """A collection that starts while a scrape holds the lock of
    ``nns_gc_pause_seconds`` (allocating as it copies the buckets): the
    hook takes no lock, so the collection and the scrape both end, and
    the next scrape observes the pause."""

    class _Collecting(list):
        def __iter__(self):
            gc.collect(0)
            return super().__iter__()

    pipe = tnt.parse_launch(
        "appsrc name=src ! queue ! tensor_sink name=sink",
        pipeline=tpipeline.Pipeline(name=f"thr-gc-lock-{time.monotonic_ns()}"))
    reg = get_registry()
    pipe.start()
    try:
        hist = reg.get("nns_gc_pause_seconds", generation="0")
        reg.collect()
        before = hist.count
        plain = hist._counts
        hist._counts = _Collecting(plain)
        try:
            scrape = threading.Thread(target=hist.bucket_counts,
                                      daemon=True)
            scrape.start()
            scrape.join(timeout=10)
            assert not scrape.is_alive(), "the collection never ended"
        finally:
            hist._counts = plain
        reg.collect()
        assert hist.count >= before + 1
    finally:
        pipe.get("src").end_of_stream()
        pipe.wait(timeout=30)
        pipe.stop()


# -- the counters -------------------------------------------------------------
def test_a_blocked_producer_counts_its_whole_wait():
    """A queue of one, its worker held 20 ms by the element behind it: the
    third push blocks until the hold ends, and the counter takes that
    wait whole (its first 100 ms poll included)."""

    class Hold(element.Element):
        ELEMENT_NAME = "_thr_hold"

        def __init__(self, name=None, **props):
            super().__init__(name, **props)
            self.add_sink_pad("sink")
            self.entered = threading.Event()
            self.release = threading.Event()

        def chain(self, pad, buf):
            self.entered.set()
            assert self.release.wait(timeout=10)
            return element.FlowReturn.OK

    name = f"thr-blocked-{time.monotonic_ns()}"
    pipe = tpipeline.Pipeline(name=name, fuse=False)
    q = tpipeline.Queue(name="q", max_size_buffers=1)
    hold = Hold(name="hold")
    pipe.add_linked(q, hold)
    pipe.start()
    blocked = get_registry().get("nns_queue_blocked_seconds_total",
                                 pipeline=name, element="q")

    def buf(i):
        return TensorBuffer([np.array([float(i)], np.float32)])

    try:
        with _timeline.tracing(threads=True) as tl:
            q._chain_entry(q.sinkpads[0], buf(0))
            assert hold.entered.wait(timeout=5)
            q._chain_entry(q.sinkpads[0], buf(1))  # the free slot
            assert blocked.value == 0.0
            threading.Timer(0.02, hold.release.set).start()
            t0 = time.monotonic()
            q._chain_entry(q.sinkpads[0], buf(2))
            outside = time.monotonic() - t0
        waited = blocked.value
    finally:
        hold.release.set()
        q.sink_event(q.sinkpads[0], element.EosEvent())
        pipe.stop()
    # 15-40 ms, or as long as the push took on a host slow to wake the
    # timer; never more than the push
    assert 0.015 <= waited <= max(0.040, outside), (waited, outside)
    assert waited <= outside
    spans = [r for r in tl._snapshot() if r[1] == "wait_output"]
    assert len(spans) == 1 and spans[0][6] == {"element": "q"}
    assert spans[0][4] - spans[0][3] == pytest.approx(waited, abs=1e-9)


def test_thread_and_gc_counters_exist_and_only_go_up(flagship_b8):
    name = f"thr-counters-{time.monotonic_ns()}"
    reg = get_registry()

    def cpu():
        return {m.labels["thread"]: m.value for m in reg.collect()
                if m.name == "nns_thread_cpu_seconds_total"
                and m.labels.get("pipeline") == name}

    pipe = tnt.parse_launch(flagship_b8,
                            pipeline=tpipeline.Pipeline(name=name))
    pipe.start()
    src = pipe.get("src")
    frame = np.zeros((16, 16, 3), np.uint8)
    readings = []
    try:
        for _ in range(3):
            for _ in range(32):
                src.push([frame])
            time.sleep(0.2)
            gc.collect()
            readings.append((cpu(), {
                g: reg.get("nns_gc_pause_seconds", generation=g).count
                for g in "012"}))
    finally:
        src.end_of_stream()
        pipe.wait(timeout=60)
        pipe.stop()
    names = [f"{name}:src"] + [f"queue{i}-worker" for i in range(3)]
    assert set(readings[0][0]) == set(readings[-1][0]) and \
        len(readings[0][0]) == 4, readings[0][0]
    assert set(readings[0][0]) >= {names[0]}
    for (a, ga), (b, gb) in zip(readings, readings[1:]):
        assert all(b[t] >= a[t] for t in a)
        assert all(gb[g] >= ga[g] for g in ga) and gb["2"] > ga["2"]
    assert sum(readings[-1][0].values()) > 0.0


def test_copy_waits_is_a_counter():
    """A free slab a copy still reads is passed over: the snapshot's
    ``copy_waits`` and ``nns_pool_copy_waits_total`` count it alike."""
    from nnstreamer_tpu_torch.tensors.pool import BufferPool

    class _Pending:
        def query(self):
            return False

    pool = BufferPool(name=f"thr-pool-{time.monotonic_ns()}")
    a = pool.acquire((8,), np.float32)
    assert pool.note_copy(a, _Pending()) is True
    assert pool.release(a) is True
    counter = get_registry().get("nns_pool_copy_waits_total",
                                 pool=pool.name)
    assert counter.value == 0.0
    pool.acquire((8,), np.float32)
    assert pool.snapshot()["copy_waits"] == counter.value == 1


# -- on the card --------------------------------------------------------------
@pytest.mark.gpu
def test_a_ledger_span_lines_up_with_the_profilers_synchronize():
    """``torch.cuda._sleep`` keeps the card busy for some ms; the ledger
    span taken around the synchronisation that waits for it, mapped onto
    the profiler's clock, starts and ends within 50 µs of the runtime's
    ``cudaDeviceSynchronize`` event. The span brackets the binding that
    ``torch.cuda.synchronize()`` calls inside its device context: under
    the profiler that context's own Python and runtime calls put 10-73 µs
    before the synchronisation on an H100's host, which is the wrapper's
    time, not the clocks' error."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the profiler's CUDA runtime "
                    "events")
    from torch.profiler import ProfilerActivity, profile

    tl = Timeline()
    torch.cuda.synchronize()
    ends = []
    # the benchmark's profiler: CUDA activity (kernels, copies and the
    # runtime calls), no host operator events
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(8):
            torch.cuda._sleep(20_000_000)
            t0 = time.monotonic()
            torch._C._cuda_synchronize()
            t1 = time.monotonic()
            if i >= 3:  # past the profiler's first callbacks
                tl.span("fence_wait", None, t0, t1)
    syncs = sorted((ev.start_ns(), ev.end_ns())
                   for ev in prof.profiler.kineto_results.events()
                   if ev.name() == "cudaDeviceSynchronize")
    ours = sorted((r[3], r[4]) for r in tl.profiler_records())
    assert len(syncs) >= 8 and len(ours) == 5
    for a, b in ours:
        start, end = min(syncs, key=lambda s: abs(s[0] - a))
        ends.append(((start - a) / 1e3, (b - end) / 1e3))
    print("ledger start before the runtime call, runtime end before the "
          "ledger end (µs):", ends)
    assert all(abs(x) <= 50 and abs(y) <= 50 for x, y in ends), ends
