"""The reference perf gates (``tests/perf_smoke.py``) on the port, on the
same tiny CPU pipelines (``set_device("cpu")``, the flagship's shape at
16x16 with a registered torch model in place of the JAX one). Gates:

- enabling the dispatch window (`inflight=2`) changes NOTHING observable:
  same fused-region count, same region re-trace count
  (``nns_fuse_retraces_total`` — each re-trace is one eager first frame of
  a new input signature), and
  byte-identical per-frame outputs in the same order;
- the metrics endpoint exports the overlap series
  (``nns_filter_inflight``, ``nns_filter_fence_wait_seconds``,
  ``nns_pool_*``, ``nns_queue_drain_size``) and the transfer series
  (``nns_transfer_h2d_bytes_total``, ``nns_transfer_d2h_bytes_total``,
  ``nns_buffer_resident_ratio``);
- the device-resident tensor plane keeps the smoke pipeline's D2H
  traffic at its floor: at most one materialization per sink-delivered
  frame (``d2h_per_frame`` ≤ number of sinks), and turning it off
  (``NNSTPU_RESIDENT=0``) changes no byte;
- the whole-graph steady state batches transfers: staged multi-frame
  slab uploads (``nns_transfer_batched_h2d_total``), grouped result
  fetches, and ZERO per-frame D2H events on the golden pipeline;
- parallel ingest lanes (`--lanes`, pipeline/lanes.py) are correct AND
  profitable: ``lanes=2`` reproduces the serial run byte-for-byte in the
  same order while exporting the ``nns_lane_*`` series, and on a
  blocking-bound ingest segment 4 lanes beat 1 lane by >1.3× (the
  overlap gate is deliberately built on GIL-releasing blocking work so
  it holds on any host core count, including single-vCPU runners —
  CPU-bound numpy scaling depends on cores the gate can't assume);
- the always-on flight recorder (obs/flight.py) exports its streaming
  ``nns_stage_p50_ms``/``nns_stage_p99_ms`` gauges through BOTH
  ``/metrics`` and ``/metrics.json``, and costs <2% fps on a
  blocking-bound pipeline (median-of-5 vs ``NNSTPU_FLIGHT=0``).

The two timing gates are marked ``slow``, as in the JAX file; they use
no device. The four transfer gates count copies between the host and
the card and are marked ``gpu``. Both kinds run on the card's machine
with ``python3 tools/gpu_tests.py -m "slow or gpu"
tests/test_torch_perf_smoke.py``; this file imports no JAX.
"""

import re
import time
import urllib.request

import numpy as np
import pytest

import torch

import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu_torch import parse_launch
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.pipeline.element import Element
from nnstreamer_tpu_torch.tensors.buffer import transfer_snapshot

DESC = (
    "videotestsrc pattern=ball num-buffers=12 width=16 height=16 ! "
    "tensor_converter ! "
    "tensor_aggregator frames-in=1 frames-out=4 frames-flush=4 "
    "frames-dim=3 concat=true ! "
    "queue max-size-buffers=4 prefetch-device=true ! "
    "tensor_transform mode=arithmetic option=typecast:float32,div:255.0 ! "
    "tensor_filter framework=jax model=perf_smoke_sum name=filter "
    "inflight={k} ! "
    "queue max-size-buffers=8 materialize-host=true ! "
    "tensor_sink name=sink to-host=true"
)


class _Sum(torch.nn.Module):
    def forward(self, x):
        return torch.sum(x, dim=(1, 2, 3))[:, None]


@pytest.fixture(autouse=True)
def package_device(request):
    """The CPU, except for a ``gpu`` test: the transfer gates count copies
    between the host and the card, which the CPU does not make."""
    if request.node.get_closest_marker("gpu") is not None:
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU: the gate counts host<->card "
                        "transfers")
        tnt.set_device(None)
        yield
        return
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


@pytest.fixture
def model():
    register_torch_model("perf_smoke_sum", _Sum())
    yield "perf_smoke_sum"
    unregister_torch_model("perf_smoke_sum")


def _retraces_total() -> float:
    """Sum of every ``nns_fuse_retraces_total`` series in the registry —
    label-agnostic, so run-to-run deltas are comparable."""
    from nnstreamer_tpu_torch.obs import get_registry

    text = get_registry().render_prometheus()
    total = 0.0
    for line in text.splitlines():
        m = re.match(r"nns_fuse_retraces_total\{[^}]*\}\s+(\S+)", line)
        if m:
            total += float(m.group(1))
    return total


def _run(inflight: int, lanes: int = 1):
    pipe = parse_launch(DESC.format(k=inflight), lanes=lanes)
    msg = pipe.run(timeout=120)
    assert msg is not None and msg.kind == "eos", msg
    outs = [np.asarray(b.tensors[0]).copy()
            for b in pipe.get("sink").buffers]
    return pipe, outs


def test_inflight_window_is_observably_free(model):
    r0 = _retraces_total()
    pipe1, out1 = _run(inflight=1)
    r1 = _retraces_total()
    pipe2, out2 = _run(inflight=2)
    r2 = _retraces_total()

    # same topology decisions: fused-region count unchanged
    n_regions1 = len(pipe1._regions or [])
    n_regions2 = len(pipe2._regions or [])
    assert n_regions1 == n_regions2 and n_regions1 >= 1

    # no extra re-traces: each run re-traces its fresh region the same
    # number of times; inflight=2 must not add any
    assert (r1 - r0) == (r2 - r1) > 0

    # byte-identical per-frame outputs, same order
    assert len(out1) == len(out2) == 3  # 12 frames / batch 4
    for a, b in zip(out1, out2):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()


def test_metrics_endpoint_exports_overlap_series(model, monkeypatch):
    from nnstreamer_tpu_torch.obs import MetricsServer

    monkeypatch.delenv("NNSTPU_FLIGHT", raising=False)
    _pipe, outs = _run(inflight=2)
    assert outs
    srv = MetricsServer(port=0).start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=10) as r:
            body = r.read().decode()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics.json",
                timeout=10) as r:
            blob = r.read().decode()
    finally:
        srv.stop()
    for series in ("nns_filter_inflight",
                   "nns_filter_fence_wait_seconds",
                   "nns_pool_hits_total",
                   "nns_pool_misses_total",
                   "nns_pool_bytes_held",
                   "nns_queue_drain_size",
                   "nns_fuse_retraces_total",
                   "nns_fuse_whole_graph"):
        assert series in body, f"{series} missing from /metrics"
    # the flight recorder's streaming SLO gauges ride the same registry:
    # both the Prometheus text and the JSON snapshot must carry them
    # (the always-on recorder installs whenever no trace timeline is
    # active, so the run above fed them)
    for series in ("nns_stage_p50_ms", "nns_stage_p99_ms"):
        assert series in body, f"{series} missing from /metrics"
        assert series in blob, f"{series} missing from /metrics.json"


def _scrape():
    from nnstreamer_tpu_torch.obs import MetricsServer

    srv = MetricsServer(port=0).start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=10) as r:
            return r.read().decode()
    finally:
        srv.stop()


@pytest.mark.gpu
def test_metrics_endpoint_exports_transfer_series(model):
    """The transfer series of the JAX gate, after a run on the card (the
    CPU makes no host<->card copy, so it never creates them)."""
    _pipe, outs = _run(inflight=2)
    assert outs
    body = _scrape()
    for series in ("nns_transfer_h2d_bytes_total",
                   "nns_transfer_d2h_bytes_total",
                   "nns_transfer_batched_h2d_total",
                   "nns_transfer_batched_d2h_total",
                   "nns_buffer_resident_ratio"):
        assert series in body, f"{series} missing from /metrics"


@pytest.mark.gpu
def test_residency_off_is_byte_identical(model, monkeypatch):
    """The JAX gate's reference run (``tests/test_residency.py``):
    ``NNSTPU_RESIDENT=0`` gives the same bytes. On the card the default
    run enters its DeviceBuffers resident at every pad (the region and
    the drain queue), and the run with the switch off makes none."""
    monkeypatch.delenv("NNSTPU_RESIDENT", raising=False)
    before = transfer_snapshot()
    _pipe, on = _run(inflight=2)
    mid = transfer_snapshot()
    monkeypatch.setenv("NNSTPU_RESIDENT", "0")
    _pipe, off = _run(inflight=2)
    after = transfer_snapshot()
    assert len(on) == len(off) == 3
    assert [a.tobytes() for a in on] == [b.tobytes() for b in off]
    split = ("resident_entries", "materialized_entries")
    assert mid[split[0]] > before[split[0]]
    assert mid[split[1]] == before[split[1]]
    assert [after[k] for k in split] == [mid[k] for k in split]


@pytest.mark.gpu
def test_d2h_per_frame_at_floor(model):
    """The device plane's whole point: with every element between the
    upload queue and the sink device-passthrough, the ONLY D2H events a
    run may add are the sink's per-frame materializations — one per
    delivered frame per sink (this pipeline has exactly one sink)."""
    before = transfer_snapshot()
    _pipe, outs = _run(inflight=2)
    after = transfer_snapshot()
    frames = len(outs)
    assert frames == 3
    d2h_per_frame = (after["d2h_events"] - before["d2h_events"]) / frames
    assert d2h_per_frame <= 1.0, d2h_per_frame
    # and the run actually exercised the device path
    assert after["h2d_bytes"] > before["h2d_bytes"]


@pytest.mark.gpu
def test_whole_graph_batched_transfers_and_zero_d2h(model):
    """The transfer-batching gate (CI `perf-smoke` whole-graph step).

    On the golden device-decodable smoke pipeline the steady state must
    be: per-frame H2D copies coalesced into staged multi-frame slab
    uploads (one copy per drained window), sink-bound results
    carried by ONE grouped fetch per drained run, and — the
    headline number — ZERO per-frame D2H events
    (``d2h_per_frame == 0``; the bench reports the same field).
    Deterministic counter deltas, no timing involved, so no median/MAD
    gating is needed here — raw-value perf comparisons (lanes scaling,
    bench fps) are the ones that gate on the median."""
    before = transfer_snapshot()
    _pipe, outs = _run(inflight=2)
    after = transfer_snapshot()
    assert len(outs) == 3
    # staged multi-frame H2D engaged: the first window's eager frame
    # backs up the upload queue, so the next drain gathers >= 2 windows
    # and coalesces them into one slab upload
    assert after["h2d_batched_events"] > before["h2d_batched_events"]
    assert after["h2d_batched_frames"] - before["h2d_batched_frames"] >= 2
    # the materialize-host queue fetched results as grouped D2H runs
    assert after["d2h_batched_events"] > before["d2h_batched_events"]
    # the gate itself: not one per-frame D2H round trip in the whole run
    assert after["d2h_events"] == before["d2h_events"]


def test_retrace_counter_keys_on_batch_shape(model):
    """A second input batch shape (the aggregator's unpadded flush tail
    vs the full window) is a new input signature and must be counted as
    exactly ONE re-trace — and alternating between the two shapes
    afterwards must add none (the region keeps one entry per input
    signature, which absorbs both; a silent per-frame retrace
    here was the failure mode this counter exists to expose)."""
    pipe = parse_launch(
        "appsrc name=src ! "
        "tensor_transform mode=arithmetic option=typecast:float32,div:255.0 ! "
        "tensor_filter framework=jax model=perf_smoke_sum name=filter ! "
        "tensor_sink name=sink to-host=true")
    src, sink = pipe.get("src"), pipe.get("sink")
    pipe.start()
    try:
        assert pipe._regions, "transform+filter run did not fuse"
        full = np.arange(8 * 16 * 16 * 3, dtype=np.uint8).reshape(8, 16, 16, 3)
        tail = full[:4].copy()
        r0 = _retraces_total()
        src.push([full.copy()])
        sink.wait(1)
        r1 = _retraces_total()
        assert r1 - r0 == 1, "first shape: exactly one compile"
        src.push([tail.copy()])
        sink.wait(2)
        r2 = _retraces_total()
        assert r2 - r1 == 1, "tail batch shape: exactly one more compile"
        for _ in range(3):
            src.push([full.copy()])
            src.push([tail.copy()])
        src.end_of_stream()
        msg = pipe.wait(timeout=60)
        assert msg is not None and msg.kind == "eos", msg
        r3 = _retraces_total()
        assert r3 - r2 == 0, "alternating known shapes must not retrace"
        assert len(sink.buffers) == 8
    finally:
        pipe.stop()


def test_lanes_byte_identical_and_series_exported(model):
    """Ingest lanes on the full smoke pipeline: ``lanes=2`` must change
    nothing observable about the outputs (byte-identical frames, same
    order — the tentpole's correctness contract) while the lane
    telemetry appears in the Prometheus exposition."""
    from nnstreamer_tpu_torch.obs import get_registry

    _pipe1, out1 = _run(inflight=1, lanes=1)
    pipe2, out2 = _run(inflight=1, lanes=2)
    # the laned run really spliced an executor over the ingest segment
    assert pipe2._lane_execs, "lanes=2 did not splice an ingest executor"
    assert len(out1) == len(out2) == 3
    for a, b in zip(out1, out2):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()
    body = get_registry().render_prometheus()
    for series in ("nns_lane_occupancy",
                   "nns_ingest_fps",
                   "nns_lane_reorder_stall_seconds"):
        assert series in body, f"{series} missing from registry"


class _BlockingPre(Element):
    """Per-frame blocking preprocessing stand-in (think JPEG decode
    offload or a DMA wait): a fixed GIL-releasing sleep plus a trivial
    transform. Pure function of its input, so lane replication is safe."""

    ELEMENT_NAME = "_perf_blocking_pre"
    REORDER_SAFE = True
    PROPERTIES = {}

    def __init__(self, name=None, delay_s: float = 0.002, **props):
        super().__init__(name, **props)
        self.delay_s = delay_s
        self.add_sink_pad("sink")
        self.add_src_pad("src")

    def chain(self, pad, buf):
        time.sleep(self.delay_s)
        return self.srcpads[0].push(
            buf.with_tensors([t.astype(np.float32) for t in buf.tensors]))


@pytest.mark.slow
def test_ingest_scaling_with_lanes():
    """The acceptance gate: on an ingest-bound pipeline, 4 lanes must
    beat 1 lane by >1.3× frames/s (median of 3 runs each — warm-run fps
    spreads past 1.6× on shared runners, so a single-run or best-of
    comparison flakes where the median holds; same rationale as the
    bench's ``fps_median``/``spread_mad`` fields)."""
    from nnstreamer_tpu_torch.elements.sink import FakeSink
    from nnstreamer_tpu_torch.elements.source import VideoTestSrc
    from nnstreamer_tpu_torch.elements.converter import TensorConverter
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

    n_frames = 60

    def fps(lanes: int) -> float:
        pipe = Pipeline(name=f"scaling-l{lanes}", lanes=lanes)
        src = VideoTestSrc(pattern="gradient", num_buffers=n_frames,
                           width=64, height=64)
        conv = TensorConverter()
        pre = _BlockingPre(delay_s=0.005)
        sink = FakeSink(name="sink")
        pipe.add_linked(src, conv, pre, sink)
        t0 = time.monotonic()
        msg = pipe.run(timeout=120)
        dt = time.monotonic() - t0
        assert msg is not None and msg.kind == "eos", msg
        assert sink.count == n_frames, sink.count
        if lanes > 1:
            assert pipe._lane_execs, "segment did not replicate"
        return n_frames / dt

    def median3(lanes: int) -> float:
        return sorted(fps(lanes) for _ in range(3))[1]

    serial = median3(1)
    laned = median3(4)
    assert laned > 1.3 * serial, (serial, laned)


@pytest.mark.slow
def test_flight_recorder_overhead_under_budget(monkeypatch):
    """The always-on acceptance gate: with NNSTPU_FLIGHT unset the
    flight recorder runs on every frame, and its fps cost on a
    realistic (blocking-bound) pipeline must stay under 2%. Measured as
    median-of-3 flight-off vs flight-on on the same sleep-dominated
    workload the lanes gate uses — wall-clock there is pinned by the
    per-frame sleep, so the recorder's per-span cost is the only moving
    part and the 2% budget is a real bound, not scheduler noise."""
    from nnstreamer_tpu_torch.elements.sink import FakeSink
    from nnstreamer_tpu_torch.elements.source import VideoTestSrc
    from nnstreamer_tpu_torch.elements.converter import TensorConverter
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

    n_frames = 60

    def fps() -> float:
        pipe = Pipeline(name="flight-overhead")
        src = VideoTestSrc(pattern="gradient", num_buffers=n_frames,
                           width=32, height=32)
        conv = TensorConverter()
        pre = _BlockingPre(delay_s=0.005)
        sink = FakeSink(name="sink")
        pipe.add_linked(src, conv, pre, sink)
        t0 = time.monotonic()
        msg = pipe.run(timeout=120)
        dt = time.monotonic() - t0
        assert msg is not None and msg.kind == "eos", msg
        assert sink.count == n_frames
        return n_frames / dt

    def median5() -> float:
        fps()  # warm-up: first run pays import/alloc noise
        return sorted(fps() for _ in range(5))[2]

    monkeypatch.setenv("NNSTPU_FLIGHT", "0")
    off = median5()
    monkeypatch.delenv("NNSTPU_FLIGHT")
    on = median5()
    assert on >= 0.98 * off, (off, on)
