"""The always-on flight recorder in the PyTorch port (``obs/flight.py``,
``obs/quantiles.py``, ``obs/server.py``), held to the JAX package's.

The cases of ``tests/test_flight.py`` run on both packages, and the same
span records must give both recorders the same streaming quantiles, burn
rates, attribution and dump content (timestamps and paths aside; floats
equal, since the arithmetic is the same Python):

- P² quantiles track the exact order statistics of seeded uniform,
  lognormal and bimodal data (the JAX test's tolerances), and marker
  states merge;
- tail, deadline, fault and watchdog triggers, the post-offender window,
  rate limiting and the flush at retirement;
- burn-rate overload, its bus warning and the scheduler's multiplicative
  decrease; attribution and its hints;
- every pipeline records by default, ``NNSTPU_FLIGHT=0`` turns it off,
  and the output bytes do not change; ``NNSTPU_FLIGHT=<dir>`` with an
  injected stall writes one dump around the stalled frame; the gauges
  reach Prometheus text, the JSON snapshot and ``MetricsServer`` over
  HTTP.
"""

import glob
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.obs import flight as jflight
from nnstreamer_tpu.obs import get_registry as jget_registry
from nnstreamer_tpu.obs import quantiles as jquantiles
from nnstreamer_tpu.obs import timeline as jtimeline
from nnstreamer_tpu.pipeline import faults as jfaults
from nnstreamer_tpu.pipeline import pipeline as jpipeline
from nnstreamer_tpu.serving import scheduler as jscheduler
from nnstreamer_tpu_torch.obs import MetricsServer
from nnstreamer_tpu_torch.obs import flight as _flight
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.obs import quantiles
from nnstreamer_tpu_torch.obs import timeline as _timeline
from nnstreamer_tpu_torch.pipeline import faults
from nnstreamer_tpu_torch.pipeline import pipeline as tpipeline
from nnstreamer_tpu_torch.serving import scheduler

PKGS = {
    "jax": dict(flight=jflight, q=jquantiles, tl=jtimeline, pipe=jpipeline,
                sched=jscheduler, faults=jfaults, mod=jnt,
                reg=jget_registry),
    "port": dict(flight=_flight, q=quantiles, tl=_timeline, pipe=tpipeline,
                 sched=scheduler, faults=faults, mod=tnt, reg=get_registry),
}
BOTH = pytest.mark.parametrize("pkg", ["jax", "port"])
GOLDEN = ("videotestsrc pattern=ball num-buffers=24 width=16 height=16 ! "
          "tensor_converter ! queue ! tensor_sink name=sink")


@pytest.fixture(autouse=True)
def _cpu_and_clean(monkeypatch):
    tnt.set_device("cpu")
    monkeypatch.delenv("NNSTPU_FLIGHT", raising=False)
    yield
    for m in PKGS.values():
        m["tl"].deactivate()
        m["faults"].deactivate()
    tnt.set_device(None)


# -- P² quantiles ----------------------------------------------------------------
@BOTH
@pytest.mark.parametrize("p,tol", [(0.5, 0.05), (0.99, 0.08)])
def test_p2_uniform(rng, pkg, p, tol):
    data = rng.uniform(0.0, 1.0, 4000)
    q = PKGS[pkg]["q"].P2Quantile(p)
    for x in data:
        q.observe(x)
    exact = float(np.percentile(data, p * 100))
    assert abs(q.quantile() - exact) <= tol * max(exact, 0.1)


@BOTH
@pytest.mark.parametrize("p,tol", [(0.5, 0.05), (0.99, 0.10)])
def test_p2_lognormal(rng, pkg, p, tol):
    data = rng.lognormal(0.0, 0.5, 4000)
    q = PKGS[pkg]["q"].P2Quantile(p)
    for x in data:
        q.observe(x)
    exact = float(np.percentile(data, p * 100))
    assert abs(q.quantile() - exact) <= tol * exact


def test_p2_bimodal_and_markers_equal_jax(rng):
    fast = rng.normal(0.010, 0.001, 3600)
    slow = rng.normal(0.500, 0.020, 400)
    data = rng.permutation(np.concatenate([fast, slow]))
    got = {}
    for pkg in ("jax", "port"):
        p50 = PKGS[pkg]["q"].P2Quantile(0.5)
        p99 = PKGS[pkg]["q"].P2Quantile(0.99)
        for x in data:
            p50.observe(float(x))
            p99.observe(float(x))
        got[pkg] = (p50.snapshot(), p99.snapshot(), p50.quantile(),
                    p99.quantile())
    assert got["port"] == got["jax"]
    assert abs(got["port"][2] - float(np.percentile(data, 50))) <= 0.005
    assert abs(got["port"][3] - float(np.percentile(data, 99))) <= 0.08


def test_p2_small_counts_are_exact():
    q = quantiles.P2Quantile(0.5)
    assert q.quantile() is None
    for x in (5.0, 1.0, 3.0):
        q.observe(x)
    assert q.quantile() == 3.0


def test_p2_concurrent_observers(rng):
    data = rng.uniform(0.0, 1.0, 4000)
    q = quantiles.P2Quantile(0.5)

    def feed(chunk):
        for x in chunk:
            q.observe(x)

    threads = [threading.Thread(target=feed, args=(c,), daemon=True)
               for c in np.array_split(data, 8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert q.count == len(data)
    assert abs(q.quantile() - float(np.percentile(data, 50))) <= 0.05


@pytest.mark.parametrize("p", [0.5, 0.99])
def test_marker_merge_equals_jax(rng, p):
    data = rng.lognormal(0.0, 0.5, 4000)
    got = {}
    for pkg in ("jax", "port"):
        qmod = PKGS[pkg]["q"]
        snaps = []
        for chunk in np.array_split(data, 4):
            q = qmod.P2Quantile(p)
            for x in chunk:
                q.observe(float(x))
            snaps.append(q.snapshot())
        got[pkg] = qmod.merge_p2_snapshots(snaps, p)
    assert got["port"] == got["jax"]
    exact = float(np.percentile(data, p * 100))
    assert abs(got["port"] - exact) <= 0.15 * exact


@BOTH
def test_burn_rate_window(pkg):
    B = PKGS[pkg]["q"].BurnRateWindow
    b = B(window_s=10.0, error_budget=0.1)
    for i in range(100):
        b.add(i * 0.05, breached=(i % 2 == 0))
    assert b.rate(5.0) == pytest.approx(5.0, abs=0.5)
    b = B(window_s=1.0, error_budget=0.5)
    b.add(0.0, True)
    b.add(0.1, True)
    assert b.rate(0.5) == pytest.approx(2.0)
    assert b.rate(10.0) == 0.0 and b.sample_count(10.0) == 0
    b = B(window_s=1e9, error_budget=1.0, cap=10)
    for i in range(50):
        b.add(float(i), breached=True)
    assert b.sample_count(50.0) == 10 and b.rate(50.0) == pytest.approx(1.0)


# -- the recorder on synthetic span records ---------------------------------------
def _feed_frame(fr, seq, e2e_s, device_s=None, t0=None):
    """One device span and the sink completion span, as the JAX test."""
    t = float(seq) if t0 is None else t0
    d = device_s if device_s is not None else e2e_s / 2
    fr.span("device", seq, t, t + d)
    fr.span("sink", seq, t + d, t + e2e_s, e2e_s=e2e_s)


def _strip(doc):
    """A dump without what differs run to run: wall time, epoch-relative
    times, dump paths and the recorder's per-process thread names."""
    doc = json.loads(json.dumps(doc))
    doc.pop("wall_time")
    doc["trigger"].pop("t_ms")
    for s in doc["spans"]:
        s.pop("t0_ms")
        s.pop("t1_ms")
        s.pop("thread")
    doc["slo"].get("dumps", {}).pop("paths", None)
    return doc


def _scenario(pkg, tmp_path):
    """Tail, deadline and fault triggers on one recorder with a budget,
    then a retirement flush: (recorder, dump documents)."""
    d = tmp_path / pkg
    fr = PKGS[pkg]["flight"].FlightRecorder(
        dump_dir=str(d), min_samples=5, window_frames=2,
        min_interval_s=0.0, tail_k=4.0, slo_budget_s=0.1)
    rng = np.random.default_rng(7)
    for seq in range(40):
        e2e = float(rng.uniform(0.002, 0.004))
        if seq in (12, 27):
            e2e = 0.5                    # tail and deadline offenders
        _feed_frame(fr, seq, e2e, t0=seq * 0.01)
        if seq == 33:
            fr.mark("fault", seq, t=seq * 0.01 + 0.001, track="faults",
                    site="filter.invoke")
    _feed_frame(fr, 40, 0.9, t0=0.4)     # an offender right before EOS
    PKGS[pkg]["tl"].ACTIVE = fr
    PKGS[pkg]["flight"].retire(fr)
    docs = [json.loads(open(p).read()) for p in sorted(glob.glob(
        str(d / "*.json")))]
    return fr, docs


def test_same_records_same_recorder_state_as_jax(tmp_path):
    got, gdocs = _scenario("port", tmp_path)
    ref, rdocs = _scenario("jax", tmp_path)
    assert got.quantile_states() == ref.quantile_states()
    assert got.attribution() == ref.attribution()
    assert got.trigger_counts == ref.trigger_counts
    assert got.burn_rates(0.41) == ref.burn_rates(0.41)
    assert got.burn_overload(0.41) == ref.burn_overload(0.41)
    gs, rs = got.slo_snapshot(), ref.slo_snapshot()
    gs["dumps"].pop("paths")
    rs["dumps"].pop("paths")
    gs["burn"].pop("fast"), rs["burn"].pop("fast")   # read "now": clocks
    gs["burn"].pop("slow"), rs["burn"].pop("slow")
    gs["burn"].pop("overloaded"), rs["burn"].pop("overloaded")
    assert gs == rs
    assert len(gdocs) == len(rdocs) >= 3
    assert [_strip(d) for d in gdocs] == [_strip(d) for d in rdocs]
    kinds = [d["trigger"]["kind"] for d in gdocs]
    assert "deadline" in kinds and "fault" in kinds
    assert got.trigger_counts["tail"] >= 2


@BOTH
def test_tail_event_dumps_window_once(tmp_path, pkg):
    fr = PKGS[pkg]["flight"].FlightRecorder(
        dump_dir=str(tmp_path), min_samples=5, window_frames=2,
        min_interval_s=3600.0, tail_k=4.0)
    for seq in range(10):
        _feed_frame(fr, seq, 0.002)
    _feed_frame(fr, 10, 0.500)
    assert fr.last_trigger["kind"] == "tail" and fr.last_trigger["seq"] == 10
    assert not list(tmp_path.glob("*.json"))
    _feed_frame(fr, 11, 0.002)
    _feed_frame(fr, 12, 0.002)
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    doc = json.loads(files[0].read_text())
    assert doc["trigger"]["kind"] == "tail" and doc["trigger"]["seq"] == 10
    assert {s["kind"] for s in doc["spans"] if s["seq"] == 10} >= \
        {"device", "sink"}
    assert (doc["window"]["seq_lo"], doc["window"]["seq_hi"]) == (8, 12)
    for seq, e2e in ((13, 0.5), (14, 0.002), (15, 0.002), (16, 0.002)):
        _feed_frame(fr, seq, e2e)
    assert len(list(tmp_path.glob("*.json"))) == 1
    assert fr.suppressed_dumps == 1


@BOTH
def test_watchdog_flushes_immediately(tmp_path, pkg):
    fr = PKGS[pkg]["flight"].FlightRecorder(
        dump_dir=str(tmp_path), min_samples=5, window_frames=4,
        min_interval_s=3600.0)
    for seq in range(6):
        _feed_frame(fr, seq, 0.002)
    fr.mark("watchdog_trip", None, track="faults", idle_s=1.5)
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    doc = json.loads(files[0].read_text())
    assert doc["trigger"]["kind"] == "watchdog"
    assert doc["trigger"]["detail"]["mark"] == "watchdog_trip"


@BOTH
def test_deadline_breach_and_no_dump_dir(pkg):
    F = PKGS[pkg]["flight"].FlightRecorder
    fr = F(dump_dir=None, min_samples=5, window_frames=1,
           min_interval_s=0.0, slo_budget_s=0.010)
    _feed_frame(fr, 0, 0.050)
    assert fr.last_trigger["kind"] == "deadline"
    for seq in range(1, 9):
        _feed_frame(fr, seq, 0.002)
    _feed_frame(fr, 9, 0.500)
    _feed_frame(fr, 10, 0.002)
    _feed_frame(fr, 11, 0.002)
    assert fr.trigger_counts["tail"] >= 1 and fr.dump_count == 0


@BOTH
def test_retire_flushes_pending(tmp_path, pkg):
    m = PKGS[pkg]
    fr = m["flight"].FlightRecorder(dump_dir=str(tmp_path), min_samples=5,
                                    window_frames=50, min_interval_s=3600.0)
    for seq in range(10):
        _feed_frame(fr, seq, 0.002)
    _feed_frame(fr, 10, 0.500)
    assert not list(tmp_path.glob("*.json"))
    m["tl"].ACTIVE = fr
    m["flight"].retire(fr)
    assert m["tl"].ACTIVE is None
    assert len(list(tmp_path.glob("*.json"))) == 1


@BOTH
def test_burn_overload_and_bus_warning(pkg):
    m = PKGS[pkg]
    pipe = m["pipe"].Pipeline(name=f"tflight-burn-{pkg}")
    fr = m["flight"].FlightRecorder(slo_budget_s=0.010, min_samples=5,
                                    pipeline=pipe)
    for seq in range(20):
        _feed_frame(fr, seq, 0.050, t0=seq * 0.1)
    now = 19 * 0.1 + 0.05
    fast, slow = fr.burn_rates(now)
    assert fast > 2.0 and slow > 2.0 and fr.burn_overload(now)
    kinds = []
    while (msg := pipe.pop_message(timeout=0)) is not None:
        kinds.append(msg.kind)
    assert "warning" in kinds


@BOTH
@pytest.mark.parametrize("stage,hint", [
    ("ingest", {"lanes_hint_delta": 1}),
    ("fence_wait", {"inflight_pressure": True}),
    ("sched_hold", {"batch_cap_pressure": True}),
])
def test_attribution_names_the_dominant_stage(pkg, stage, hint):
    fr = PKGS[pkg]["flight"].FlightRecorder(min_samples=5)
    for seq in range(20):
        t = float(seq)
        d = 0.050 if seq % 2 else 0.001
        fr.span(stage, seq, t, t + d)
        fr.span("device", seq, t + d, t + d + 0.002)
        fr.span("sink", seq, t + d + 0.002, t + d + 0.003, e2e_s=d + 0.003)
    attr = fr.attribution()
    assert attr["dominant_stage"] == stage and attr["dominant_share"] > 0
    assert attr["hints"] == hint


@BOTH
def test_slo_snapshot_has_stage_quantiles(pkg):
    fr = PKGS[pkg]["flight"].FlightRecorder(min_samples=5)
    for seq in range(32):
        _feed_frame(fr, seq, 0.004, device_s=0.002)
    slo = fr.slo_snapshot()
    assert slo["completed"] == 32
    assert slo["stages"]["e2e"]["p50_ms"] == pytest.approx(4.0, rel=0.2)
    assert slo["stages"]["device"]["p50_ms"] == pytest.approx(2.0, rel=0.2)
    assert slo["stages"]["device"]["count"] == 32


@BOTH
def test_checkpoint_state_round_trips(pkg):
    F = PKGS[pkg]["flight"].FlightRecorder
    a = F(min_samples=5)
    for seq in range(20):
        _feed_frame(fr=a, seq=seq, e2e_s=0.002 + seq * 1e-4)
    b = F(min_samples=5)
    b.restore_state(a.checkpoint_state())
    assert b.quantile_states() == a.quantile_states()
    assert b.attribution() == a.attribution()


class _FakeFlight:
    def __init__(self, hints=None, overload=False):
        self._hints, self._overload = hints or {}, overload

    def attribution(self):
        return {"hints": dict(self._hints)}

    def burn_overload(self, now=None):
        return self._overload


@BOTH
def test_overload_and_hints_reach_the_scheduler(pkg):
    m = PKGS[pkg]
    c = m["sched"].FeedbackController(budget_s=1.0, interval_s=0.0,
                                      batch_cap=8, inflight=4)
    for _ in range(16):
        c.record_completion(0.01)
    assert c.maybe_step(now=100.0, overload=True)
    assert (c.batch_cap, c.inflight) == (4, 3)
    pipe = m["pipe"].Pipeline(name=f"tflight-hint-{pkg}")
    sched = m["sched"].SloScheduler(budget_ms=100.0, pipeline=pipe,
                                    name=f"tflight-hint-{pkg}")
    pipe._flight = _FakeFlight()
    sched._apply_knobs()
    base = sched._lanes_hint
    pipe._flight = _FakeFlight(hints={"lanes_hint_delta": 1})
    sched._apply_knobs()
    assert sched._lanes_hint == base + 1


# -- the recorder on every pipeline -------------------------------------------------
def _golden(pkg):
    pipe = PKGS[pkg]["mod"].parse_launch(GOLDEN)
    assert pipe.run(timeout=120).kind == "eos"
    return pipe


def test_kill_switch_disables_recorder(monkeypatch):
    monkeypatch.setenv("NNSTPU_FLIGHT", "0")
    assert not _flight.flight_enabled()
    pipe = _golden("port")
    assert pipe._flight is None
    assert "slo" not in pipe.metrics_snapshot()


def test_always_on_recorder_fills_snapshot_and_keeps_bytes(monkeypatch):
    pipe_on, ref = _golden("port"), _golden("jax")
    assert pipe_on._flight is not None
    assert _timeline.ACTIVE is None, "retired at stop"
    snap = pipe_on.metrics_snapshot()
    assert snap["slo"]["completed"] == ref.metrics_snapshot()[
        "slo"]["completed"] == 24
    assert set(snap["slo"]["stages"]) == set(
        ref.metrics_snapshot()["slo"]["stages"])
    assert "attribution" in snap and "quantiles" in snap
    monkeypatch.setenv("NNSTPU_FLIGHT", "0")
    pipe_off = _golden("port")
    on = [np.asarray(b.tensors[0]).tobytes()
          for b in pipe_on.get("sink").buffers]
    off = [np.asarray(b.tensors[0]).tobytes()
           for b in pipe_off.get("sink").buffers]
    assert on == off, "the always-on recorder changed output bytes"


def test_explicit_timeline_wins_over_flight():
    tl = _timeline.activate()
    try:
        pipe = _golden("port")
        assert pipe._flight is None and _timeline.ACTIVE is tl
    finally:
        _timeline.deactivate()


@BOTH
def test_env_dump_dir_produces_dump_on_stall(tmp_path, monkeypatch, pkg):
    """NNSTPU_FLIGHT=<dir> and an injected stall: exactly one dump whose
    window contains the offender."""
    monkeypatch.setenv("NNSTPU_FLIGHT", str(tmp_path))
    monkeypatch.setenv("NNSTPU_FLIGHT_MIN_SAMPLES", "6")
    PKGS[pkg]["faults"].activate("queue.push:nth=16,kind=stall,ms=250",
                                 seed=3)
    try:
        _golden(pkg)
    finally:
        PKGS[pkg]["faults"].deactivate()
    files = glob.glob(str(tmp_path / "*.json"))
    assert len(files) == 1, files
    doc = json.loads(open(files[0]).read())
    assert doc["trigger"]["kind"] in ("fault", "tail")
    seqs = {s["seq"] for s in doc["spans"] if s["seq"] is not None}
    assert doc["trigger"]["seq"] is None or doc["trigger"]["seq"] in seqs


class _Scores(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("w", torch.arange(1.0, 5.0)[None])

    def forward(self, x):
        return x.float().mean(dim=(1, 2, 3))[:, None] * self.w


def test_invoke_stall_on_a_fused_flagship_is_attributed_to_device(
        tmp_path, monkeypatch):
    """The chip_smoke ``flight`` phase at a small size: ``filter.invoke``
    stalls on the fused batch-8 flagship, with no queue between the
    source and the region (a queue would absorb the stall as its
    ``queue_wait``): the dump holds the stalled window, and attribution
    names ``device``."""
    from nnstreamer_tpu_torch.filters.torch_backend import (
        register_torch_model,
        unregister_torch_model,
    )

    labels = tmp_path / "labels.txt"
    labels.write_text("".join(f"l{i}\n" for i in range(4)))
    register_torch_model("tflight_flag", _Scores())
    dumps = tmp_path / "dumps"
    monkeypatch.setenv("NNSTPU_FLIGHT", str(dumps))
    monkeypatch.setenv("NNSTPU_FLIGHT_MIN_SAMPLES", "6")
    faults.activate("filter.invoke:every=2,kind=stall,ms=40")
    try:
        pipe = tnt.parse_launch(
            "videotestsrc num-buffers=160 width=16 height=16 pattern=ball ! "
            "tensor_converter ! tensor_aggregator frames-in=1 frames-out=8 "
            "frames-flush=8 frames-dim=3 concat=true ! "
            "tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! "
            "tensor_filter framework=jax model=tflight_flag ! "
            f"tensor_decoder mode=image_labeling option1={labels} "
            "option2=batched ! tensor_sink name=out")
        assert pipe.run(timeout=120).kind == "eos"
    finally:
        faults.deactivate()
        unregister_torch_model("tflight_flag")
    assert pipe._regions and not pipe._regions[0]._dead
    attr = pipe.metrics_snapshot()["attribution"]
    assert attr["dominant_stage"] == "device", attr
    files = glob.glob(str(dumps / "*.json"))
    assert len(files) == 1, files
    doc = json.loads(open(files[0]).read())
    assert doc["trigger"]["kind"] == "fault"
    stalled = doc["trigger"]["seq"]
    assert any(s["seq"] == stalled and s["kind"] == "device"
               for s in doc["spans"])


# -- gauges and the HTTP server -----------------------------------------------------
@BOTH
def test_stage_and_burn_gauges_export_text_and_json(pkg):
    m = PKGS[pkg]
    fr = m["flight"].FlightRecorder(slo_budget_s=0.010, min_samples=5)
    fr.pipeline_name = f"tflight-gauge-{pkg}"
    for seq in range(16):
        _feed_frame(fr, seq, 0.004)
    fr.register_gauges()
    text = m["reg"]().render_prometheus()
    for name in ("nns_stage_p50_ms{", "nns_stage_p99_ms{",
                 "nns_slo_burn_rate{"):
        assert name in text
    line = [ln for ln in text.splitlines()
            if ln.startswith("nns_stage_p50_ms") and 'stage="e2e"' in ln
            and f'pipeline="tflight-gauge-{pkg}"' in ln]
    assert line and float(line[0].rsplit(None, 1)[1]) > 0
    blob = json.dumps(m["reg"]().snapshot())
    assert "nns_stage_p50_ms" in blob and "nns_slo_burn_rate" in blob


def test_metrics_server_serves_stage_quantiles_over_http():
    pipe = _golden("port")

    def sections(p=pipe):
        snap = p.metrics_snapshot()
        return {k: snap[k] for k in ("slo", "attribution", "quantiles")}

    with MetricsServer(host="127.0.0.1", port=0,
                       snapshot_fn=sections) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        text = urllib.request.urlopen(base + "/metrics",
                                      timeout=10).read().decode()
        blob = json.loads(urllib.request.urlopen(base + "/metrics.json",
                                                 timeout=10).read())
        ok = urllib.request.urlopen(base + "/healthz", timeout=10).read()
    rows = [ln for ln in text.splitlines()
            if ln.startswith("nns_stage_p99_ms") and 'stage="e2e"' in ln
            and f'pipeline="{pipe.name}"' in ln]
    assert rows and float(rows[-1].rsplit(None, 1)[1]) > 0
    assert blob["slo"]["completed"] == 24 and "attribution" in blob
    assert ok == b"ok\n"


def test_metrics_server_serves_a_federation():
    """``MetricsServer(federation=)`` serves ``/fleet/metrics`` and
    ``/fleet/metrics.json`` from the aggregator it is given, as the JAX
    server does; without one those paths are 404."""
    import json
    import urllib.error
    import urllib.request

    class Fed:
        def render_prometheus(self):
            return "nns_fleet_endpoint_up 1\n"

        def collect(self):
            return {"endpoints": {"h:1": {"ok": True}}}

    with MetricsServer(host="127.0.0.1", port=0, federation=Fed()) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/fleet/metrics",
                                    timeout=10) as r:
            assert r.read() == b"nns_fleet_endpoint_up 1\n"
        with urllib.request.urlopen(base + "/fleet/metrics.json",
                                    timeout=10) as r:
            assert json.loads(r.read()) == {
                "endpoints": {"h:1": {"ok": True}}}
    with MetricsServer(host="127.0.0.1", port=0) as srv:
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/fleet/metrics", timeout=10)
