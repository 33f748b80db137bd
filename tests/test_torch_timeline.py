"""The frame-ledger timeline in the PyTorch port (``obs/timeline.py``), held
to the JAX package's.

- The recorder is the JAX module's: the same records give the same stage
  breakdown, variance report and Chrome export.
- On the same pipeline both packages record the same stages and the same
  spans per frame (lanes 1 and 4); the stages reconcile with the sink's
  end-to-end time within max(10 %, 0.5 ms), the bound of
  ``tests/test_timeline.py``, also on the flagship at batch 8.
- With tracing off nothing is recorded, no frame carries a trace seq, and
  the output is byte-identical to a traced run.
- ``stamp-admission`` counts admissions and the revocations of admitted
  frames a leaky queue drops, as the JAX queue does in the same
  deterministic scenario, and the sink reports latency by ``base``.
- ``profiler_correlation`` writes a loadable ``torch.profiler`` trace.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.obs import get_registry as jget_registry
from nnstreamer_tpu.obs import timeline as jtimeline
from nnstreamer_tpu.pipeline import element as jelement
from nnstreamer_tpu.pipeline import pipeline as jpipeline
from nnstreamer_tpu.tensors.buffer import TensorBuffer as JaxBuffer
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.obs import timeline as _timeline
from nnstreamer_tpu_torch.obs.timeline import STAGES, TRACE_SEQ_META, Timeline
from nnstreamer_tpu_torch.pipeline import element
from nnstreamer_tpu_torch.pipeline import pipeline as tpipeline
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

GOLDEN = ("videotestsrc pattern=ball num-buffers=24 width=16 height=16 ! "
          "tensor_converter ! queue ! tensor_sink name=sink")
PKGS = {"jax": (jnt, jtimeline), "port": (tnt, _timeline)}


@pytest.fixture(autouse=True)
def _no_timeline():
    _timeline.deactivate()
    jtimeline.deactivate()
    tnt.set_device("cpu")
    yield
    _timeline.deactivate()
    jtimeline.deactivate()
    tnt.set_device(None)


def _traced(pkg, desc, **kw):
    mod, tl_mod = PKGS[pkg]
    with tl_mod.tracing() as tl:
        pipe = mod.parse_launch(desc, **kw)
        msg = pipe.run(timeout=120)
    assert msg is not None and msg.kind == "eos"
    return tl, pipe


def _spans_per_frame(tl):
    """{seq: sorted span kinds}, less the timing-dependent ``lane_stall``."""
    out = {}
    for _thread, kind, seq, _t0, t1, _track, _args in tl._snapshot():
        if seq is None or t1 is None or kind == "lane_stall":
            continue
        out.setdefault(seq, []).append(kind)
    return {k: sorted(v) for k, v in out.items()}


# -- the recorder against the JAX one --------------------------------------------
def _synthetic(tl_cls):
    tl = tl_cls()
    tl.epoch = 100.0
    for seq in range(6):
        t = 100.0 + seq
        tl.span("ingest", seq, t, t + 0.010, track="ingest")
        tl.span("queue_wait", seq, t + 0.010, t + 0.030 + 0.002 * seq,
                track="q")
        tl.span("queue_wait", seq, t + 0.031, t + 0.040, track="q")
        tl.span("device", seq, t + 0.040, t + 0.041, track="filter")
        tl.span("sink", seq, t + 0.041, t + 0.050, track="out",
                e2e_s=0.050 + 0.002 * seq)
        tl.mark("fault", seq, t=t + 0.02, track="faults", site="x")
    tl.async_begin("inflight", 0, t=100.02)
    tl.async_end("inflight", 0, t=100.03)
    return tl


def test_reports_equal_the_jax_recorder():
    mine, ref = _synthetic(Timeline), _synthetic(jtimeline.Timeline)
    assert STAGES == jtimeline.STAGES
    assert TRACE_SEQ_META == jtimeline.TRACE_SEQ_META
    for skip in (0, 2):
        assert mine.stage_breakdown(skip) == ref.stage_breakdown(skip)
        assert mine.variance_report(skip) == ref.variance_report(skip)
        assert mine.frame_ledger(skip) == ref.frame_ledger(skip)
    assert mine.frame_stages(3) == ref.frame_stages(3)
    bd = mine.stage_breakdown()
    assert bd["frames"] == 6 and bd["reconciliation"] > 0.95


def test_chrome_export_equals_the_jax_export():
    mine = _synthetic(Timeline).to_chrome()
    ref = _synthetic(jtimeline.Timeline).to_chrome()
    for doc in (mine, ref):
        for ev in doc["traceEvents"]:
            if ev.get("name") == "process_name":
                ev["args"]["name"] = "process"
    assert mine == ref


def test_dead_thread_rings_unregister_but_keep_records():
    import gc

    tl = Timeline(capacity=64)
    for i in range(20):
        t = threading.Thread(target=lambda i=i: tl.span(
            "device", i, float(i), float(i) + 0.5), daemon=True)
        t.start()
        t.join(timeout=10)
    deadline = time.monotonic() + 5.0
    while tl._rings and time.monotonic() < deadline:
        gc.collect()
        time.sleep(0.01)
    assert not tl._rings
    assert {r[2] for r in tl._snapshot() if r[1] == "device"} == \
        set(range(20))


# -- the same pipeline through both packages ---------------------------------------
@pytest.mark.parametrize("lanes", [1, 4])
def test_stages_and_spans_per_frame_equal_jax(lanes):
    ref, _ = _traced("jax", GOLDEN, lanes=lanes)
    mine, _ = _traced("port", GOLDEN, lanes=lanes)
    assert _spans_per_frame(mine) == _spans_per_frame(ref)
    assert len(_spans_per_frame(mine)) == 24
    bd, jbd = mine.stage_breakdown(2), ref.stage_breakdown(2)
    assert set(bd["stages_ms"]) == set(jbd["stages_ms"]) == set(STAGES)
    assert bd["frames"] == jbd["frames"] == 22
    used = {k for k, v in bd["stages_ms"].items() if v > 0}
    jused = {k for k, v in jbd["stages_ms"].items() if v > 0}
    assert used == jused


@pytest.mark.parametrize("lanes", [1, 4])
def test_breakdown_reconciles_with_the_sink(lanes):
    tl, _ = _traced("port", GOLDEN, lanes=lanes)
    bd = tl.stage_breakdown(skip_frames=2)
    assert bd["frames"] >= 10
    gap = abs(bd["e2e_mean_ms"] - bd["covered_ms"])
    assert gap <= max(0.10 * bd["e2e_mean_ms"], 0.5), bd


class _Scores(torch.nn.Module):
    """[N, H, W, C] → [N, 4]: a frame's mean times four weights."""

    def __init__(self):
        super().__init__()
        self.register_buffer("w", torch.arange(1.0, 5.0)[None])

    def forward(self, x):
        return x.float().mean(dim=(1, 2, 3))[:, None] * self.w


@pytest.fixture
def flagship(tmp_path):
    labels = tmp_path / "labels.txt"
    labels.write_text("".join(f"l{i}\n" for i in range(4)))
    register_torch_model("tl_flag", _Scores())
    yield ("videotestsrc num-buffers=48 width=16 height=16 pattern=ball ! "
           "tensor_converter ! queue name=q_ingress max-size-buffers=16 "
           "stamp-admission=true ! "
           "tensor_aggregator frames-in=1 frames-out=8 frames-flush=8 "
           "frames-dim=3 concat=true ! "
           "queue max-size-buffers=8 prefetch-device=true ! "
           "tensor_transform mode=arithmetic "
           "option=typecast:float32,add:-127.5,div:127.5 ! "
           "tensor_filter framework=jax model=tl_flag inflight=2 ! "
           f"tensor_decoder mode=image_labeling option1={labels} "
           "option2=batched ! queue max-size-buffers=64 "
           "materialize-host=true ! tensor_sink name=sink")
    unregister_torch_model("tl_flag")


@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("fuse", [False, True])
def test_flagship_ledger_tiles_each_window(flagship, lanes, fuse):
    """The batch-8 flagship: a window's ledger entry is its first frame's
    life, from create() to the sink, and the stages tile it."""
    with _timeline.tracing() as tl:
        pipe = tnt.parse_launch(flagship, lanes=lanes,
                                pipeline=tpipeline.Pipeline(fuse=fuse))
        assert pipe.run(timeout=120).kind == "eos"
    bd = tl.stage_breakdown(skip_frames=1)
    assert bd["frames"] == 5  # 6 windows, the first skipped
    gap = abs(bd["e2e_mean_ms"] - bd["covered_ms"])
    assert gap <= max(0.10 * bd["e2e_mean_ms"], 0.5), bd
    kinds = {r[1] for r in tl._snapshot()}
    want = {"ingest", "queue_wait", "device", "fence_wait", "decode",
            "sink", "h2d"}
    if lanes > 1:
        want |= {"lane_exec", "lane_reorder"}
    assert want <= kinds, kinds
    # the windows' seqs are their first frames'
    sink_seqs = sorted(r[2] for r in tl._snapshot() if r[1] == "sink")
    assert sink_seqs == [0, 8, 16, 24, 32, 40]


def test_off_records_nothing_and_output_matches_traced(monkeypatch):
    # the always-on flight recorder (obs/flight.py) would otherwise claim
    # the ledger slot and stamp trace seqs, as in the JAX package;
    # NNSTPU_FLIGHT=0 is the kill switch this test pins down
    monkeypatch.setenv("NNSTPU_FLIGHT", "0")
    assert _timeline.ACTIVE is None
    pipe = tnt.parse_launch(GOLDEN)
    pipe.run(timeout=60)
    off = pipe.get("sink").buffers
    assert all(TRACE_SEQ_META not in b.meta for b in off)
    tl, pipe_on = _traced("port", GOLDEN)
    on = pipe_on.get("sink").buffers
    assert tl.stage_breakdown()["frames"] > 0
    assert len(off) == len(on) == 24
    for a, b in zip(off, on):
        assert np.asarray(a.tensors[0]).tobytes() == \
            np.asarray(b.tensors[0]).tobytes()
        assert a.pts == b.pts


def test_chrome_export_is_perfetto_loadable(tmp_path):
    tl, _ = _traced("port", GOLDEN, lanes=2)
    path = tmp_path / "ledger.json"
    tl.export_chrome(str(path))
    doc = json.loads(path.read_text())
    evs = doc["traceEvents"]
    meta = [e for e in evs if e["ph"] == "M"]
    named = {e["tid"] for e in meta if e["name"] == "thread_name"}
    used = {e["tid"] for e in evs if e["ph"] != "M"}
    assert used and used <= named
    slices = [e for e in evs if e["ph"] == "X"]
    assert slices and all(e["dur"] >= 0 and "seq" in e["args"]
                          for e in slices)
    flows = {}
    for e in evs:
        if e.get("cat") == "frame":
            flows.setdefault(e["id"], []).append(e["ph"])
    assert flows and all(p[0] == "s" and p[-1] == "f"
                         for p in flows.values())


@pytest.mark.parametrize("value", [
    "", "0", "false", "off", "1", "true", "/tmp/x.json", "ledger.json",
])
def test_env_switch_as_jax(monkeypatch, value):
    monkeypatch.setenv("NNSTPU_TRACE", value)
    assert _timeline.trace_enabled() == jtimeline.trace_enabled()
    assert _timeline.env_export_path() == jtimeline.env_export_path()


def test_env_trace_exports_at_stop(monkeypatch, tmp_path):
    path = tmp_path / "trace.json"
    monkeypatch.setenv("NNSTPU_TRACE", str(path))
    pipe = tnt.parse_launch(GOLDEN)
    pipe.run(timeout=60)
    assert _timeline.ACTIVE is None  # env-owned: retired at stop()
    doc = json.loads(path.read_text())
    assert any(e["ph"] == "X" and e["name"] == "sink"
               for e in doc["traceEvents"])


def test_profiler_correlation_writes_its_trace(tmp_path):
    with _timeline.tracing() as tl, \
            _timeline.profiler_correlation(str(tmp_path)) as prof:
        pipe = tnt.parse_launch(GOLDEN)
        pipe.run(timeout=60)
        torch.ones(8).sum()
    tl.export_chrome(str(tmp_path / "ledger.json"))
    trace = json.loads((tmp_path / "profiler.json").read_text())
    assert prof.trace_path == str(tmp_path / "profiler.json")
    assert trace["traceEvents"]
    assert (tmp_path / "ledger.json").exists()


# -- admission ------------------------------------------------------------------------
def _admission_run(pkg, n=10):
    """A leaky stamp-admission queue (2 deep) whose worker is parked in a
    gate on frame 0 while frames 1..n-1 arrive: frames 1..n-3 are dropped
    after admission, deterministically."""
    el = jelement if pkg == "jax" else element
    pl = jpipeline if pkg == "jax" else tpipeline
    buf_cls = JaxBuffer if pkg == "jax" else TensorBuffer
    reg = jget_registry() if pkg == "jax" else get_registry()

    class Gate(el.Element):
        ELEMENT_NAME = "_tl_gate"

        def __init__(self, name=None, **props):
            super().__init__(name, **props)
            self.add_sink_pad("sink")
            self.add_src_pad("src")
            self.entered = threading.Event()
            self.release = threading.Event()

        def chain(self, pad, buf):
            self.entered.set()
            assert self.release.wait(timeout=10)
            return self.srcpads[0].push(buf)

    class Collect(el.Element):
        ELEMENT_NAME = "_tl_collect"

        def __init__(self, name=None, **props):
            super().__init__(name, **props)
            self.add_sink_pad("sink")
            self.got = []

        def chain(self, pad, buf):
            self.got.append(float(np.asarray(buf.tensors[0])[0]))
            return el.FlowReturn.OK

    name = f"tl-admit-{pkg}-{time.monotonic_ns()}"
    pipe = pl.Pipeline(name=name, fuse=False)
    q = pl.Queue(name="q", stamp_admission=True, max_size_buffers=2,
                 leaky="downstream")
    gate, col = Gate(name="gate"), Collect(name="col")
    pipe.add_linked(q, gate, col)
    pipe.start()
    try:
        q._chain_entry(q.sinkpads[0], buf_cls([np.array([0.0], np.float32)]))
        assert gate.entered.wait(timeout=5)
        for i in range(1, n):
            q._chain_entry(q.sinkpads[0],
                           buf_cls([np.array([float(i)], np.float32)]))
        gate.release.set()
        q.sink_event(q.sinkpads[0], el.EosEvent())
    finally:
        pipe.stop()

    def c(metric):
        m = reg.get(metric, pipeline=name, element="q")
        return int(m.value) if m is not None else 0

    return (c("nns_queue_admitted_total"),
            c("nns_queue_admitted_revoked_total"),
            c("nns_queue_drops_total"), col.got)


def test_admission_counters_equal_jax():
    ref = _admission_run("jax")
    got = _admission_run("port")
    assert got == ref
    admitted, revoked, drops, delivered = got
    assert admitted == 10 and revoked == drops == 7
    assert delivered == [0.0, 8.0, 9.0]


def test_sink_latency_by_base(flagship):
    # a pipeline name of its own: the queue's counters are labelled by it
    pipe = tnt.parse_launch(flagship, pipeline=tpipeline.Pipeline(
        name=f"tl-base-{time.monotonic_ns()}"))
    assert pipe.run(timeout=120).kind == "eos"
    sink = pipe.get("sink")
    assert len(sink.latencies) == len(sink.admitted_latencies) == 48
    c50, c99 = sink.latency_percentiles(50.0, 99.0)
    a50, a99 = sink.latency_percentiles(50.0, 99.0, base="admitted")
    # admission comes after create(): the served latency is shorter
    assert 0 < a50 <= c50 and 0 < a99 <= c99
    assert sink.latency_percentiles(skip=48, base="admitted") is None
    with pytest.raises(ValueError, match="latency base"):
        sink.latency_percentiles(base="queue")
    snap = pipe.metrics_snapshot()["elements"]["q_ingress"]
    assert snap["admitted"] == 48 and snap["admitted_revoked"] == 0



def _named_flagship(desc):
    """The flagship string with every element after the converter named,
    so a hand-off can be picked by its sender."""
    return (desc.replace("videotestsrc ", "videotestsrc name=src ")
            .replace("tensor_aggregator ", "tensor_aggregator name=agg ")
            .replace("queue max-size-buffers=8 ",
                     "queue name=q_stage max-size-buffers=8 ")
            .replace("tensor_transform ", "tensor_transform name=tf ")
            .replace("tensor_filter ", "tensor_filter name=flt ")
            .replace("tensor_decoder ", "tensor_decoder name=dec ")
            .replace("queue max-size-buffers=64 ",
                     "queue name=q_drain max-size-buffers=64 "))


_DELAY_S = 0.03
_DELAYED_SEQ = 16  # the third window's first frame


@pytest.mark.parametrize("fuse,sender", [
    (True, "src"), (True, "src-lanes"),
    (True, "q_ingress"), (True, "agg"), (True, "q_stage"),
    (True, "tf+flt+dec"), (True, "q_drain"),
    (False, "q_stage"), (False, "tf"), (False, "flt"), (False, "dec"),
    (False, "q_drain"),
])
def test_a_delayed_handoff_stays_inside_the_frames_stages(
        flagship, monkeypatch, fuse, sender):
    """Every hand-off of the lanes-4 flagship, delayed in turn by a fixed
    sleep on the sender's thread (as a busy host delays a thread waiting
    for the GIL): the delayed frame's stages still cover its e2e within
    max(10 %, 0.5 ms), because each span that ends at a hand-off shares
    its reading with the receiver's next span."""
    orig_push, orig_list = element.Pad.push, element.Pad.push_list
    fired = []

    def delay(pad, bufs):
        if pad.element.name == sender and any(
                b.meta.get(TRACE_SEQ_META) == _DELAYED_SEQ for b in bufs):
            fired.append(pad.element.name)
            time.sleep(_DELAY_S)

    def push(self, buf):
        delay(self, [buf])
        return orig_push(self, buf)

    def push_list(self, bufs):
        delay(self, bufs)
        return orig_list(self, bufs)

    monkeypatch.setattr(element.Pad, "push", push)
    monkeypatch.setattr(element.Pad, "push_list", push_list)
    with _timeline.tracing() as tl:
        pipe = tnt.parse_launch(_named_flagship(flagship), lanes=4,
                                pipeline=tpipeline.Pipeline(fuse=fuse))
        assert pipe.run(timeout=120).kind == "eos"
    assert fired == [sender]
    frame = tl.frame_ledger()[_DELAYED_SEQ]
    e2e = frame["e2e"]
    covered = sum(frame.get(k, 0.0) for k in STAGES)
    assert e2e >= _DELAY_S
    assert abs(e2e - covered) <= max(0.10 * e2e, 0.5e-3), (sender, frame)
