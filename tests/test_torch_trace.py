"""The PyTorch port's ``utils/trace.py`` (chrome-trace export, the CUDA
profiler wrapper) and ``utils/stats.py`` (InvokeStats edge cases), held
to the JAX package's ``tests/test_trace.py``: the same traced run gives
both packages' tracers the same events per element (counts, names, pts;
times differ), and :func:`cuda_profile` replaces ``xla_profile``."""

import json

import numpy as np

import torch

from nnstreamer_tpu.pipeline import element as jelement
from nnstreamer_tpu.pipeline import pipeline as jpipeline
from nnstreamer_tpu.tensors import buffer as jbuffer
from nnstreamer_tpu.tensors import types as jtypes
from nnstreamer_tpu.utils import trace as jtrace
from nnstreamer_tpu_torch.pipeline.element import Element, FlowReturn
from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline, SourceElement
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer
from nnstreamer_tpu_torch.utils.stats import InvokeStats
from nnstreamer_tpu_torch.utils.trace import TRACE_FILE, Tracer, cuda_profile


class _NumSrc(SourceElement):
    ELEMENT_NAME = "_ttrcnumsrc"
    PROPERTIES = {**SourceElement.PROPERTIES, "num_buffers": 5}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.i = 0

    def negotiate(self):
        from nnstreamer_tpu_torch.tensors.types import TensorsConfig

        cfg = TensorsConfig.from_arrays([np.zeros((1,), np.float32)])
        self.srcpad.set_caps(cfg.to_caps())

    def create(self):
        if self.i >= self.get_property("num_buffers"):
            return None
        buf = TensorBuffer([np.array([float(self.i)], np.float32)],
                           pts=self.i * 1000)
        self.i += 1
        return buf


class _CountSink(Element):
    ELEMENT_NAME = "_ttrccountsink"

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.count = 0

    def chain(self, pad, buf):
        self.count += 1
        return FlowReturn.OK


class TestTracerChromeExport:
    def _run_traced(self, n=6):
        from nnstreamer_tpu_torch.pipeline.pipeline import Queue

        # a queue between source and sink gives every frame ≥2 traced
        # hops, so the export's flow-event chains have something to link
        src = _NumSrc(name="tsrc", num_buffers=n)
        sink = _CountSink(name="tsink")
        pipe = Pipeline(name=f"trace-{n}", fuse=False).add_linked(
            src, Queue(name="tq"), sink)
        tracer = Tracer()
        with tracer.attach(pipe):
            assert pipe.run(timeout=10) is not None
        return tracer, sink

    def test_export_is_valid_chrome_trace(self, tmp_path):
        tracer, sink = self._run_traced(n=6)
        path = tmp_path / "trace.json"
        tracer.export_chrome(str(path))
        with open(path) as f:
            doc = json.load(f)  # must parse — the Perfetto load contract
        events = doc["traceEvents"]
        assert events, "traced run produced no events"
        slices = [ev for ev in events if ev["ph"] == "X"]
        assert slices, "no complete events"
        for ev in slices:
            # one COMPLETE event per invoke: phase X with ts + dur
            assert ev["cat"] == "element"
            assert ev["ts"] >= 0 and ev["dur"] >= 0
            assert isinstance(ev["pid"], int)
            assert isinstance(ev["tid"], int)
            # pts + interlatency ride along as args (followable frames)
            assert "pts" in ev["args"]
        # flow events follow a frame across element tracks: each pts seen
        # by >1 element starts with `s` and finishes with `f` (bp="e")
        flow = [ev for ev in events if ev["ph"] in ("s", "t", "f")]
        assert flow, "no flow events in a multi-element trace"
        by_id = {}
        for ev in flow:
            by_id.setdefault(ev["id"], []).append(ev["ph"])
        for phases in by_id.values():
            assert phases[0] == "s" and phases[-1] == "f"
        assert all(ev.get("bp") == "e"
                   for ev in flow if ev["ph"] == "f")

    def test_one_complete_event_per_element_invoke(self, tmp_path):
        tracer, sink = self._run_traced(n=7)
        path = tmp_path / "trace.json"
        tracer.export_chrome(str(path))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        slices = [ev for ev in events if ev["ph"] == "X"]
        per_el = {}
        for ev in slices:
            per_el[ev["name"]] = per_el.get(ev["name"], 0) + 1
        assert per_el["tsink"] == sink.count == 7
        # distinct elements get distinct tids (one lane per element)
        tids = {ev["name"]: ev["tid"] for ev in slices}
        assert len(set(tids.values())) == len(tids)

    def test_detach_restores_chain_entry(self):
        src = _NumSrc(name="dsrc", num_buffers=2)
        sink = _CountSink(name="dsink")
        pipe = Pipeline(name="trace-detach",
                        fuse=False).add_linked(src, sink)
        tracer = Tracer()
        with tracer.attach(pipe):
            pass
        # the wrapper must not shadow the class method after detach
        assert "_chain_entry" not in sink.__dict__
        assert pipe.run(timeout=10) is not None
        assert len(tracer.events) == 0  # nothing recorded outside attach


class TestInvokeStatsEdgeCases:
    def test_empty_window_reads_zero(self):
        s = InvokeStats()
        assert s.latency_us == 0
        assert s.throughput_milli == 0
        snap = s.snapshot()
        assert snap["latency_us"] == 0
        assert snap["total_invokes"] == 0

    def test_single_sample_throughput_zero(self):
        s = InvokeStats()
        s.record(0.001, now=100.0)
        assert s.latency_us == 1000
        assert s.throughput_milli == 0  # a rate needs two stamps

    def test_stale_samples_pruned_from_throughput(self):
        s = InvokeStats(max_age_s=10.0)
        s.record(0.001, now=100.0)
        s.record(0.001, now=150.0)  # 50 s later: the first stamp is stale
        assert s.throughput_milli == 0  # only one live stamp remains
        s.record(0.001, now=150.5)
        s.record(0.001, now=151.0)
        # 3 live stamps over 1 s → 2 intervals/s → 2000 milli-out/s
        assert s.throughput_milli == 2000
        assert s.total_invokes == 4  # cumulative count never prunes

    def test_latency_window_bounded(self):
        s = InvokeStats(window=3)
        for lat in (1.0, 1.0, 0.001, 0.001, 0.001):
            s.record(lat, now=100.0)
        # only the last `window` samples feed the average
        assert s.latency_us == 1000
        assert s.total_invokes == 5
        assert abs(s.total_latency_s - 2.003) < 1e-9

    def test_measure_context_manager(self):
        s = InvokeStats()
        with s.measure():
            pass
        assert s.total_invokes == 1
        assert s.latency_us >= 0


# -- held to the JAX tracer --------------------------------------------------------
def _jax_traced(n):
    class JSrc(jpipeline.SourceElement):
        ELEMENT_NAME = "_ttrcjsrc"

        def __init__(self, name=None, **props):
            super().__init__(name, **props)
            self.i = 0

        def negotiate(self):
            cfg = jtypes.TensorsConfig.from_arrays(
                [np.zeros((1,), np.float32)])
            self.srcpad.set_caps(cfg.to_caps())

        def create(self):
            if self.i >= n:
                return None
            buf = jbuffer.TensorBuffer(
                [np.array([float(self.i)], np.float32)], pts=self.i * 1000)
            self.i += 1
            return buf

    class JSink(jelement.Element):
        ELEMENT_NAME = "_ttrcjsink"

        def __init__(self, name=None, **props):
            super().__init__(name, **props)
            self.add_sink_pad("sink")

        def chain(self, pad, buf):
            return jelement.FlowReturn.OK

    pipe = jpipeline.Pipeline(name=f"jtrace-{n}", fuse=False).add_linked(
        JSrc(name="tsrc"), jpipeline.Queue(name="tq"), JSink(name="tsink"))
    tracer = jtrace.Tracer()
    with tracer.attach(pipe):
        assert pipe.run(timeout=10) is not None
    return tracer


def _shape(tracer):
    return sorted((ev["element"], ev["pts"]) for ev in tracer.events)


def test_events_match_the_jax_tracer():
    tracer, _ = TestTracerChromeExport()._run_traced(n=5)
    assert _shape(tracer) == _shape(_jax_traced(5))
    assert set(tracer.summary()) == set(_jax_traced(5).summary())


def test_cuda_profile_writes_a_chrome_trace(tmp_path):
    with cuda_profile(str(tmp_path)) as prof:
        torch.ones(64).mul_(2).sum()
    doc = json.loads((tmp_path / TRACE_FILE).read_text())
    names = {ev.get("name") for ev in doc["traceEvents"]}
    assert any(n and "mul" in n for n in names)
    assert prof.key_averages() is not None
