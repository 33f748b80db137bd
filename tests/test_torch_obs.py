"""The port's ``obs`` subsystem held to the JAX package's: the 28 cases of
``tests/test_obs.py`` (registry primitives, the Prometheus/JSON exporters,
queue-drop accounting, queue/rate/mux/sink metrics and the agreement of the
exported per-element gauges with the element properties) on the port,
with the rendered text compared to the JAX package's where both can make
it. Then the two repairs: the per-element gauges a pipeline registers at
construction (``obs/collectors.register_pipeline_collector``, ROADMAP C.33)
scraped over HTTP on 127.0.0.1, and the sink's admitted-latency reservoir
(C.32) against the JAX sink's past its cap.

Pipelines use unique names: a metric's identity is (name, labels) across
the process.
"""

import json
import logging
import threading
import urllib.request

import numpy as np
import pytest

from nnstreamer_tpu import obs as jobs
from nnstreamer_tpu_torch.obs import (
    LATENCY_BUCKETS_S,
    MetricsRegistry,
    MetricsServer,
    get_registry,
)
from nnstreamer_tpu_torch.pipeline.element import Element, EosEvent, FlowReturn
from nnstreamer_tpu_torch.pipeline.pipeline import (
    Pipeline,
    Queue,
    SourceElement,
)
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer


class TestCounter:
    def test_inc_and_value(self):
        reg = MetricsRegistry()
        c = reg.counter("t_total", "help", a="1")
        c.inc()
        c.inc(2.5)
        assert c.value == 3.5

    def test_negative_inc_rejected(self):
        c = MetricsRegistry().counter("t_total")
        with pytest.raises(ValueError, match="only go up"):
            c.inc(-1)

    def test_set_total_monotonic(self):
        c = MetricsRegistry().counter("t_total")
        c.set_total(10)
        c.set_total(4)  # a stale external read must not regress it
        assert c.value == 10


class TestGauge:
    def test_set_inc_dec(self):
        g = MetricsRegistry().gauge("t_g")
        g.set(5)
        g.inc(2)
        g.dec()
        assert g.value == 6

    def test_callback_gauge(self):
        g = MetricsRegistry().gauge("t_g", fn=lambda: 42.0)
        assert g.value == 42.0

    def test_broken_callback_reads_zero(self):
        g = MetricsRegistry().gauge("t_g", fn=lambda: 1 / 0)
        assert g.value == 0.0


class TestHistogram:
    def test_cumulative_buckets(self):
        h = MetricsRegistry().histogram("t_h", buckets=(1.0, 2.0, 4.0))
        jh = jobs.MetricsRegistry().histogram("t_h", buckets=(1.0, 2.0, 4.0))
        for v in (0.5, 1.5, 1.5, 3.0, 100.0):
            h.observe(v)
            jh.observe(v)
        assert h.bucket_counts() == [
            (1.0, 1), (2.0, 3), (4.0, 4), (float("inf"), 5)]
        assert h.bucket_counts() == jh.bucket_counts()
        assert h.count == 5
        assert h.sum == pytest.approx(106.5)

    def test_boundary_value_lands_in_its_bucket(self):
        h = MetricsRegistry().histogram("t_h", buckets=(1.0, 2.0))
        h.observe(1.0)
        assert h.bucket_counts()[0] == (1.0, 1)

    def test_percentile_interpolates(self):
        h = MetricsRegistry().histogram("t_h", buckets=(1.0, 2.0, 4.0))
        for _ in range(100):
            h.observe(1.5)
        assert h.percentile(50) == pytest.approx(1.5)
        assert h.percentile(100) == pytest.approx(2.0)

    def test_percentile_empty_is_none(self):
        assert MetricsRegistry().histogram("t_h").percentile(99) is None

    def test_percentile_inf_tail_is_last_bound(self):
        h = MetricsRegistry().histogram("t_h", buckets=(1.0, 2.0))
        h.observe(50.0)
        assert h.percentile(99) == 2.0

    def test_default_buckets_span_latency_range(self):
        assert LATENCY_BUCKETS_S[0] == pytest.approx(100e-6)
        assert LATENCY_BUCKETS_S[-1] == 10.0
        assert tuple(LATENCY_BUCKETS_S) == tuple(jobs.LATENCY_BUCKETS_S)


class TestRegistry:
    def test_get_or_create_identity(self):
        reg = MetricsRegistry()
        a = reg.counter("t_total", pipeline="p", element="e")
        b = reg.counter("t_total", element="e", pipeline="p")
        assert a is b
        assert reg.counter("t_total", pipeline="p", element="x") is not a

    def test_kind_conflict_raises(self):
        reg = MetricsRegistry()
        reg.counter("t_metric", a="1")
        with pytest.raises(ValueError, match="already"):
            reg.gauge("t_metric", a="1")
        with pytest.raises(ValueError, match="already used"):
            reg.gauge("t_metric", a="2")

    def test_get_returns_none_when_absent(self):
        assert MetricsRegistry().get("nope", a="1") is None

    def test_collector_false_unregisters(self):
        reg = MetricsRegistry()
        calls = []
        reg.register_collector(lambda: calls.append(1) or False)
        reg.collect()
        reg.collect()
        assert len(calls) == 1

    def test_collector_exception_unregisters(self):
        reg = MetricsRegistry()
        reg.register_collector(lambda: 1 / 0)
        reg.collect()  # must not raise
        assert reg._collectors == []

    def test_render_prometheus_format(self):
        texts = []
        for reg in (MetricsRegistry(), jobs.MetricsRegistry()):
            reg.counter("t_req_total", "requests", wire="nnstpu").inc(3)
            reg.histogram("t_lat_seconds", "latency",
                          buckets=(0.1, 1.0), pipeline="p").observe(0.05)
            texts.append(reg.render_prometheus())
        text = texts[0]
        assert "# HELP t_req_total requests" in text
        assert "# TYPE t_req_total counter" in text
        assert 't_req_total{wire="nnstpu"} 3' in text
        assert "# TYPE t_lat_seconds histogram" in text
        assert 't_lat_seconds_bucket{le="0.1",pipeline="p"} 1' in text
        assert 't_lat_seconds_bucket{le="+Inf",pipeline="p"} 1' in text
        assert 't_lat_seconds_sum{pipeline="p"} 0.05' in text
        assert 't_lat_seconds_count{pipeline="p"} 1' in text
        assert text.endswith("\n")
        assert texts[0] == texts[1]  # the JAX package's text, byte for byte

    def test_render_escapes_label_values(self):
        reg = MetricsRegistry()
        reg.counter("t_total", x='a"b\\c\nd').inc()
        line = [ln for ln in reg.render_prometheus().splitlines()
                if ln.startswith("t_total{")][0]
        assert line == 't_total{x="a\\"b\\\\c\\nd"} 1'

    def test_snapshot_is_json_able(self):
        snaps = []
        for reg in (MetricsRegistry(), jobs.MetricsRegistry()):
            reg.gauge("t_g", a="1").set(2)
            reg.histogram("t_h", buckets=(1.0,)).observe(0.5)
            snaps.append(json.loads(json.dumps(reg.snapshot())))
        by_name = {m["name"]: m for m in snaps[0]["metrics"]}
        assert by_name["t_g"]["value"] == 2
        assert by_name["t_h"]["count"] == 1
        assert by_name["t_h"]["p50"] == pytest.approx(0.5)
        assert by_name["t_h"]["buckets"][-1][0] == "+Inf"
        assert snaps[0]["metrics"] == snaps[1]["metrics"]


class TestMetricsServer:
    def test_http_exporter_end_to_end(self):
        reg = MetricsRegistry()
        reg.counter("t_req_total", "reqs", wire="x").inc(7)
        reg.histogram("t_lat_seconds", pipeline="p").observe(0.002)
        with MetricsServer(registry=reg, host="127.0.0.1", port=0) as srv:
            base = f"http://127.0.0.1:{srv.port}"
            with urllib.request.urlopen(f"{base}/metrics") as resp:
                assert resp.headers["Content-Type"].startswith(
                    "text/plain; version=0.0.4")
                text = resp.read().decode()
            assert 't_req_total{wire="x"} 7' in text
            with urllib.request.urlopen(f"{base}/metrics.json") as resp:
                assert resp.headers["Content-Type"] == "application/json"
                snap = json.loads(resp.read())
            assert any(m["name"] == "t_lat_seconds"
                       for m in snap["metrics"])
            with urllib.request.urlopen(f"{base}/healthz") as resp:
                assert resp.read() == b"ok\n"
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(f"{base}/nope")

    def test_server_refreshes_collectors_per_scrape(self):
        reg = MetricsRegistry()
        state = {"v": 1.0}
        g = reg.gauge("t_g")

        def collect():
            g.set(state["v"])

        reg.register_collector(collect)
        with MetricsServer(registry=reg, host="127.0.0.1", port=0) as srv:
            base = f"http://127.0.0.1:{srv.port}"
            assert "t_g 1" in urllib.request.urlopen(
                f"{base}/metrics").read().decode()
            state["v"] = 2.0
            assert "t_g 2" in urllib.request.urlopen(
                f"{base}/metrics").read().decode()


# -- pipeline-level instrumentation ------------------------------------------
class _NumSrc(SourceElement):
    ELEMENT_NAME = "_obsnumsrc"
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


class _BlockingSink(Element):
    """Blocks its first chain() until released: pins the queue worker so
    queued buffers pile up deterministically."""

    ELEMENT_NAME = "_obsblocksink"

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.entered = threading.Event()
        self.release = threading.Event()
        self.count = 0

    def chain(self, pad, buf):
        self.entered.set()
        self.release.wait(timeout=10)
        self.count += 1
        return FlowReturn.OK


def _mk(i):
    return TensorBuffer([np.array([float(i)], np.float32)], pts=i)


class TestQueueDrops:
    def test_leaky_downstream_drops_counted(self):
        pipe = Pipeline(name="tobs-qdrop", fuse=False)
        q = Queue(name="q", max_size_buffers=2, leaky="downstream")
        sink = _BlockingSink(name="bs")
        pipe.add_linked(q, sink)
        records = []
        handler = logging.Handler()
        handler.emit = records.append
        logging.getLogger("nnstreamer_tpu_torch").addHandler(handler)
        q.start()
        try:
            q.chain(q.sinkpads[0], _mk(0))
            # the worker holds buf 0 inside the blocked sink: the queue
            # itself is empty with capacity 2
            assert sink.entered.wait(5)
            q.chain(q.sinkpads[0], _mk(1))
            q.chain(q.sinkpads[0], _mk(2))  # full
            for i in range(3, 6):           # each push drops the oldest
                q.chain(q.sinkpads[0], _mk(i))
            drops = get_registry().get("nns_queue_drops_total",
                                       pipeline="tobs-qdrop", element="q")
            assert drops is not None and drops.value == 3
            snap = q.obs_snapshot()
            assert snap["drops"] == 3
            assert snap["depth"] == 2
            warns = [r for r in records
                     if r.levelno == logging.WARNING
                     and "leaky=downstream" in r.getMessage()]
            assert len(warns) == 1
        finally:
            sink.release.set()
            q.sink_event(q.sinkpads[0], EosEvent())
            q.stop()
            logging.getLogger("nnstreamer_tpu_torch").removeHandler(handler)

    def test_depth_gauge_samples_live_queue(self):
        pipe = Pipeline(name="tobs-qdepth", fuse=False)
        q = Queue(name="q", max_size_buffers=8)
        sink = _BlockingSink(name="bs")
        pipe.add_linked(q, sink)
        q.start()
        try:
            for i in range(4):
                q.chain(q.sinkpads[0], _mk(i))
            assert sink.entered.wait(5)
            depth = get_registry().get("nns_queue_depth",
                                       pipeline="tobs-qdepth", element="q")
            assert depth is not None and depth.value == 3  # 1 in flight
        finally:
            sink.release.set()
            q.sink_event(q.sinkpads[0], EosEvent())
            q.stop()


class _CountSink(Element):
    ELEMENT_NAME = "_obscountsink"

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.count = 0

    def chain(self, pad, buf):
        self.count += 1
        return FlowReturn.OK


class TestPipelineMetrics:
    def test_metrics_snapshot_and_property_agreement(self):
        src = _NumSrc(name="nsrc", num_buffers=6)
        sink = _CountSink(name="csink")
        pipe = Pipeline(name="tobs-agree", fuse=False).add_linked(src, sink)
        assert pipe.run(timeout=10) is not None
        snap = pipe.metrics_snapshot()
        assert snap["pipeline"] == "tobs-agree"
        s = snap["elements"]["csink"]
        assert s["invokes"] == 6
        assert s["latency_us"] == sink.get_property("latency")
        # the gauge is sampled from the InvokeStats the property reads
        text = get_registry().render_prometheus()
        want = (f'nns_element_latency_us{{element="csink",'
                f'pipeline="tobs-agree",type="_obscountsink"}} '
                f'{sink.get_property("latency")}')
        assert want in text
        assert ('nns_element_invokes_total{element="csink",'
                'pipeline="tobs-agree",type="_obscountsink"} 6') in text

    def test_tensor_rate_drops_exported(self):
        from nnstreamer_tpu_torch.elements.rate import TensorRate
        from nnstreamer_tpu_torch.elements.sink import TensorSink

        src = _NumSrc(name="rsrc", num_buffers=10)
        rate = TensorRate(name="rate", framerate="30/1", throttle=False)
        sink = TensorSink(name="rsink")
        pipe = Pipeline(name="tobs-rate", fuse=False)
        pipe.add_linked(src, rate, sink)
        assert pipe.run(timeout=10) is not None
        # pts steps 1 µs against a 1/30 s output period: the first frame
        # is emitted, the other nine drop
        assert rate.dropped == 9
        c = get_registry().get("nns_tensor_rate_dropped_total",
                               pipeline="tobs-rate", element="rate")
        assert c is not None and c.value == rate.dropped
        assert pipe.metrics_snapshot()["elements"]["rate"]["drops"] == 9

    def test_sink_e2e_histogram_populated(self):
        from nnstreamer_tpu_torch.elements.sink import TensorSink

        src = _NumSrc(name="esrc", num_buffers=5)
        sink = TensorSink(name="esink")
        pipe = Pipeline(name="tobs-e2e", fuse=False).add_linked(src, sink)
        assert pipe.run(timeout=10) is not None
        h = get_registry().get("nns_sink_e2e_seconds",
                               pipeline="tobs-e2e", element="esink")
        assert h is not None and h.count == len(sink.latencies) > 0
        snap = pipe.metrics_snapshot()["elements"]["esink"]
        assert "e2e_p50_ms" in snap and "e2e_p99_ms" in snap

    def test_mux_sync_wait_histogram(self):
        from nnstreamer_tpu_torch.elements.mux import TensorMux
        from nnstreamer_tpu_torch.elements.sink import TensorSink

        src_a = _NumSrc(name="ma", num_buffers=4)
        src_b = _NumSrc(name="mb", num_buffers=4)
        mux = TensorMux(name="mux", sync_mode="nosync")
        sink = TensorSink(name="msink")
        pipe = Pipeline(name="tobs-mux", fuse=False)
        pipe.add(src_a, src_b, mux, sink)
        src_a.srcpad.link(mux.request_sink_pad())
        src_b.srcpad.link(mux.request_sink_pad())
        mux.srcpad.link(sink.sinkpads[0])
        assert pipe.run(timeout=10) is not None
        h = get_registry().get("nns_tensor_mux_sync_wait_seconds",
                               pipeline="tobs-mux", element="mux")
        assert h is not None and h.count == 4


# -- C.33: the per-element gauges of a pipeline, scraped ----------------------
_GAUGES = ("nns_element_latency_us", "nns_element_throughput_milli",
           "nns_element_invokes_total")
# every element named: generated names count per process and package
_STRING = ("videotestsrc name=src num-buffers=6 width=8 height=8 ! "
           "tensor_converter name=conv ! tensor_transform name=tf "
           "mode=typecast option=float32 ! queue name=q ! "
           "tensor_sink name=out")


def _element_series(text, pipeline):
    """{(metric, element, type): value} of the per-element series of
    ``pipeline`` in a Prometheus text."""
    out = {}
    for line in text.splitlines():
        if not line.startswith(_GAUGES) or \
                f'pipeline="{pipeline}"' not in line:
            continue
        name, rest = line.split("{", 1)
        labels, value = rest.rsplit("} ", 1)
        fields = dict(kv.split("=", 1) for kv in labels.split(","))
        assert set(fields) == {"element", "pipeline", "type"}, line
        out[(name, fields["element"].strip('"'),
             fields["type"].strip('"'))] = float(value)
    return out


def test_pipeline_gauges_scraped_over_http_as_jax_names_them():
    import nnstreamer_tpu as jnt
    import nnstreamer_tpu_torch as tnt

    tnt.set_device("cpu")
    try:
        port = tnt.parse_launch(_STRING, pipeline=Pipeline(name="tobs-c33"))
        assert port.run(timeout=60).kind == "eos"
        with MetricsServer(host="127.0.0.1", port=0) as srv:
            text = urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics").read().decode()
    finally:
        tnt.set_device(None)
    from nnstreamer_tpu.pipeline.pipeline import Pipeline as JPipeline

    jax_pipe = jnt.parse_launch(_STRING, pipeline=JPipeline(name="tobs-c33"))
    assert jax_pipe.run(timeout=60).kind == "eos"
    jtext = jobs.get_registry().render_prometheus()
    got = _element_series(text, "tobs-c33")
    want = _element_series(jtext, "tobs-c33")
    # every element of the pipeline, each with the three series
    for el in port.elements:
        for metric in _GAUGES:
            assert (metric, el.name, el.ELEMENT_NAME) in got, (metric, el)
    # the JAX package's names and labels, series for series
    assert set(got) == set(want)
    invokes = {k[1]: v for k, v in got.items()
               if k[0] == "nns_element_invokes_total"}
    assert invokes["out"] == 6
    assert invokes == {k[1]: v for k, v in want.items()
                       if k[0] == "nns_element_invokes_total"}


def test_a_collected_pipeline_unregisters_its_gauges():
    import gc

    reg = MetricsRegistry()
    from nnstreamer_tpu_torch.obs.collectors import (
        register_pipeline_collector,
    )

    pipe = Pipeline(name="tobs-gone")
    register_pipeline_collector(pipe, registry=reg)
    assert len(reg._collectors) == 1
    reg.collect()
    del pipe
    gc.collect()
    reg.collect()
    assert reg._collectors == []


# -- C.32: the sink's admitted-latency reservoir ------------------------------
def test_admitted_reservoir_matches_jax_past_its_cap():
    """70,000 samples offered to both packages' sinks: the same offered
    count, the same retained population (Vitter's algorithm R with the
    same seed draws the same replacements), the same p50 and p99."""
    from nnstreamer_tpu.elements.sink import TensorSink as JSink
    from nnstreamer_tpu_torch.elements.sink import TensorSink

    rng = np.random.default_rng(32)
    samples = rng.gamma(2.0, 0.004, 70_000).tolist()
    port, jax_sink = TensorSink(name="s"), JSink(name="s")
    for v in samples:
        port.admitted_latencies.append(v)
        jax_sink.admitted_latencies.append(v)
    assert int(port.admitted_latencies.count) == 70_000
    assert port.admitted_latencies.count == jax_sink.admitted_latencies.count
    assert len(port.admitted_latencies) == 65_536
    assert len(port.admitted_latencies) == len(jax_sink.admitted_latencies)
    assert list(port.admitted_latencies) == list(jax_sink.admitted_latencies)
    got = port.latency_percentiles(50.0, 99.0, base="admitted")
    want = jax_sink.latency_percentiles(50.0, 99.0, base="admitted")
    assert got == want
    # a sliding window would hold only the last 65,536: the reservoir
    # keeps samples from the start of the run
    assert set(samples[:4464]) & set(port.admitted_latencies)
    port.admitted_latencies.clear()
    assert port.admitted_latencies.count == 0
    assert len(port.admitted_latencies) == 0
