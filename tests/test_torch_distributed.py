"""The distributed observability plane in the PyTorch port
(``obs/distributed.py``): the EX2 framing and span blobs, dt1 HELLO
negotiation and its kill switch, the skew-anchored splice, the reliable
loopback's remote stages, and fleet metrics federation — each held to the
JAX package (``nnstreamer_tpu/obs/distributed.py``) on the same inputs.

Every server is on 127.0.0.1 with ``port=0`` and every wait is bounded.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.obs import distributed as jdist
from nnstreamer_tpu.obs import timeline as JTL
from nnstreamer_tpu.obs.flight import FlightRecorder as JaxFlightRecorder
from nnstreamer_tpu.query import pubsub as jpubsub
from nnstreamer_tpu_torch.elements.query import (
    TensorQueryClient,
    TensorQueryServerSrc,
)
from nnstreamer_tpu_torch.obs import distributed as dist
from nnstreamer_tpu_torch.obs import timeline as TL
from nnstreamer_tpu_torch.obs.flight import FlightRecorder
from nnstreamer_tpu_torch.obs.quantiles import P2Quantile
from nnstreamer_tpu_torch.obs.registry import MetricsRegistry
from nnstreamer_tpu_torch.obs.server import MetricsServer
from nnstreamer_tpu_torch.query import protocol as P
from nnstreamer_tpu_torch.query.discovery import (
    ServerAdvertiser,
    ServerDiscovery,
)
from nnstreamer_tpu_torch.query.pubsub import Broker
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

JOIN_S = 10.0


@pytest.fixture(autouse=True)
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


# -- framing and negotiation ------------------------------------------------------
SPAN_CASES = [
    ({"device": 0.004, "queue_wait": 0.001, "d2h": 0.0}, 0.0061, "h:1"),
    ({}, 0.0, "edge-b:3000"),
    ({"ingest": 1e-9, "fence_wait": 0.25}, 0.5, "x"),
]


@pytest.mark.parametrize("stages,total,endpoint", SPAN_CASES)
def test_span_blobs_equal_jax(stages, total, endpoint):
    args = (stages, total, 1700000000.125, 1700000000.5, endpoint)
    blob = dist.pack_span_blob(*args)
    assert blob == jdist.pack_span_blob(*args)
    assert dist.unpack_span_blob(blob) == jdist.unpack_span_blob(blob)


@pytest.mark.parametrize("blob", [b"", b"not json", b"[1, 2]", b"\xff\xfe"])
def test_garbage_span_blobs_are_empty(blob):
    assert dist.unpack_span_blob(blob) == jdist.unpack_span_blob(blob) == {}


@pytest.mark.parametrize("value", [None, "", "0", "false", "No", "OFF",
                                   "1", "yes"])
def test_negotiation_equals_jax(value, monkeypatch):
    if value is None:
        monkeypatch.delenv("NNSTPU_DIST_TRACE", raising=False)
    else:
        monkeypatch.setenv("NNSTPU_DIST_TRACE", value)
    assert dist.enabled() == jdist.enabled()
    assert dist.hello_offer() == jdist.hello_offer()


@pytest.mark.parametrize("text", ["abc:64:dt1", "abc:64", "ok:dt1", "ok",
                                  "i:8:dt1:zz", "::"])
def test_feature_parsing_equals_jax(text):
    assert dist.parse_features(text) == jdist.parse_features(text)
    assert dist.hello_accepts(text.encode()) == \
        jdist.hello_accepts(text.encode())


def test_trace_meta_equals_jax(monkeypatch):
    monkeypatch.setattr(dist, "wall_now", lambda: 1700000000.75)
    monkeypatch.setattr(jdist, "wall_now", lambda: 1700000000.75)
    for meta in ({"trace_seq": 12}, {}):
        assert dist.attach_trace_meta(dict(meta)) == \
            jdist.attach_trace_meta(dict(meta))
    meta = {"dist_trace_id": "9", "dist_sent_wall": "3.5"}
    assert dist.extract_trace_meta(meta) == jdist.extract_trace_meta(meta)
    assert dist.extract_trace_meta({}) is None


# -- the splice -------------------------------------------------------------------
SPLICES = {
    "tiles_the_window": ({"total": 0.06, "endpoint": "s",
                          "stages": {"device": 0.04, "queue_wait": 0.01}},
                         0.0),
    "wall_split": ({"total": 0.06, "recv_wall": 1000.030}, 1000.0),
    "skewed_wall_symmetric": ({"total": 0.06, "recv_wall": 1180.0}, 1000.0),
    "total_clamped_to_rtt": ({"total": 5.0, "endpoint": "s",
                              "stages": {"device": 4.0}}, 0.0),
    "stages_scaled_into_total": ({"total": 0.05,
                                  "stages": {"device": 0.08,
                                             "queue_wait": 0.02}}, 0.0),
    "stages_without_total": ({"stages": {"device": 0.01}}, 0.0),
}


@pytest.mark.parametrize("case", sorted(SPLICES))
def test_splice_equals_jax(case):
    """The five DIST_STAGES the port splices equal the JAX package's, to
    the bit, and tile the client's RTT window."""
    span, sent_wall = SPLICES[case]
    tl, jtl = TL.Timeline(), JTL.Timeline()
    dist.splice_remote(tl, 42, 10.0, 10.1, sent_wall, span)
    jdist.splice_remote(jtl, 42, 10.0, 10.1, sent_wall, span)
    got = tl.frame_stages(42)
    assert got == jtl.frame_stages(42)
    assert set(got) <= set(TL.DIST_STAGES)
    assert sum(got.values()) == pytest.approx(0.1, abs=1e-9)
    if case == "wall_split":
        assert got["hop_send"] == pytest.approx(0.030)
    if case == "skewed_wall_symmetric":
        assert got["hop_send"] == pytest.approx(got["hop_recv"])


def test_degenerate_splices_are_noops():
    tl = TL.Timeline()
    dist.splice_remote(tl, 1, 10.0, 10.0, 0.0, {"total": 1.0})
    dist.splice_remote(tl, None, 10.0, 11.0, 0.0, {"total": 1.0})
    dist.splice_remote(None, 1, 10.0, 11.0, 0.0, {"total": 1.0})
    assert tl.frame_stages(1) == {}


def test_flight_recorder_accumulates_dist_stages_as_jax():
    got = {}
    for name, mod, rec in (("port", dist, FlightRecorder),
                           ("jax", jdist, JaxFlightRecorder)):
        fr = rec()
        mod.splice_remote(fr, 42, 10.0, 10.1, 0.0,
                          {"total": 0.06, "stages": {"device": 0.05}})
        stages = fr.frame_stages(42)
        fr.span("sink", 42, 10.1, 10.101, track="io", e2e_s=0.101)
        got[name] = (stages, fr._q["remote_device"]["p50"].count)
    assert got["port"] == got["jax"]
    assert got["port"][0]["remote_device"] == pytest.approx(0.05)


def test_endpoint_spans_export_as_their_own_process():
    tl = TL.Timeline()
    tl.span("device", 7, 10.000, 10.004, track="exec")
    dist.splice_remote(tl, 7, 10.004, 10.104, 0.0,
                       {"total": 0.06, "endpoint": "edge-b:3000",
                        "stages": {"device": 0.05}})
    events = tl.to_chrome()["traceEvents"]
    procs = {e["args"]["name"]: e["pid"] for e in events
             if e.get("name") == "process_name"}
    remote = procs["endpoint edge-b:3000"]
    by_name = {e["name"]: e for e in events if e.get("ph") == "X"}
    assert by_name["remote_device"]["pid"] == remote
    assert by_name["hop_send"]["pid"] != remote


# -- the reliable loopback's remote stages -----------------------------------------
def _echo_server(delay_s=0.0, pkg="port"):
    if pkg == "port":
        src, out_cls = TensorQueryServerSrc(port=0, reliable=True), \
            TensorBuffer
    else:
        from nnstreamer_tpu.registry import ELEMENT, get_subplugin
        from nnstreamer_tpu.tensors.buffer import TensorBuffer as JaxBuffer

        src = get_subplugin(ELEMENT, "tensor_query_serversrc")(
            port=0, reliable=True)
        out_cls = JaxBuffer
    src.start()
    server = src.server
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            buf = server.get_buffer(timeout=0.1)
            if buf is None:
                continue
            if delay_s:
                stop.wait(delay_s)
            out = out_cls([np.asarray(t) * 2
                           for t in buf.to_host().tensors], pts=buf.pts)
            out.meta.update(buf.meta)
            server.send_result(buf.meta["query_client_id"], out)

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    return src, stop, th


def _run(n=6, delay_s=0.0, pkg="port", **client_props):
    src, stop, th = _echo_server(delay_s, pkg)
    cl = TensorQueryClient(port=src.port, reliable=True, timeout=5.0,
                           **client_props)
    outs = []
    cl.srcpad.push = lambda b: outs.append(b)
    try:
        for i in range(n):
            buf = TensorBuffer([np.full((4,), i, np.float32)], pts=i)
            buf.meta[TL.TRACE_SEQ_META] = 1000 + i
            cl.chain(cl.sinkpad, buf)
        cl.handle_eos()
    finally:
        stop.set()
        srv = src.server
        cl.stop()
        src.stop()
        th.join(JOIN_S)
    return outs, srv


@pytest.mark.parametrize("server", ["port", "jax"])
def test_remote_stages_reconcile_with_the_round_trip(server):
    """The spliced stages tile the observed round trip, and the server's
    10 ms of work lands in the remote stages, not on the wire — against a
    port server and a JAX one."""
    fr = FlightRecorder()
    old = TL.ACTIVE
    TL.ACTIVE = fr
    try:
        outs, _ = _run(n=6, delay_s=0.01, pkg=server)
    finally:
        TL.ACTIVE = old
    assert len(outs) == 6
    got = fr.frame_stages(1003)
    remote = sum(v for k, v in got.items() if k.startswith("remote_"))
    wire = got.get("hop_send", 0.0) + got.get("hop_recv", 0.0)
    assert remote >= 0.008
    assert remote + wire > 0.009


def _spy(monkeypatch):
    sent = []
    real = P.send_msg

    def spy(sock, cmd, payload=b""):
        sent.append((cmd, payload))
        return real(sock, cmd, payload)

    monkeypatch.setattr(P, "send_msg", spy)
    return sent


def test_kill_switch_speaks_classic_ex(monkeypatch):
    monkeypatch.setenv("NNSTPU_DIST_TRACE", "0")
    sent = _spy(monkeypatch)
    outs, srv = _run(n=3)
    assert len(outs) == 3
    transfers = [c for c, _ in sent
                 if c in (P.Cmd.TRANSFER_EX, P.Cmd.TRANSFER_EX2)]
    assert transfers and set(transfers) == {P.Cmd.TRANSFER_EX}
    hello = [p for c, p in sent if c is P.Cmd.HELLO]
    assert hello and b"dt1" not in hello[0]
    assert not srv._dt1_instances


def test_armed_speaks_ex2(monkeypatch):
    monkeypatch.delenv("NNSTPU_DIST_TRACE", raising=False)
    sent = _spy(monkeypatch)
    outs, srv = _run(n=3)
    assert len(outs) == 3
    cmds = {c for c, _ in sent}
    assert P.Cmd.TRANSFER_EX2 in cmds and P.Cmd.TRANSFER_EX not in cmds
    results = [c for c, _ in sent if c in (P.Cmd.RESULT_EX,
                                           P.Cmd.RESULT_EX2)]
    assert results and set(results) == {P.Cmd.RESULT_EX2}


# -- fleet metrics federation -----------------------------------------------------
def _replica(counter_v, gauge_v, samples, burn=None):
    """A real /metrics.json endpoint of the port: registry + quantile
    states."""
    reg = MetricsRegistry()
    reg.counter("nns_query_requests_total", "req", wire="nnstpu") \
        .inc(counter_v)
    reg.gauge("nns_queue_depth", "depth").set(gauge_v)
    q50, q99 = P2Quantile(0.5), P2Quantile(0.99)
    for x in samples:
        q50.observe(float(x))
        q99.observe(float(x))

    def extra():
        out = {"quantiles": {"e2e": {"p50": q50.snapshot(),
                                     "p99": q99.snapshot()}}}
        if burn:
            out["slo"] = {"burn": burn}
        return out

    return MetricsServer(registry=reg, host="127.0.0.1", port=0,
                         snapshot_fn=extra).start()


def _without_ts(view):
    view = dict(view)
    view.pop("ts")
    view["endpoints"] = {k: {"ok": v["ok"]}
                         for k, v in view["endpoints"].items()}
    return view


@pytest.mark.parametrize("seed", [0, 1])
def test_federated_view_equals_jax(seed):
    """Two port replicas and one that is down, scraped by both packages'
    aggregators: the merged views (counters summed, gauges per instance,
    P² markers merged, burn rates per endpoint) and the Prometheus text
    are equal."""
    rng = np.random.default_rng(seed)
    a_samples = rng.uniform(0.010, 0.030, 500)
    b_samples = rng.uniform(0.020, 0.040, 500)
    a = _replica(100, 3.0, a_samples, burn={"fast": 0.5, "slow": 0.1})
    b = _replica(250, 7.0, b_samples)
    eps = [("127.0.0.1", a.port), ("127.0.0.1", b.port), ("127.0.0.1", 1)]
    try:
        fed = dist.FederatedMetrics(endpoints=eps, timeout=2.0)
        jfed = jdist.FederatedMetrics(endpoints=eps, timeout=2.0)
        view, jview = fed.collect(), jfed.collect()
        text, jtext = fed.render_prometheus(), jfed.render_prometheus()
    finally:
        a.stop()
        b.stop()
    assert _without_ts(view) == _without_ts(jview)
    assert text == jtext
    reqs = [c for c in view["counters"]
            if c["name"] == "nns_query_requests_total"]
    assert len(reqs) == 1 and reqs[0]["value"] == 350.0
    pooled = np.concatenate([a_samples, b_samples])
    q = view["quantiles"]["e2e"]
    assert q["count"] == 1000
    assert abs(q["p50_ms"] - np.percentile(pooled, 50) * 1e3) <= 4.0
    assert not view["endpoints"]["127.0.0.1:1"]["ok"]
    assert 'nns_fleet_endpoint_up{instance="127.0.0.1:1"} 0' in text


def test_fleet_routes_on_the_metrics_server():
    a = _replica(5, 1.0, [0.01, 0.02])
    fed = dist.FederatedMetrics(endpoints=[("127.0.0.1", a.port)])
    front = MetricsServer(registry=MetricsRegistry(), host="127.0.0.1",
                          port=0, federation=fed).start()
    try:
        base = f"http://127.0.0.1:{front.port}"
        with urllib.request.urlopen(base + "/fleet/metrics.json",
                                    timeout=10) as r:
            view = json.loads(r.read().decode())
        assert view["counters"][0]["value"] == 5.0
        with urllib.request.urlopen(base + "/fleet/metrics",
                                    timeout=10) as r:
            assert b"nns_fleet_endpoint_up" in r.read()
    finally:
        front.stop()
        a.stop()


@pytest.mark.parametrize("broker_pkg", ["port", "jax"])
def test_federation_discovers_advertised_metrics_ports(broker_pkg):
    """``FederatedMetrics(operation=)`` scrapes the replicas whose ads
    carry a metrics port, through either package's broker; an ad without
    one is not a scrape target."""
    broker = (Broker if broker_pkg == "port" else jpubsub.Broker)(
        port=0).start()
    a = _replica(7, 2.0, [0.01])
    try:
        ad = ServerAdvertiser("127.0.0.1", broker.port, "fed-op",
                              "127.0.0.1", 3000, metrics_port=a.port)
        legacy = ServerAdvertiser("127.0.0.1", broker.port, "fed-op",
                                  "127.0.0.1", 3001)
        ad.publish()
        legacy.publish()
        try:
            disco = ServerDiscovery("127.0.0.1", broker.port, "fed-op")
            try:
                assert len(disco.wait_servers(timeout=5.0)) == 2
                assert disco.metrics_endpoints() == [("127.0.0.1", a.port)]
            finally:
                disco.close()
            fed = dist.FederatedMetrics(operation="fed-op",
                                        broker_port=broker.port)
            assert fed.discover(timeout=5.0) == [("127.0.0.1", a.port)]
            view = fed.collect()
        finally:
            ad.retract()
            legacy.retract()
    finally:
        a.stop()
        broker.stop()
    assert view["counters"][0]["value"] == 7.0
