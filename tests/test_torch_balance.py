"""Fleet balancing in the PyTorch port (``query/balance.py`` and the query
client's ``balance=shortest-slack``), held to the JAX package.

The policy is pure, so the same ad payloads, RTTs and in-flight counts
through both packages parse, score and rank the same. The loopbacks run
two resilient echo replicas behind one balanced client: every frame comes
back once, in order, from both replicas; a stalled replica sheds its
routes to its sibling; a breaker-open endpoint gets none. A JAX balanced
client across a mixed fleet (one JAX replica, one port replica) and a port
client across the same fleet show the wire holds across the packages.
Every socket is on 127.0.0.1 with ``port=0`` and every wait is bounded.
"""

import threading
import time

import numpy as np
import pytest

import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.query import balance as JB
from nnstreamer_tpu.registry import ELEMENT as JELEMENT
from nnstreamer_tpu.registry import get_subplugin as jget
from nnstreamer_tpu.tensors.buffer import TensorBuffer as JaxBuffer
from nnstreamer_tpu_torch.elements.query import (
    TensorQueryClient,
    TensorQueryServerSrc,
)
from nnstreamer_tpu_torch.pipeline.element import FlowError
from nnstreamer_tpu_torch.query import balance as B
from nnstreamer_tpu_torch.query import resilience as R
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


# -- the policy, against the JAX package -------------------------------------------
AD_CASES = [
    None, {}, {"host": "127.0.0.1", "port": 3000, "ts": 123.0},
    {"load": "busy"}, {"load": {"queue_depth": "many"}},
    {"load": {"queue_depth": 2}},
    {"load": {"queue_depth": 3, "service_ms": 7.5,
              "slack_headroom_ms": -12.0}},
    {"load": {"queue_depth": -4, "service_ms": "2.5"}},
    {"load": {"service_ms": None, "slack_headroom_ms": 30}},
]


def _as_tuple(load):
    return None if load is None else (
        load.queue_depth, load.service_ms, load.slack_headroom_ms)


@pytest.mark.parametrize("ad", AD_CASES, ids=range(len(AD_CASES)))
def test_ad_load_parses_as_jax(ad):
    assert _as_tuple(B.parse_ad_load(ad)) == _as_tuple(JB.parse_ad_load(ad))


def test_pre_fleet_ad_is_load_unknown():
    assert B.parse_ad_load({"host": "127.0.0.1", "port": 3000,
                            "ts": 123.0}) is None


@pytest.mark.parametrize("seed", range(6))
def test_scores_and_ranks_equal_jax(seed):
    """Random candidate rows — RTT unknown or sampled, in-flight counts,
    loads unknown, partial or over budget — score and rank identically,
    ties included."""
    rng = np.random.default_rng(seed)
    rows, jrows = [], []
    for i in range(8):
        ep = (f"10.0.0.{int(rng.integers(1, 4))}", 3000 + i % 3 + 10 * i)
        rtt = None if rng.random() < 0.3 else float(rng.uniform(0, 0.02))
        inflight = int(rng.integers(0, 6))
        raw = None if rng.random() < 0.3 else {"load": {
            "queue_depth": int(rng.integers(0, 9)),
            "service_ms": float(rng.uniform(0, 10)),
            "slack_headroom_ms": float(rng.uniform(-50, 50))}}
        rows.append((ep, rtt, inflight, B.parse_ad_load(raw)))
        jrows.append((ep, rtt, inflight, JB.parse_ad_load(raw)))
        assert B.score(rtt, inflight, rows[-1][3]) == \
            JB.score(rtt, inflight, jrows[-1][3])
    assert B.rank(rows) == JB.rank(jrows)


def test_rank_breaks_ties_on_the_endpoint():
    a, b, c = ("hostA", 1), ("hostB", 2), ("hostC", 3)
    ranked = B.rank([(c, 0.01, 0, None), (a, 0.01, 0, None),
                     (b, 0.05, 0, None)])
    assert [ep for _, ep in ranked] == [a, c, b]


def test_balancer_metric_names_equal_jax():
    assert set(B.lb_metrics()) == set(JB.lb_metrics())
    B.note_route(("h", 1), 0.002)
    assert B.lb_metrics()["score_ms"].value == pytest.approx(2.0)


def test_two_endpoints_keep_their_own_hedge_timers():
    cl = TensorQueryClient(reliable=True)
    try:
        fast, slow = cl._r_stat("fast", 1000), cl._r_stat("slow", 2000)
        assert fast is not slow
        for _ in range(R.EndpointStats.MIN_SAMPLES):
            fast.observe(0.010)
            slow.observe(0.100)
        assert cl._r_stat("fast", 1000) is fast
        assert slow.hedge_timeout(0.001) > fast.hedge_timeout(0.001) * 5
    finally:
        cl.stop()


# -- kill switches ------------------------------------------------------------------
def test_balance_off_is_the_default():
    cl = TensorQueryClient(reliable=True)
    assert cl.get_property("balance") == "off" and not cl._balance_on()


def test_fleet_env_zero_disables(monkeypatch):
    monkeypatch.setenv("NNSTPU_FLEET", "0")
    assert not TensorQueryClient(reliable=True,
                                 balance="shortest-slack")._balance_on()


def test_unknown_mode_rejected():
    with pytest.raises(FlowError, match="balance"):
        TensorQueryClient(reliable=True, balance="round-robin")._balance_on()


def test_balance_needs_the_classic_framing():
    cl = TensorQueryClient(reliable=True, balance="shortest-slack",
                           wire="nnstreamer")
    with pytest.raises(FlowError, match="wire=nnstpu"):
        cl.chain(cl.sinkpad, TensorBuffer([np.zeros(2, np.float32)]))


# -- loopbacks ------------------------------------------------------------------------
def _echo_server(delay_s=0.0, pkg="port"):
    """(serversrc, stopper, invokes, thread): a resilient echo x2 replica
    whose worker waits ``delay_s`` a frame (a stalled replica)."""
    if pkg == "port":
        src, out_cls = TensorQueryServerSrc(port=0, reliable=True), \
            TensorBuffer
    else:
        src = jget(JELEMENT, "tensor_query_serversrc")(port=0,
                                                       reliable=True)
        out_cls = JaxBuffer
    src.start()
    server = src.server
    stop = threading.Event()
    invokes = []

    def worker():
        while not stop.is_set():
            buf = server.get_buffer(timeout=0.1)
            if buf is None:
                continue
            invokes.append(buf.meta.get("net_req_id"))
            if delay_s:
                stop.wait(delay_s)
            out = out_cls([np.asarray(t) * 2
                           for t in buf.to_host().tensors], pts=buf.pts)
            out.meta.update(buf.meta)
            server.send_result(buf.meta["query_client_id"], out)

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    return src, stop, invokes, th


def _run_pair(n, delay_a=0.0, delay_b=0.0, pkgs=("port", "port"),
              client="port", **client_props):
    sa, stop_a, inv_a, th_a = _echo_server(delay_a, pkgs[0])
    sb, stop_b, inv_b, th_b = _echo_server(delay_b, pkgs[1])
    props = dict(servers=f"127.0.0.1:{sa.port},127.0.0.1:{sb.port}",
                 reliable=True, balance="shortest-slack", max_in_flight=4,
                 timeout=5.0)
    props.update(client_props)
    if client == "port":
        cl, buf_cls = TensorQueryClient(**props), TensorBuffer
    else:
        cl, buf_cls = jget(JELEMENT, "tensor_query_client")(**props), \
            JaxBuffer
    outs = []
    cl.srcpad.push = lambda b: outs.append(b)
    try:
        for i in range(n):
            cl.chain(cl.sinkpad, buf_cls(
                [np.full((4,), i, dtype=np.float32)], pts=i))
        cl.handle_eos()
    finally:
        stop_a.set()
        stop_b.set()
        cl.stop()
        sa.stop()
        sb.stop()
        th_a.join(JOIN_S)
        th_b.join(JOIN_S)
    return outs, inv_a, inv_b


def _values(outs):
    return [int(np.asarray(o.to_host().tensors[0])[0]) for o in outs]


@pytest.mark.parametrize("pkgs,client", [
    (("port", "port"), "port"),
    (("jax", "port"), "jax"),   # a JAX balanced client, a mixed fleet
    (("port", "jax"), "port"),  # the port's client, the same mix
])
def test_both_replicas_serve_exactly_once_in_order(pkgs, client):
    outs, inv_a, inv_b = _run_pair(60, pkgs=pkgs, client=client)
    assert _values(outs) == [2 * i for i in range(60)]
    assert [o.pts for o in outs] == list(range(60))
    assert len(inv_a) + len(inv_b) == 60
    assert len(set(inv_a) | set(inv_b)) == 60  # no double invoke
    assert inv_a and inv_b  # both replicas probed


def test_stalled_replica_sheds_routes_to_its_sibling():
    outs, inv_a, inv_b = _run_pair(60, delay_a=0.1)
    assert _values(outs) == [2 * i for i in range(60)]
    assert len(set(inv_a) | set(inv_b)) == 60
    assert len(inv_b) > 0.8 * 60


def test_breaker_open_endpoint_gets_no_route():
    sa, stop_a, inv_a, th_a = _echo_server()
    sb, stop_b, inv_b, th_b = _echo_server()
    cl = TensorQueryClient(
        servers=f"127.0.0.1:{sa.port},127.0.0.1:{sb.port}", reliable=True,
        balance="shortest-slack", max_in_flight=2, timeout=5.0)
    outs = []
    cl.srcpad.push = lambda b: outs.append(b)
    try:
        br = cl._r_breaker("127.0.0.1", sa.port)
        for _ in range(100):
            br.record_failure()
            if not br.allow():
                break
        eps = [ep for ep, _, _, _ in cl._b_candidates()]
        assert ("127.0.0.1", sa.port) not in eps
        assert ("127.0.0.1", sb.port) in eps
        for i in range(10):
            cl.chain(cl.sinkpad, TensorBuffer(
                [np.full((4,), i, dtype=np.float32)], pts=i))
        cl.handle_eos()
        assert len(outs) == 10 and not inv_a and len(inv_b) == 10
    finally:
        stop_a.set()
        stop_b.set()
        cl.stop()
        sa.stop()
        sb.stop()
        th_a.join(JOIN_S)
        th_b.join(JOIN_S)


def test_balance_off_builds_no_balance_state():
    sa, stop, _inv, th = _echo_server()
    cl = TensorQueryClient(port=sa.port, reliable=True, max_in_flight=2,
                           timeout=5.0)
    outs = []
    cl.srcpad.push = lambda b: outs.append(b)
    try:
        for i in range(10):
            cl.chain(cl.sinkpad, TensorBuffer(
                [np.full((4,), i, dtype=np.float32)], pts=i))
        cl.handle_eos()
        assert _values(outs) == [2 * i for i in range(10)]
        assert cl._b_channels == {} and cl._b_pending == {}
        assert cl._b_discovery is None
    finally:
        stop.set()
        cl.stop()
        sa.stop()
        th.join(JOIN_S)


# -- the serversrc's refreshed ad -----------------------------------------------------
def test_serversrc_ads_carry_the_jax_load_block():
    """``advertise-interval-s`` re-publishes the ad with ``_ad_load``'s
    block and ``metrics-port``, as the JAX serversrc does: the same
    pipeline state gives the same block in both packages."""
    broker = Broker(port=0).start()
    desc = ("tensor_query_serversrc name=ss port=0 operation=adload "
            f"broker-host=127.0.0.1 broker-port={broker.port} "
            "reliable=true advertise-interval-s=0.05 metrics-port=9123 ! "
            "tensor_query_serversink")
    pipe = tnt.parse_launch(desc)
    jpipe = __import__("nnstreamer_tpu").parse_launch(
        desc.replace("operation=adload", "operation=adload-jax"))
    pipe.start()
    jpipe.start()
    try:
        assert pipe.get("ss")._ad_load() == jpipe.get("ss")._ad_load() == \
            {"queue_depth": 0}
        disco = ServerDiscovery("127.0.0.1", broker.port, "adload")
        try:
            (ep,) = disco.wait_servers(timeout=5.0)
            deadline = time.monotonic() + 5.0
            while disco.load(*ep) is None and time.monotonic() < deadline:
                time.sleep(0.02)
            assert disco.load(*ep) == {"queue_depth": 0}
            assert disco.metrics_endpoints() == [("127.0.0.1", 9123)]
        finally:
            disco.close()
    finally:
        pipe.stop()
        jpipe.stop()
        broker.stop()


def test_refreshed_ads_track_live_load():
    broker = Broker(port=0).start()
    try:
        depth = [0]
        adv = ServerAdvertiser(
            "127.0.0.1", broker.port, "adtest", "127.0.0.1", 4321,
            load_fn=lambda: {"queue_depth": depth[0], "service_ms": 5.0},
            refresh_s=0.05)
        old = ServerAdvertiser("127.0.0.1", broker.port, "adtest",
                               "127.0.0.1", 4322)
        disco = ServerDiscovery("127.0.0.1", broker.port, "adtest")
        try:
            adv.publish()
            old.publish()
            disco.wait_servers(timeout=5.0)
            assert disco.load("127.0.0.1", 4321) == {"queue_depth": 0,
                                                    "service_ms": 5.0}
            depth[0] = 7
            deadline = time.monotonic() + 5.0
            load = None
            while time.monotonic() < deadline:
                load = disco.load("127.0.0.1", 4321)
                if load and load.get("queue_depth") == 7:
                    break
                time.sleep(0.02)
            assert load["queue_depth"] == 7
            assert B.parse_ad_load({"load": disco.load("127.0.0.1",
                                                       4322)}) is None
        finally:
            adv.retract()
            old.retract()
            disco.close()
    finally:
        broker.stop()


@pytest.mark.parametrize("client", ["port", "jax"])
def test_a_route_that_revives_a_channel_resends_its_entries(client):
    """ROADMAP C.45: a channel dies with results unread, and a new frame's
    route revives it before the recovery pass does. The port's client
    resends the channel's entries at once (the replica's dedup window
    replays them); the JAX client leaves them to the stall timer
    (``timeout``). Every frame comes back once either way."""
    sa, stop, invokes, th = _echo_server()
    props = dict(servers=f"127.0.0.1:{sa.port}", reliable=True,
                 balance="shortest-slack", max_in_flight=8, timeout=2.0,
                 reconnect_backoff_ms=1.0)
    if client == "port":
        cl, buf_cls = TensorQueryClient(**props), TensorBuffer
    else:
        cl, buf_cls = jget(JELEMENT, "tensor_query_client")(**props), \
            JaxBuffer
    outs = []
    cl.srcpad.push = lambda b: outs.append(b)
    try:
        for i in range(3):  # in flight: the window holds 8
            cl.chain(cl.sinkpad, buf_cls([np.full((4,), i, np.float32)],
                                         pts=i))
        deadline = time.monotonic() + JOIN_S
        while len(invokes) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)  # the results reach the client's socket, unread
        (ch,) = cl._b_channels.values()
        ch.kill()
        ch.next_attempt_t = 0.0
        t0 = time.monotonic()
        cl.chain(cl.sinkpad, buf_cls([np.full((4,), 3, np.float32)], pts=3))
        cl.handle_eos()
        dt = time.monotonic() - t0
    finally:
        stop.set()
        cl.stop()
        sa.stop()
        th.join(JOIN_S)
    assert _values(outs) == [0, 2, 4, 6]
    assert len(invokes) == len(set(invokes)) == 4
    # the entries were sent about 0.2 s before the route: the JAX client
    # waits out the rest of the 2 s stall timer
    if client == "port":
        assert dt < 0.5
    else:
        assert dt > 1.0
