"""The resilient query transport in the PyTorch port (``query/
resilience.py``, the protocol's commands 9-14, the server's dedup windows
and the reliable client), held to the JAX package.

The primitives are pure functions of their inputs, so the same inputs
through both packages give the same delays, breaker transitions, hedge
timers, window snapshots and frame bytes, exactly. The loopbacks run the
JAX package's chaos pattern (``tests/test_resilience.py``) on the port and
across the packages in both directions: every frame arrives, in order and
byte-identical, and the server invokes each request once. Every socket is
on 127.0.0.1 with ``port=0`` and every wait is bounded.
"""

import pickle
import threading
import time

import numpy as np
import pytest

import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.pipeline import faults as JF
from nnstreamer_tpu.query import protocol as JP
from nnstreamer_tpu.query import resilience as JR
from nnstreamer_tpu.registry import ELEMENT as JELEMENT
from nnstreamer_tpu.registry import get_subplugin as jget
from nnstreamer_tpu.tensors.buffer import TensorBuffer as JaxBuffer
from nnstreamer_tpu_torch.elements.query import (
    TensorQueryClient,
    TensorQueryServerSrc,
)
from nnstreamer_tpu_torch.pipeline import faults as F
from nnstreamer_tpu_torch.query import protocol as P
from nnstreamer_tpu_torch.query import resilience as R
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

#: the JAX chaos loopback's spec and seed (tests/test_resilience.py)
CHAOS = ("query.send:rate=0.05,kind=disconnect;"
         "query.recv:rate=0.05,kind=drop")
CHAOS_SEED = 11
JOIN_S = 10.0  # every thread join in this file


@pytest.fixture(autouse=True)
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


# -- primitives, against the JAX package --------------------------------------
@pytest.mark.parametrize("key", ["k", "client-3", "fleet:lb", ""])
@pytest.mark.parametrize("base_ms", [10.0, 50.0, 400.0])
def test_retry_delays_equal_jax(key, base_ms):
    ours = R.RetryPolicy(base_ms=base_ms, key=key)
    theirs = JR.RetryPolicy(base_ms=base_ms, key=key)
    assert [ours.delay(a) for a in range(1, 16)] == \
        [theirs.delay(a) for a in range(1, 16)]
    assert all(ours.delay(a) <= R.BACKOFF_CAP_S for a in range(1, 16))


# (event, seconds after the start) — the same clock drives both breakers
BREAKER_SCRIPTS = {
    "open_then_probe_closes": [("f", 0.0), ("f", 0.1), ("f", 0.2),
                               ("a", 0.3), ("a", 1.3), ("s", 1.31)],
    "probe_fails_reopens": [("f", 0.0), ("a", 0.5), ("a", 1.2),
                            ("f", 1.25), ("a", 1.3), ("a", 2.3)],
    "successes_reset": [("f", 0.0), ("f", 0.1), ("s", 0.2), ("f", 0.3),
                        ("f", 0.4), ("a", 0.5)],
}


@pytest.mark.parametrize("script", sorted(BREAKER_SCRIPTS))
def test_breaker_transitions_equal_jax(script):
    got = {}
    for name, mod in (("port", R), ("jax", JR)):
        br = mod.CircuitBreaker(failures=3 if script != "probe_fails_reopens"
                                else 1, reset_s=1.0, endpoint=f"{name}:1")
        allowed = []
        for event, t in BREAKER_SCRIPTS[script]:
            now = 100.0 + t
            if event == "f":
                br.record_failure(now=now)
            elif event == "s":
                br.record_success(now=now)
            else:
                allowed.append(br.allow(now=now))
        got[name] = (allowed, br.state, list(br.transitions))
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_endpoint_stats_equal_jax(seed):
    rtts = np.random.default_rng(seed).exponential(0.01, 300)
    ours, theirs = R.EndpointStats(), JR.EndpointStats()
    for i, rtt in enumerate(rtts):
        ours.observe(float(rtt))
        theirs.observe(float(rtt))
        if i % 37 == 0:
            assert ours.ewma() == theirs.ewma()
            assert ours.p99() == theirs.p99()
            assert ours.hedge_timeout(0.005) == theirs.hedge_timeout(0.005)


def _window_ops(mod, size, seed):
    rng = np.random.default_rng(seed)
    w = mod.DedupWindow(size=size)
    verdicts = []
    for _ in range(80):
        rid = int(rng.integers(0, 24))
        op = rng.integers(0, 3)
        if op == 0:
            v = w.admit(rid)
            verdicts.append("new" if v is mod.NEW else
                            "pending" if v is mod.PENDING else v)
        elif op == 1:
            w.resolve(rid, (11, bytes([rid]) * 3))
        else:
            w.forget(rid)
    return w, verdicts


@pytest.mark.parametrize("size,seed", [(4, 0), (8, 1), (64, 2), (16, 3)])
def test_dedup_window_snapshots_equal_jax(size, seed):
    ours, ov = _window_ops(R, size, seed)
    theirs, tv = _window_ops(JR, size, seed)
    assert ov == tv
    assert len(ours) == len(theirs)
    assert ours.snapshot() == theirs.snapshot()
    # a snapshot from one package restores into the other, as it restores
    # into its own (the window keeps the larger size)
    back, jback = R.DedupWindow(size=size), JR.DedupWindow(size=size)
    back.restore(theirs.snapshot())
    jback.restore(ours.snapshot())
    assert back.snapshot() == jback.snapshot() == theirs.snapshot()


def test_dedup_window_admits_once_under_racing_threads():
    w = R.DedupWindow(size=64)
    verdicts = []
    barrier = threading.Barrier(8)

    def racer():
        barrier.wait(timeout=JOIN_S)
        verdicts.append(w.admit(42))

    threads = [threading.Thread(target=racer, daemon=True)
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
        assert not t.is_alive()
    assert verdicts.count(R.NEW) == 1 and verdicts.count(R.PENDING) == 7


@pytest.mark.parametrize("deadline", [None, -5.0, 0.0, 2.0])
def test_pending_entry_slack_equals_jax(deadline):
    now = 50.0
    d = None if deadline is None else now + deadline
    assert R.PendingEntry(1, 0, {}, b"x", deadline_t=d).slack_s(now) == \
        JR.PendingEntry(1, 0, {}, b"x", deadline_t=d).slack_s(now)


# -- frame bytes ----------------------------------------------------------------
EXT_CASES = [(0, -1.0, b""), (77, 1.5, b"abc"), (2 ** 63, 0.0, b"\x00" * 9)]


@pytest.mark.parametrize("req_id,slack,body", EXT_CASES)
def test_ext_frames_equal_jax(req_id, slack, body):
    ours = P.pack_ext(req_id, slack, body)
    assert ours == JP.pack_ext(req_id, slack, body)
    assert P.unpack_ext(ours) == JP.unpack_ext(ours) == (req_id, slack, body)


@pytest.mark.parametrize("req_id,slack,body", EXT_CASES)
@pytest.mark.parametrize("blob", [b"", b'{"v": 1}'])
def test_ext2_frames_equal_jax(req_id, slack, body, blob):
    args = (req_id, slack, 1234 + req_id % 7, 1700000000.25, blob, body)
    ours = P.pack_ext2(*args)
    assert ours == JP.pack_ext2(*args)
    assert P.unpack_ext2(ours) == JP.unpack_ext2(ours) == args


def test_short_ext_headers_raise():
    with pytest.raises(P.QueryProtocolError):
        P.unpack_ext(b"\x00\x01")
    with pytest.raises(P.QueryProtocolError):
        P.unpack_ext2(b"\x00" * 20)
    with pytest.raises(P.QueryProtocolError):  # blob longer than the frame
        P.unpack_ext2(P.pack_ext2(1, -1.0, 2, 0.0, b"abcd")[:-2])


def test_command_ids_equal_jax():
    assert {c.name: int(c) for c in P.Cmd} == \
        {c.name: int(c) for c in JP.Cmd}


class _FakeSock:
    def __init__(self):
        self.sent = []

    def sendall(self, data):
        self.sent.append(bytes(data))

    def gettimeout(self):
        return 1.0


def test_classic_wire_bytes_unchanged():
    """No resilience knob set: the client's TRANSFER is the classic
    framing, byte for byte the JAX client's."""
    tensors = [np.arange(6, dtype=np.float32)]
    ours, theirs = _FakeSock(), _FakeSock()
    cl = TensorQueryClient()
    cl._sock = ours
    cl._send_buf(TensorBuffer(tensors, pts=9))
    jcl = jget(JELEMENT, "tensor_query_client")()
    jcl._sock = theirs
    jcl._send_buf(JaxBuffer(tensors, pts=9))
    assert b"".join(ours.sent) == b"".join(theirs.sent)
    assert b"".join(ours.sent)[4:8] == int(P.Cmd.TRANSFER).to_bytes(4,
                                                                  "little")


@pytest.mark.parametrize("dt1", [False, True])
def test_reliable_transfer_bytes_equal_jax(dt1, monkeypatch):
    """One entry through each client's ``_r_send_entry``: TRANSFER_EX
    (or EX2 when dt1 was granted) carries the same bytes, the wall stamp
    held fixed."""
    from nnstreamer_tpu.obs import distributed as jdist
    from nnstreamer_tpu_torch.obs import distributed as dist

    monkeypatch.setattr(dist, "wall_now", lambda: 1700000000.5)
    monkeypatch.setattr(jdist, "wall_now", lambda: 1700000000.5)
    tensors = [np.arange(4, dtype=np.int16)]
    sent = {}
    for name, cls, buf in (
            ("port", TensorQueryClient, TensorBuffer(tensors, pts=3)),
            ("jax", jget(JELEMENT, "tensor_query_client"),
             JaxBuffer(tensors, pts=3))):
        cl = cls(reliable=True)
        cl._sock = _FakeSock()
        cl._r_dt1 = dt1
        buf.meta["trace_seq"] = 17
        cl._r_send_entry(cl._r_make_entry(buf))
        sent[name] = b"".join(cl._sock.sent)
    assert sent["port"] == sent["jax"]
    cmd = P.Cmd.TRANSFER_EX2 if dt1 else P.Cmd.TRANSFER_EX
    assert sent["port"][4:8] == int(cmd).to_bytes(4, "little")


# -- loopbacks --------------------------------------------------------------------
def _echo_server(pkg="port", reliable=True):
    """(serversrc element, worker stopper, invoke list): echoes each frame
    doubled, recording every net_req_id it actually invokes."""
    cls = TensorQueryServerSrc if pkg == "port" else \
        jget(JELEMENT, "tensor_query_serversrc")
    out_cls = TensorBuffer if pkg == "port" else JaxBuffer
    src = cls(port=0, reliable=reliable)
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
            host = buf.to_host().tensors
            out = out_cls([np.asarray(t) * 2 for t in host], pts=buf.pts)
            out.meta.update(buf.meta)
            server.send_result(buf.meta["query_client_id"], out)

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    return src, stop, invokes, th


def _run(n, client_props, server="port", client="port", fault_spec=None,
         seed=CHAOS_SEED):
    src, stop, invokes, th = _echo_server(server)
    if client == "port":
        cl, buf_cls, mod = TensorQueryClient(
            port=src.port, reliable=True, **client_props), TensorBuffer, F
    else:
        cl = jget(JELEMENT, "tensor_query_client")(
            port=src.port, reliable=True, **client_props)
        buf_cls, mod = JaxBuffer, JF
    outs = []
    cl.srcpad.push = lambda b: outs.append(b)
    old = mod.ACTIVE
    if fault_spec:
        mod.ACTIVE = mod.FaultInjector(mod.parse_faults(fault_spec),
                                       seed=seed)
    try:
        for i in range(n):
            cl.chain(cl.sinkpad, buf_cls(
                [np.full((4,), i, dtype=np.float32)], pts=i))
        cl.handle_eos()
    finally:
        mod.ACTIVE = old
        stop.set()
        server_obj = src.server  # src.stop() nulls the handle
        cl.stop()
        src.stop()
        th.join(JOIN_S)
    return outs, invokes, server_obj


def _values(outs):
    return [int(np.asarray(o.to_host().tensors[0])[0]) for o in outs]


@pytest.mark.parametrize("server,client", [("port", "port"),
                                           ("jax", "port"),
                                           ("port", "jax")])
def test_clean_run_exactly_once_in_order(server, client):
    outs, invokes, _ = _run(30, dict(max_in_flight=4, timeout=5.0),
                            server=server, client=client)
    assert _values(outs) == [2 * i for i in range(30)]
    assert [o.pts for o in outs] == list(range(30))
    assert len(invokes) == 30 and len(set(invokes)) == 30


@pytest.mark.parametrize("server,client", [("port", "port"),
                                           ("jax", "port"),
                                           ("port", "jax")])
def test_chaos_zero_loss_zero_double_invoke(server, client):
    """The JAX package's chaos loopback, on the port and across the
    packages: under disconnect and drop faults every frame arrives
    byte-identical and in order, the server invoked each request once,
    and its dedup window absorbed the resends."""
    retries0 = R.metrics()["retries"].value
    outs, invokes, server_obj = _run(
        120, dict(max_in_flight=4, timeout=0.5, max_retry=8,
                  reconnect_backoff_ms=10.0),
        server=server, client=client, fault_spec=CHAOS)
    assert _values(outs) == [2 * i for i in range(120)]  # zero loss
    assert len(invokes) - len(set(invokes)) == 0  # no double invoke
    assert server_obj.dedup_hits > 0
    if client == "port":
        assert R.metrics()["retries"].value > retries0


# -- the reconnect interleavings behind ROADMAP C.53, forced -------------------
def _raw_reliable_conn(port, instance="inst-c53"):
    """A hand-driven reliable connection: classic handshake, then HELLO."""
    sock = P.connect("127.0.0.1", port, timeout=5.0)
    P.send_msg(sock, P.Cmd.REQUEST_INFO, b"")
    assert P.recv_msg(sock)[0] is P.Cmd.APPROVE
    P.recv_msg(sock)  # CLIENT_ID
    P.send_msg(sock, P.Cmd.HELLO, f"{instance}:64".encode())
    assert P.recv_msg(sock)[0] is P.Cmd.HELLO
    return sock


def _send_req(sock, req_id):
    body = P.pack_buffer(TensorBuffer([np.full((2,), req_id, np.float32)],
                                      pts=req_id))
    P.send_msg(sock, P.Cmd.TRANSFER_EX, P.pack_ext(req_id, -1.0, body))


def _reply(server, buf):
    out = TensorBuffer([np.asarray(buf.to_host().tensors[0]) * 2],
                       pts=buf.pts)
    out.meta.update(buf.meta)
    server.send_result(buf.meta["query_client_id"], out)


def _wait_for(cond, what):
    deadline = time.monotonic() + JOIN_S
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.005)


def test_c53_reply_of_an_old_connection_waits_for_the_resend():
    """Request 1 is answered on connection A, request 2 is still being
    invoked when A dies. The client reconnects (B) and, before it resends,
    request 2's reply is ready: sent to B at once it would overtake the
    replay of request 1 that B's resend is about to get. It waits for its
    resend instead, so B reads 1 then 2."""
    src = TensorQueryServerSrc(port=0, reliable=True)
    src.start()
    server = src.server
    try:
        a = _raw_reliable_conn(src.port)
        _send_req(a, 1)
        _send_req(a, 2)
        b1, b2 = server.get_buffer(timeout=5), server.get_buffer(timeout=5)
        assert [b1.meta["net_req_id"], b2.meta["net_req_id"]] == [1, 2]
        _reply(server, b1)
        a.close()
        _wait_for(lambda: not server._instances, "the server to drop A")
        b = _raw_reliable_conn(src.port)
        _reply(server, b2)  # lands before B's resends
        _send_req(b, 1)
        _send_req(b, 2)
        got = []
        for _ in range(2):
            cmd, payload = P.recv_msg(b)
            assert cmd is P.Cmd.RESULT_EX
            got.append(P.unpack_ext(payload)[0])
        assert got == [1, 2]
        b.close()
    finally:
        src.stop()


def test_c53_a_stale_connection_keeps_no_claim_on_a_resent_request():
    """Connection A is left behind but its handler still reads: request 5
    reaches the server over B (the resend) before A's copy of it. The
    reply goes to B, which resent it, not to A."""
    src = TensorQueryServerSrc(port=0, reliable=True)
    src.start()
    server = src.server
    try:
        a = _raw_reliable_conn(src.port)
        b = _raw_reliable_conn(src.port)  # the instance now lives on B
        _send_req(b, 5)
        buf = server.get_buffer(timeout=5)
        hits = server.dedup_hits
        _send_req(a, 5)  # A's late copy: a duplicate
        _wait_for(lambda: server.dedup_hits > hits, "A's copy")
        _reply(server, buf)
        b.settimeout(5.0)
        cmd, payload = P.recv_msg(b)
        assert cmd is P.Cmd.RESULT_EX and P.unpack_ext(payload)[0] == 5
        a.close()
        b.close()
    finally:
        src.stop()


def test_c53_client_delivers_in_request_order():
    """The server answers request 2 before request 1 (as a reconnect's
    replays can): the reliable client holds 2 until 1 has arrived."""
    src = TensorQueryServerSrc(port=0, reliable=True)
    src.start()
    server = src.server
    stop = threading.Event()

    def reversed_pair():
        bufs = []
        while len(bufs) < 2 and not stop.is_set():
            buf = server.get_buffer(timeout=0.1)
            if buf is not None:
                bufs.append(buf)
        for buf in reversed(bufs):
            _reply(server, buf)

    th = threading.Thread(target=reversed_pair, daemon=True)
    th.start()
    cl = TensorQueryClient(port=src.port, reliable=True, max_in_flight=2,
                           timeout=5.0)
    outs = []
    cl.srcpad.push = lambda b: outs.append(b)
    try:
        for i in range(2):
            cl.chain(cl.sinkpad, TensorBuffer(
                [np.full((2,), i, np.float32)], pts=i))
        cl.handle_eos()
    finally:
        stop.set()
        cl.stop()
        src.stop()
        th.join(JOIN_S)
    assert [o.pts for o in outs] == [0, 1]
    assert _values(outs) == [0, 2]


def test_corrupt_frames_recover_via_forget():
    outs, invokes, _ = _run(
        40, dict(max_in_flight=2, timeout=0.5, max_retry=8,
                 reconnect_backoff_ms=10.0),
        fault_spec="query.send:rate=0.1,kind=corrupt")
    assert _values(outs) == [2 * i for i in range(40)]
    assert len(invokes) - len(set(invokes)) == 0


def test_the_same_seed_fires_the_same_faults_as_jax():
    ours = F.FaultInjector(F.parse_faults(CHAOS), seed=CHAOS_SEED)
    theirs = JF.FaultInjector(JF.parse_faults(CHAOS), seed=CHAOS_SEED)
    for site in ("query.send", "query.recv") * 100:
        assert ours.action(site) == theirs.action(site)


@pytest.mark.parametrize("server,client", [("port", "port"),
                                           ("jax", "port"),
                                           ("port", "jax")])
def test_reliable_client_against_a_classic_server_fails_at_connect(
        server, client):
    """A classic server does not speak HELLO: the reliable client raises
    ``QueryProtocolError`` at connect, as the JAX client does."""
    src, stop, _invokes, th = _echo_server(server, reliable=False)
    if client == "port":
        cl, err = TensorQueryClient(port=src.port, reliable=True,
                                    timeout=0.5, max_retry=1), \
            P.QueryProtocolError
        buf = TensorBuffer([np.zeros(2, np.float32)], pts=0)
    else:
        cl = jget(JELEMENT, "tensor_query_client")(
            port=src.port, reliable=True, timeout=0.5, max_retry=1)
        err, buf = JP.QueryProtocolError, JaxBuffer(
            [np.zeros(2, np.float32)], pts=0)
    try:
        t0 = time.monotonic()
        with pytest.raises(err):
            cl.chain(cl.sinkpad, buf)
        assert time.monotonic() - t0 < 5.0
    finally:
        stop.set()
        cl.stop()
        src.stop()
        th.join(JOIN_S)


def test_frames_expired_is_read_only():
    with pytest.raises(ValueError):
        TensorQueryClient().set_property("frames_expired", 7)


# -- deadline propagation -------------------------------------------------------
def test_blown_deadline_expires_remotely():
    src, stop, invokes, th = _echo_server()
    cl = TensorQueryClient(port=src.port, reliable=True,
                           propagate_deadline=True, timeout=5.0)
    outs = []
    cl.srcpad.push = lambda b: outs.append(b)
    try:
        now = time.monotonic()
        live = TensorBuffer([np.ones(4, np.float32)], pts=0)
        live.meta["deadline_t"] = now + 10.0
        blown = TensorBuffer([np.ones(4, np.float32)], pts=1)
        blown.meta["deadline_t"] = now - 1.0
        cl.chain(cl.sinkpad, live)
        cl.chain(cl.sinkpad, blown)
        cl.handle_eos()
        assert len(outs) == 1 and len(invokes) == 1
        assert src.server.remote_expired == 1
        assert cl.get_property("frames_expired") == 1
    finally:
        stop.set()
        cl.stop()
        src.stop()
        th.join(JOIN_S)


def test_scheduler_shed_notifies_the_origin():
    """A frame that arrived with a propagated deadline and is shed by the
    remote SLO scheduler sends an EXPIRED notice through its server
    (``note_remote_shed``), as the JAX scheduler does."""
    from nnstreamer_tpu_torch.serving.scheduler import SloScheduler

    src, stop, _invokes, th = _echo_server()
    try:
        server = src.server
        buf = TensorBuffer([np.ones(2, np.float32)], pts=0)
        buf.meta["_net_expire"] = (server, "nobody", 123)
        buf.meta["deadline_t"] = time.monotonic() - 1.0
        SloScheduler(budget_ms=10.0).note_shed(buf, time.monotonic())
        assert server.remote_expired == 1
        assert "_net_expire" not in buf.meta
        R.note_remote_shed(buf)  # the hook is spent: a no-op
        assert server.remote_expired == 1
    finally:
        stop.set()
        src.stop()
        th.join(JOIN_S)


# -- serving continuity -----------------------------------------------------------
def test_checkpoint_holds_packed_bytes_and_restores():
    """A reliable serversrc's dedup windows ride the pipeline checkpoint:
    every cached reply is packed bytes (never a tensor), and a restore
    into a fresh server replays them instead of re-invoking."""
    src, stop, _invokes, th = _echo_server()
    try:
        server_obj = src.server
        cl = TensorQueryClient(port=src.port, reliable=True, timeout=5.0,
                               max_in_flight=2)
        got = []
        cl.srcpad.push = lambda b: got.append(b)
        for i in range(5):
            cl.chain(cl.sinkpad, TensorBuffer(
                [np.full((3,), i, np.float32)], pts=i))
        cl.handle_eos()
        state = server_obj.checkpoint_state()
        cl.stop()
    finally:
        stop.set()
        src.stop()
        th.join(JOIN_S)
    (window,) = state["dedup"].values()
    replies = [r for _rid, r in window["entries"]]
    assert len(replies) == 5
    for cmd, payload in replies:
        assert int(cmd) in (int(P.Cmd.RESULT_EX), int(P.Cmd.RESULT_EX2))
        assert isinstance(payload, bytes)
    pickle.loads(pickle.dumps(state))  # plain data
    fresh = TensorQueryServerSrc(port=0, reliable=True)
    fresh.start()
    try:
        fresh.server.restore_state(state)
        assert fresh.server.checkpoint_state()["dedup"] == state["dedup"]
    finally:
        fresh.stop()


def test_pipeline_checkpoint_carries_the_servers_section(tmp_path):
    from nnstreamer_tpu_torch.pipeline import continuity

    pipe = tnt.parse_launch("tensor_query_serversrc name=ss port=0 "
                            "reliable=true ! tensor_query_serversink")
    pipe.start()
    try:
        srv = pipe.get("ss").server
        srv._dedup["inst"] = R.DedupWindow(size=8)
        srv._dedup["inst"].admit(3)
        srv._dedup["inst"].resolve(3, (P.Cmd.RESULT_EX, b"abc"))
        path = continuity.checkpoint(pipe, str(tmp_path))
        with open(path, "rb") as f:
            state = pickle.load(f)
        assert state["servers"]["ss"]["dedup"]["inst"] == \
            srv._dedup["inst"].snapshot()
        srv._dedup.clear()
        applied = continuity.restore(pipe, str(tmp_path))
        assert applied["servers"] == ["ss"]
        assert srv._dedup["inst"].admit(3) == (P.Cmd.RESULT_EX, b"abc")
    finally:
        pipe.stop()


def test_resilience_metric_names_equal_jax():
    assert set(R.metrics()) == set(JR.metrics())
    assert R.breaker_gauge("h:1") is R.breaker_gauge("h:1")
