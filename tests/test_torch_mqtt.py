"""MQTT 3.1.1 framing, the reference ``GstMQTTMessageHdr`` wire layout, SNTP
clock correction and the pubsub elements over MQTT in the PyTorch port,
held to the JAX package (``nnstreamer_tpu/query/mqtt.py``, ``ntp.py``,
``pubsub.py``, ``elements/pubsub.py``).

The cases of ``tests/test_mqtt.py`` run against the port's modules; every
packet encoder, the message header and the shim's buffer envelope give
byte-identical output in both packages for the same seeded buffers and
stamps; a JAX ``MqttClient`` talks to the port's ``MqttBroker`` and the
port's client to the JAX broker. Every socket is on 127.0.0.1 and every
wait is bounded.
"""

import ctypes as C
import socket
import struct
import threading
import time

import numpy as np
import pytest

import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.query import mqtt as JM
from nnstreamer_tpu.query import ntp as jntp
from nnstreamer_tpu.query import protocol as JP
from nnstreamer_tpu.query import pubsub as jpubsub
from nnstreamer_tpu.tensors.buffer import TensorBuffer as JaxBuffer
from nnstreamer_tpu_torch.query import mqtt as M
from nnstreamer_tpu_torch.query import ntp
from nnstreamer_tpu_torch.query import protocol as P
from nnstreamer_tpu_torch.query import pubsub
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

WAIT = 30  # seconds: every pipeline wait in this file


@pytest.fixture(autouse=True)
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


@pytest.fixture
def mqtt_broker():
    b = M.MqttBroker()
    yield b
    b.close()


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


# -- packet codec (tests/test_mqtt.py's cases on the port) ---------------------
@pytest.mark.parametrize("n,encoded", [
    (0, b"\x00"),
    (127, b"\x7f"),
    (128, b"\x80\x01"),
    (16383, b"\xff\x7f"),
    (16384, b"\x80\x80\x01"),
    (268_435_455, b"\xff\xff\xff\x7f"),
])
def test_varlen_spec_vectors(n, encoded):
    # the example table of MQTT 3.1.1 section 2.2.3
    assert M.encode_varlen(n) == encoded == JM.encode_varlen(n)
    assert M.decode_varlen(encoded) == (n, len(encoded))


def test_varlen_out_of_range_and_truncated():
    with pytest.raises(ValueError):
        M.encode_varlen(268_435_456)
    with pytest.raises(ValueError):
        M.decode_varlen(b"\xff\xff\xff\xff\x01")
    with pytest.raises(ValueError):
        M.decode_varlen(b"\x80")


def test_connect_layout():
    pkt = M.connect_packet("cid", keepalive=30)
    assert pkt[0] == M.CONNECT << 4
    body = pkt[2:]
    assert body[:6] == b"\x00\x04MQTT"
    assert body[6] == 4                      # protocol level 3.1.1
    assert body[7] == 0x02                   # clean session
    assert struct.unpack_from(">H", body, 8) == (30,)
    assert body[10:] == b"\x00\x03cid"


def test_publish_parse_and_qos1_layout():
    pkt = M.publish_packet("t/x", b"payload", retain=True)
    assert pkt[0] == (M.PUBLISH << 4) | 0x01
    _, used = M.decode_varlen(pkt, 1)
    assert M.parse_publish(pkt[0] & 0x0F, pkt[1 + used:]) == \
        ("t/x", b"payload", True, 0, None)
    pkt = M.publish_packet("a/b", b"xyz", qos=1, packet_id=300)
    assert pkt[0] == (M.PUBLISH << 4) | 0x02  # qos1, no dup/retain
    _, used = M.decode_varlen(pkt, 1)
    topic, payload, _retain, qos, pid = M.parse_publish(
        pkt[0] & 0x0F, pkt[1 + used:])
    assert (topic, payload, qos, pid) == ("a/b", b"xyz", 1, 300)
    assert M.publish_packet("a/b", b"xyz", qos=1, packet_id=300,
                            dup=True)[0] & 0x08  # DUP bit
    with pytest.raises(ValueError, match="packet id"):
        M.publish_packet("a/b", b"", qos=1)


def test_subscribe_flags_and_connack():
    pkt = M.subscribe_packet(7, "a/+/b")
    assert pkt[0] == (M.SUBSCRIBE << 4) | 0x02  # mandatory flags
    assert struct.unpack_from(">H", pkt[2:]) == (7,)
    assert pkt[2:].endswith(b"\x00")  # requested QoS0
    assert M.connack_packet(0)[-2:] == b"\x00\x00"
    assert M.connack_packet(5)[-1] == 5


@pytest.mark.parametrize("pattern,topic,match", [
    ("a/b", "a/b", True),
    ("a/b", "a/c", False),
    ("a/+", "a/b", True),
    ("a/+", "a/b/c", False),
    ("a/#", "a/b/c", True),
    ("#", "anything/at/all", True),
    ("a/+/c", "a/b/c", True),
    ("a/+/c", "a/b/d", False),
])
def test_topic_matching(pattern, topic, match):
    assert M.topic_matches(pattern, topic) is match
    assert JM.topic_matches(pattern, topic) is match


def _encoders(mod, rng):
    """Every packet encoder of ``mod`` on seeded arguments."""
    topic = "t/" + "".join(chr(97 + int(c)) for c in rng.integers(0, 26, 9))
    payload = rng.integers(0, 256, int(rng.integers(0, 300)),
                           dtype=np.uint8).tobytes()
    pid = int(rng.integers(1, 0xFFFF))
    return [
        mod.encode_varlen(int(rng.integers(0, 268_435_455))),
        mod.connect_packet(topic, keepalive=int(rng.integers(0, 600)),
                           clean_session=bool(rng.integers(0, 2))),
        mod.connack_packet(int(rng.integers(0, 6)),
                           session_present=bool(rng.integers(0, 2))),
        mod.publish_packet(topic, payload, retain=bool(rng.integers(0, 2))),
        mod.publish_packet(topic, payload, retain=bool(rng.integers(0, 2)),
                           qos=1, packet_id=pid,
                           dup=bool(rng.integers(0, 2))),
        mod.puback_packet(pid),
        mod.subscribe_packet(pid, topic + "/#", qos=int(rng.integers(0, 2))),
        mod.suback_packet(pid, [int(c) for c in
                                rng.choice([0, 1, 0x80], 3)]),
        mod.unsubscribe_packet(pid, topic),
        mod.unsuback_packet(pid),
        mod.pingreq_packet(),
        mod.pingresp_packet(),
        mod.disconnect_packet(),
    ]


@pytest.mark.parametrize("seed", range(4))
def test_every_packet_encoder_is_byte_identical_to_jax(seed):
    port = _encoders(M, np.random.default_rng(seed))
    jax = _encoders(JM, np.random.default_rng(seed))
    assert len(port) == 13
    assert port == jax


# -- the reference message header ----------------------------------------------
def test_header_layout_byte_exact():
    """Offsets match the C struct (mqttcommon.h:49-63): num_mems@0,
    size_mems@8, base@136, sent@144, duration@152, dts@160, pts@168,
    caps@176; the header is 1024 bytes."""
    msg = M.pack_gst_mqtt_message(
        [b"abcd", b"xy"], "other/tensors,num_tensors=2",
        base_time_epoch=111, sent_time_epoch=222,
        pts=333, dts=444, duration=555)
    hdr = msg[:M.GST_MQTT_LEN_MSG_HDR]
    assert len(msg) == 1024 + 6
    assert struct.unpack_from("<I", hdr, 0) == (2,)
    assert struct.unpack_from("<QQ", hdr, 8) == (4, 2)
    assert struct.unpack_from("<qqQQQ", hdr, 136) == (111, 222, 555, 444,
                                                      333)
    assert hdr[176:176 + 28] == b"other/tensors,num_tensors=2\x00"
    assert msg[1024:] == b"abcdxy"


def test_header_roundtrip_none_times_and_limits():
    out = M.parse_gst_mqtt_message(
        M.pack_gst_mqtt_message([b"\x01\x02"], "caps", 1, 2))
    assert out["mems"] == [b"\x01\x02"] and out["caps_str"] == "caps"
    assert out["pts"] is None and out["dts"] is None
    assert out["duration"] is None and out["base_time_epoch"] == 1
    with pytest.raises(ValueError, match="NUM_MEMS"):
        M.pack_gst_mqtt_message([b"x"] * 17, "", 0, 0)
    with pytest.raises(ValueError, match="caps"):
        M.pack_gst_mqtt_message([b"x"], "c" * 512, 0, 0)
    with pytest.raises(ValueError, match="Hdr"):
        M.parse_gst_mqtt_message(b"short")


def test_header_byte_identity_with_the_c_struct():
    """An independent oracle: the C struct mirrored with ctypes, filled as
    mqttsink fills it; byte identity with the packer in both directions."""
    class Hdr(C.Structure):
        _fields_ = [("num_mems", C.c_uint),
                    ("size_mems", C.c_size_t * 16),
                    ("base_time_epoch", C.c_int64),
                    ("sent_time_epoch", C.c_int64),
                    ("duration", C.c_uint64),
                    ("dts", C.c_uint64),
                    ("pts", C.c_uint64),
                    ("gst_caps_str", C.c_char * 512)]

    class Msg(C.Union):
        _fields_ = [("s", Hdr), ("_reserved_hdr", C.c_uint8 * 1024)]

    assert C.sizeof(Msg) == M.GST_MQTT_LEN_MSG_HDR
    m = Msg()
    m.s.num_mems = 2
    m.s.size_mems[0], m.s.size_mems[1] = 4, 2
    m.s.base_time_epoch, m.s.sent_time_epoch = 111, 222
    m.s.duration, m.s.dts, m.s.pts = 555, 444, 333
    m.s.gst_caps_str = b"other/tensors,num_tensors=2"
    golden = bytes(m) + b"abcdxy"
    assert M.pack_gst_mqtt_message(
        [b"abcd", b"xy"], "other/tensors,num_tensors=2",
        base_time_epoch=111, sent_time_epoch=222,
        pts=333, dts=444, duration=555) == golden
    out = M.parse_gst_mqtt_message(golden)
    assert out["mems"] == [b"abcd", b"xy"]
    assert out["caps_str"] == "other/tensors,num_tensors=2"
    assert (out["base_time_epoch"], out["sent_time_epoch"]) == (111, 222)
    assert (out["pts"], out["dts"], out["duration"]) == (333, 444, 555)


def _seeded_tensors(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, 3)).astype(np.float32),
            rng.integers(0, 256, (1, 8, 8, 3), dtype=np.uint8),
            rng.integers(-9, 9, (4,), dtype=np.int32),
            rng.standard_normal((5,)).astype(np.float16)]


def _stamps(seed):
    rng = np.random.default_rng(1000 + seed)
    base = int(rng.integers(1, 2 ** 62))
    return dict(base_time_epoch=base,
                sent_time_epoch=base + int(rng.integers(0, 10 ** 9)),
                pts=int(rng.integers(0, 2 ** 40)),
                dts=None if seed % 2 else int(rng.integers(0, 2 ** 40)),
                duration=int(rng.integers(0, 10 ** 8)))


@pytest.mark.parametrize("seed", range(3))
def test_message_header_and_envelope_are_byte_identical_to_jax(seed):
    """``pack_gst_mqtt_message`` on the same seeded memories and stamps,
    and the shim's envelope around each package's packed buffer, give the
    same bytes in both packages; each parses the other's."""
    tensors = _seeded_tensors(seed)
    mems = [t.tobytes() for t in tensors]
    caps = "other/tensors,format=static,num_tensors=4"
    st = _stamps(seed)
    ours = M.pack_gst_mqtt_message(mems, caps, **st)
    assert ours == JM.pack_gst_mqtt_message(mems, caps, **st)
    assert M.parse_gst_mqtt_message(ours) == JM.parse_gst_mqtt_message(ours)
    kw = dict(base_epoch=st["base_time_epoch"],
              sent_epoch=st["sent_time_epoch"])
    env = pubsub.make_buffer_envelope(
        P.pack_buffer(TensorBuffer(tensors, pts=st["pts"], dts=st["dts"])),
        st["pts"], **kw)
    jenv = jpubsub.make_buffer_envelope(
        JP.pack_buffer(JaxBuffer(tensors, pts=st["pts"], dts=st["dts"])),
        st["pts"], **kw)
    assert env == jenv
    base, sent, pts, payload = jpubsub.parse_buffer_envelope(env)
    assert (base, sent, pts) == (st["base_time_epoch"],
                                 st["sent_time_epoch"], st["pts"])
    back = P.unpack_buffer(pubsub.parse_buffer_envelope(jenv)[3])
    assert [np.asarray(t).tobytes() for t in back.tensors] == mems
    assert back.dts == st["dts"] and back.pts == st["pts"]
    with pytest.raises(ValueError, match="envelope"):
        pubsub.parse_buffer_envelope(b"NPE1" + env[4:])


# -- broker and clients over loopback ------------------------------------------
def test_pub_sub_and_retain_for_a_late_subscriber(mqtt_broker):
    got = []
    sub = M.MqttClient(port=mqtt_broker.port)
    sub.subscribe("s/t", lambda t, p: got.append((t, p)))
    pub = M.MqttClient(port=mqtt_broker.port)
    pub.publish("s/t", b"data")
    pub.publish("cfg/one", b"v1", retain=True)
    assert _wait(lambda: got == [("s/t", b"data")])
    late = []
    sub2 = M.MqttClient(port=mqtt_broker.port)
    sub2.subscribe("cfg/#", lambda t, p: late.append((t, p)))
    assert _wait(lambda: late == [("cfg/one", b"v1")])
    for c in (sub, sub2, pub):
        c.close()


@pytest.mark.parametrize("client,broker", [("jax", "port"),
                                           ("port", "jax")])
def test_clients_and_brokers_cross_the_packages(client, broker):
    """QoS0, QoS1 and a retained message between one package's clients
    and the other's broker."""
    cmod = JM if client == "jax" else M
    b = (M if broker == "port" else JM).MqttBroker()
    try:
        got0, got1 = [], []
        sub = cmod.MqttClient(port=b.port)
        sub.subscribe("x/0", lambda t, p: got0.append(p))
        sub.subscribe("x/1", lambda t, p: got1.append(p), qos=1)
        pub = cmod.MqttClient(port=b.port)
        payloads = [np.random.default_rng(i).bytes(1000 * i + 7)
                    for i in range(4)]
        for p in payloads:
            pub.publish("x/0", p)
        pub.publish("x/1", b"acked", qos=1, timeout=10.0)
        pub.publish("x/r", b"kept", retain=True)
        assert _wait(lambda: len(got0) == 4 and got1 == [b"acked"])
        assert got0 == payloads
        assert not pub._unacked  # the PUBACK was consumed
        late = []
        sub2 = cmod.MqttClient(port=b.port)
        sub2.subscribe("x/#", lambda t, p: late.append((t, p)))
        assert _wait(lambda: late == [("x/r", b"kept")])
        for c in (sub, sub2, pub):
            c.close()
    finally:
        b.close()


def test_qos1_roundtrip_drains_the_brokers_inflight_map():
    broker = M.MqttBroker()
    got = []
    try:
        sub = M.MqttClient(port=broker.port)
        sub.subscribe("q1/t", lambda t, p: got.append(p), qos=1)
        pub = M.MqttClient(port=broker.port)
        pub.publish("q1/t", b"hello-qos1", qos=1, timeout=10.0)
        assert _wait(lambda: got == [b"hello-qos1"], 10)
        assert not pub._unacked

        def drained():
            with broker._lock:
                return not any(broker._inflight.values())

        assert _wait(drained)
        pub.close()
        sub.close()
    finally:
        broker.close()


def test_qos1_retransmits_until_acked():
    """An unanswered QoS1 publish is sent again with DUP set."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    seen = []

    def fake_broker():
        sock, _ = srv.accept()
        M.read_packet(sock)  # CONNECT
        sock.sendall(M.connack_packet(0))
        while len(seen) < 2:
            pkt = M.read_packet(sock)
            if pkt is None:
                return
            if pkt[0] == M.PUBLISH:
                seen.append(pkt[1])  # flags
        sock.sendall(M.puback_packet(1))  # ack after the retransmission
        M.read_packet(sock)

    th = threading.Thread(target=fake_broker, daemon=True)
    th.start()
    c = M.MqttClient(port=srv.getsockname()[1], reconnect=False)
    c.publish("t", b"x", qos=1, timeout=15.0)
    assert len(seen) >= 2
    assert not seen[0] & 0x08   # first send: DUP clear
    assert seen[-1] & 0x08      # retransmission: DUP set
    c.close()
    srv.close()


def test_reconnect_resubscribes_and_resends():
    """The broker dies mid-session: the client reconnects to its
    replacement on the same port and its subscription is live there."""
    broker = M.MqttBroker()
    port = broker.port
    got = []
    c = M.MqttClient(port=port, keepalive=2)
    c.subscribe("r/t", lambda t, p: got.append(p), qos=1)
    broker.close()
    time.sleep(0.1)
    broker2 = M.MqttBroker(port=port)
    try:
        assert _wait(lambda: c.reconnects >= 1, 15), "never reconnected"
        # the count rises once the new SUBSCRIBE is sent; a publish that
        # beat its SUBACK could reach the broker before the subscription
        assert _wait(lambda: not c._resub_pids, 15), \
            "resubscription never acknowledged"
        c2 = M.MqttClient(port=port)
        c2.publish("r/t", b"after-reconnect", qos=1, timeout=10.0)
        assert _wait(lambda: got and got[-1] == b"after-reconnect", 10)
        c2.close()
        c.close()
    finally:
        broker2.close()


def test_failed_latches_when_reconnect_exhausted():
    broker = M.MqttBroker()
    c = M.MqttClient(port=broker.port, max_reconnect_attempts=2)
    broker.close()
    assert c.failed.wait(15), "failed never latched"
    c.close()


def test_unreachable_broker_raises():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    with pytest.raises(OSError):
        M.MqttClient(port=port, timeout=1.0)
    with pytest.raises(OSError):
        pubsub.Client("127.0.0.1", port, timeout=1.0)


# -- SNTP ------------------------------------------------------------------------
def _serve_sntp_once(server_offset_ns: int, delay: float = 0.0):
    """A one-shot mock SNTP server on 127.0.0.1; returns (port, thread)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]

    def run():
        data, addr = sock.recvfrom(512)
        t_server = time.time_ns() + server_offset_ns
        if delay:
            time.sleep(delay)  # processing delay inside the server
        r_sec, r_frac = ntp._to_ntp(t_server)
        x_sec, x_frac = ntp._to_ntp(time.time_ns() + server_offset_ns)
        reply = struct.pack(
            ">B3x11I", 0x24, 0, 0, 0, 0, 0,
            *struct.unpack_from(">2I", data, 40),  # origin := client xmit
            r_sec, r_frac, x_sec, x_frac)
        sock.sendto(reply, addr)
        sock.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return port, t


def test_sntp_offset_measured():
    port, t = _serve_sntp_once(server_offset_ns=3_000_000_000)
    off = ntp.sntp_offset_ns("127.0.0.1", port)
    t.join(5)
    assert abs(off - 3_000_000_000) < 200_000_000  # within 200 ms


def test_sntp_offset_excludes_latency():
    port, t = _serve_sntp_once(server_offset_ns=0, delay=0.4)
    off = ntp.sntp_offset_ns("127.0.0.1", port, timeout=5)
    t.join(5)
    assert abs(off) < 250_000_000  # far below the 400 ms delay


def test_ntp_timestamp_conversions_match_jax():
    rng = np.random.default_rng(3)
    for ns in [0, 1, 10 ** 9 - 1, *map(int, rng.integers(0, 2 ** 62, 20))]:
        assert ntp._to_ntp(ns) == jntp._to_ntp(ns)
        sec, frac = ntp._to_ntp(ns)
        assert ntp._from_ntp(sec, frac) == jntp._from_ntp(sec, frac)
    assert ntp._from_ntp(0, 0) == 0
    assert ntp.DEFAULT_SERVERS == jntp.DEFAULT_SERVERS


def test_corrected_epoch_caches_the_offset_and_falls_back():
    ntp.reset_offset_cache()
    try:
        port, t = _serve_sntp_once(server_offset_ns=3_000_000_000)
        servers = [("127.0.0.1", port)]
        first = ntp.corrected_epoch_ns(servers) - time.time_ns()
        t.join(5)
        # the cached offset: no second exchange (the server is gone)
        again = ntp.corrected_epoch_ns(servers) - time.time_ns()
        assert abs(first - 3e9) < 2e8 and abs(again - 3e9) < 2e8
        assert ntp._cache[tuple(servers)] is not ntp._FAILED
        # an unreachable server: the local clock, streaming on
        before = time.time_ns()
        got = ntp.corrected_epoch_ns([("127.0.0.1", 1)], timeout=0.2)
        assert got >= before
        assert ntp._cache[(("127.0.0.1", 1),)] is ntp._FAILED
    finally:
        ntp.reset_offset_cache()


# -- the elements over MQTT ------------------------------------------------------
def test_pipeline_loopback(mqtt_broker):
    """The sink publishes reference-format messages; the src rebuilds
    dtype and shape from the header's caps string."""
    recv = tnt.parse_launch(
        f"tensor_pubsub_src name=src broker=mqtt://127.0.0.1:"
        f"{mqtt_broker.port} sub_topic=nns/t num_buffers=3 ! "
        "tensor_sink name=out")
    outs = []
    recv.get("out").connect(lambda b: outs.append(b))
    recv.start()
    time.sleep(0.3)  # the SUBSCRIBE lands before the first publish
    send = tnt.parse_launch(
        "appsrc name=in ! tensor_pubsub_sink name=snk "
        f"broker=mqtt://127.0.0.1:{mqtt_broker.port} pub_topic=nns/t")
    send.start()
    for k in range(3):
        send.get("in").push([np.full((2, 3), k, np.float32),
                             np.arange(4, dtype=np.int32)])
    send.get("in").end_of_stream()
    try:
        assert recv.wait(timeout=WAIT).kind == "eos"
    finally:
        send.stop()
        recv.stop()
    assert len(outs) == 3
    a0 = np.asarray(outs[0].tensors[0])
    assert a0.dtype == np.float32 and a0.shape == (2, 3)
    np.testing.assert_array_equal(np.asarray(outs[2].tensors[0]),
                                  np.full((2, 3), 2, np.float32))
    np.testing.assert_array_equal(np.asarray(outs[0].tensors[1]),
                                  np.arange(4, dtype=np.int32))


def test_a_reference_peer_can_parse(mqtt_broker):
    """A raw MQTT subscriber (a reference mqttsrc's view) decodes the
    sink's payload with the header layout alone."""
    got = []
    raw = M.MqttClient(port=mqtt_broker.port)
    raw.subscribe("ref/t", lambda t, p: got.append(p))
    send = tnt.parse_launch(
        "appsrc name=in ! tensor_pubsub_sink "
        f"broker=mqtt://127.0.0.1:{mqtt_broker.port} pub_topic=ref/t")
    send.start()
    send.get("in").push([np.arange(6, dtype=np.float32).reshape(2, 3)])
    try:
        assert _wait(lambda: got, 10)
        send.get("in").end_of_stream()
        send.wait(timeout=WAIT)
    finally:
        send.stop()
        raw.close()
    msg = M.parse_gst_mqtt_message(got[0])
    assert len(msg["mems"]) == 1
    np.testing.assert_array_equal(np.frombuffer(msg["mems"][0], np.float32),
                                  np.arange(6))
    assert "other/tensor" in msg["caps_str"]
    assert msg["base_time_epoch"] > 0


def test_rebasing_excludes_delivery_latency(mqtt_broker):
    """pts shift by the base-epoch difference only: a late delivery does
    not change the rebased timestamps."""
    recv = tnt.parse_launch(
        f"tensor_pubsub_src name=src broker=mqtt://127.0.0.1:"
        f"{mqtt_broker.port} sub_topic=lat/t num_buffers=2 ! "
        "tensor_sink name=out")
    src = recv.get("src")
    outs = []
    recv.get("out").connect(lambda b: outs.append(b))
    recv.start()
    time.sleep(0.3)
    sender_base = src._base_epoch + 5_000_000_000  # the sender 5 s ahead
    pub = M.MqttClient(port=mqtt_broker.port)
    try:
        for k, delay in ((0, 0.0), (1, 0.5)):  # the second arrives late
            time.sleep(delay)
            pub.publish("lat/t", M.pack_gst_mqtt_message(
                [np.float32(k).tobytes()], "", sender_base,
                sender_base + k, pts=k * 1000))
        assert recv.wait(timeout=WAIT).kind == "eos"
    finally:
        recv.stop()
        pub.close()
    assert [b.pts for b in outs] == [5_000_000_000, 1000 + 5_000_000_000]


def test_ntp_corrected_base_epochs(mqtt_broker):
    """``ntp-server=`` on both elements: each base epoch carries the
    measured +3 s offset, and the rebased pts are the sender's pts
    shifted by the difference of the two base epochs."""
    ntp.reset_offset_cache()
    port, t = _serve_sntp_once(server_offset_ns=3_000_000_000)
    spec = f"127.0.0.1:{port}"
    try:
        recv = tnt.parse_launch(
            f"tensor_pubsub_src name=src broker=mqtt://127.0.0.1:"
            f"{mqtt_broker.port} sub-topic=n/t num-buffers=4 "
            f"ntp-server={spec} ! tensor_sink name=out")
        local = time.time_ns()
        recv.start()
        time.sleep(0.3)
        send = tnt.parse_launch(
            "appsrc name=in ! tensor_pubsub_sink name=snk "
            f"broker=mqtt://127.0.0.1:{mqtt_broker.port} pub-topic=n/t "
            f"ntp-server={spec}")
        send.start()
        for k in range(4):
            send.get("in").push([np.full((3,), k, np.int16)], pts=k * 7)
        send.get("in").end_of_stream()
        try:
            assert recv.wait(timeout=WAIT).kind == "eos"
        finally:
            send.stop()
            recv.stop()
        t.join(5)
        src_base = recv.get("src")._base_epoch
        sink_base = send.get("snk")._base_epoch
        assert abs(src_base - local - 3e9) < 2e8
        assert ntp._cache[(("127.0.0.1", port),)] is not ntp._FAILED
        assert [b.pts for b in recv.get("out").buffers] == \
            [k * 7 + sink_base - src_base for k in range(4)]
    finally:
        ntp.reset_offset_cache()
