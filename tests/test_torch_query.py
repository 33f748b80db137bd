"""The query transport in the PyTorch port: wire protocol, server core and
the tensor_query_client / serversrc / serversink elements, held to the JAX
package (``nnstreamer_tpu/query``, ``nnstreamer_tpu/elements/query.py``).

Frames are byte-identical between the packages; a port client works
against a JAX server and a JAX client against a port server; the tiny
flagship offloaded with int8 transport gives the JAX package's labels.
Every socket is on 127.0.0.1 with ``port=0``, and every wait is bounded.
"""

import socket
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.elements.sink import TensorSink as JaxSink
from nnstreamer_tpu.elements.source import AppSrc as JaxAppSrc
from nnstreamer_tpu.filters import register_custom_easy
from nnstreamer_tpu.filters.jax_backend import (
    register_jax_model,
    unregister_jax_model,
)
from nnstreamer_tpu.models.mobilenet_v2 import mobilenet_v2 as jax_mobilenet_v2
from nnstreamer_tpu.query import protocol as JP
from nnstreamer_tpu.tensors.buffer import TensorBuffer as JaxBuffer
from nnstreamer_tpu_torch.elements.query import (
    TensorQueryClient,
    TensorQueryServerSink,
    TensorQueryServerSrc,
)
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.elements.source import AppSrc
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2, params_from_jax
from nnstreamer_tpu_torch.pipeline.element import FlowError
from nnstreamer_tpu_torch.query import protocol as P
from nnstreamer_tpu_torch.query.server import QueryServer
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

PKGS = {"port": tnt, "jax": jnt}
WAIT = 60  # seconds: every pipeline wait in this file


@pytest.fixture(autouse=True)
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


def _frame_tensors(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, 3)).astype(np.float32),
            np.arange(5, dtype=np.uint8),
            rng.integers(-9, 9, (4,), dtype=np.int32),
            rng.standard_normal((3,)).astype(np.float16)]


# -- wire protocol -------------------------------------------------------------
def test_buffer_frames_are_byte_identical_to_jax():
    tensors = _frame_tensors(1)
    ours = P.pack_buffer(TensorBuffer(tensors, pts=123, duration=456))
    theirs = JP.pack_buffer(JaxBuffer(tensors, pts=123, duration=456))
    assert ours == theirs
    back = P.unpack_buffer(theirs)
    assert back.pts == 123 and back.duration == 456 and back.dts is None
    for a, b in zip(back.tensors, tensors):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_unset_timestamps_and_bfloat16():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = torch.from_numpy(x).to(torch.bfloat16)
    ours = P.pack_buffer(TensorBuffer([t]))
    assert ours == JP.pack_buffer(JaxBuffer([x.astype(ml_dtypes.bfloat16)]))
    back = P.unpack_buffer(ours)
    assert back.pts is None and back.dts is None and back.duration is None
    assert back[0].dtype == torch.bfloat16 and torch.equal(back[0], t)


@pytest.mark.parametrize("cmd", list(range(9, 15)))
def test_resilient_commands_cross_between_packages(cmd):
    """Commands 9-14 (the resilient transport and its trace extension)
    carry the JAX package's ids and frame bytes in both directions."""
    assert P.Cmd(cmd).name == JP.Cmd(cmd).name
    a, b = socket.socketpair()
    try:
        b.settimeout(10)
        a.settimeout(10)
        P.send_msg(a, P.Cmd(cmd), b"x" * cmd)
        got = JP.recv_msg(b)
        assert (int(got[0]), got[1]) == (cmd, b"x" * cmd)
        JP.send_msg(b, JP.Cmd(cmd), b"y")
        assert P.recv_msg(a) == (P.Cmd(cmd), b"y")
    finally:
        a.close()
        b.close()


# -- server core ---------------------------------------------------------------
@pytest.fixture
def server():
    srv = QueryServer(host="127.0.0.1", port=0)
    srv.start()
    yield srv
    srv.stop()


def _handshake(port):
    sock = P.connect("127.0.0.1", port, timeout=10)
    P.send_msg(sock, P.Cmd.REQUEST_INFO, b"caps")
    cmd, payload = P.recv_msg(sock)
    assert cmd is P.Cmd.APPROVE and payload == b""
    cmd, payload = P.recv_msg(sock)
    assert cmd is P.Cmd.CLIENT_ID
    return sock, int(payload.decode())


def test_server_handshake_transfer_result(server):
    sock, cid = _handshake(server.port)
    buf = TensorBuffer(_frame_tensors(2), pts=7)
    P.send_buffer(sock, buf)
    got = server.get_buffer(timeout=10)
    assert got is not None and got.meta["query_client_id"] == cid
    assert server.send_result(cid, got)
    cmd, payload = P.recv_msg(sock)
    assert cmd is P.Cmd.RESULT and payload == P.pack_buffer(buf)
    sock.close()


def test_server_ping_bye_and_routing(server):
    socks = {}
    for _ in range(4):
        sock, cid = _handshake(server.port)
        socks[cid] = sock
    for cid, sock in socks.items():
        P.send_buffer(sock, TensorBuffer([np.full((2,), cid, np.int32)]))
    for _ in socks:
        got = server.get_buffer(timeout=10)
        assert int(got[0][0]) == got.meta["query_client_id"]
        assert server.send_result(got.meta["query_client_id"], got)
    for cid, sock in socks.items():
        cmd, payload = P.recv_msg(sock)
        assert cmd is P.Cmd.RESULT
        assert int(P.unpack_buffer(payload)[0][0]) == cid
        P.send_msg(sock, P.Cmd.PING)
        assert P.recv_msg(sock)[0] is P.Cmd.PING
        P.send_msg(sock, P.Cmd.BYE)
        sock.close()
    deadline = time.monotonic() + 5
    while any(server.send_result(cid, TensorBuffer([np.zeros(1)]))
              for cid in socks):
        assert time.monotonic() < deadline, "BYE never processed"
        time.sleep(0.02)


def test_server_bad_frame_disconnects_client(server):
    sock, _ = _handshake(server.port)
    P.send_msg(sock, P.Cmd.TRANSFER, b"\x01garbage-not-a-buffer")
    assert server.get_buffer(timeout=1) is None
    sock.settimeout(5)
    with pytest.raises((P.QueryProtocolError, OSError)):
        while True:
            P.recv_msg(sock)
    sock.close()


def test_server_stop_unblocks_a_waiting_consumer(server):
    results = []
    t = threading.Thread(target=lambda: results.append(
        server.get_buffer(timeout=30)))
    t.start()
    time.sleep(0.2)
    server.stop()
    t.join(timeout=10)
    assert not t.is_alive() and results == [None]


# -- the two packages against each other ---------------------------------------
def _server(pkg, desc):
    pipe = PKGS[pkg].parse_launch(desc)
    pipe.start()
    return pipe, pipe.get("ss").port


def _client_results(pkg, port, frames, window=1):
    """An appsrc ! tensor_query_client ! tensor_sink pipeline of ``pkg``
    pushing ``frames``; returns the result buffers."""
    src_cls, sink_cls = (AppSrc, TensorSink) if pkg == "port" else \
        (JaxAppSrc, JaxSink)
    client = PKGS[pkg].parse_launch(
        f"tensor_query_client name=qc dest-host=127.0.0.1 dest-port={port} "
        f"timeout=10 max-in-flight={window}")
    src, sink = src_cls(name="src"), sink_cls(name="out")
    client.add(src, sink)
    src.link(client.get("qc"))
    client.get("qc").link(sink)
    client.start()
    try:
        for i, tensors in enumerate(frames):
            src.push(tensors, pts=i)
        src.end_of_stream()
        msg = client.wait(timeout=WAIT)
        assert msg is not None and msg.kind == "eos", msg
        return list(sink.buffers), client.get("qc")
    finally:
        client.stop()


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("port", "jax"), ("jax", "port"),
                          ("port", "port"), ("jax", "jax")])
def test_echo_payloads_cross_the_packages_intact(client_pkg, server_pkg):
    pipe, port = _server(server_pkg, "tensor_query_serversrc name=ss port=0 "
                                     "id=51 ! tensor_query_serversink id=51")
    frames = [_frame_tensors(s) for s in range(3)]
    try:
        got, _ = _client_results(client_pkg, port, frames)
    finally:
        pipe.stop()
    assert [b.pts for b in got] == [0, 1, 2]
    for buf, want in zip(got, frames):
        assert len(buf.tensors) == len(want)
        for a, b in zip(buf.tensors, want):
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


class _Double(torch.nn.Module):
    def forward(self, x):
        return x * 2.0


@pytest.fixture
def doublers():
    info = tnt.TensorsInfo.from_str("4:2", "float32")
    register_torch_model("q_double", _Double(), info, info)
    register_custom_easy("q_double", lambda ins: [np.asarray(ins[0]) * 2.0],
                         jnt.TensorsInfo.from_str("4:2", "float32"),
                         jnt.TensorsInfo.from_str("4:2", "float32"))
    yield
    unregister_torch_model("q_double")


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("port", "jax"), ("jax", "port")])
def test_filter_results_match_across_the_packages(doublers, client_pkg,
                                                  server_pkg):
    fw = "torch" if server_pkg == "port" else "custom-easy"
    pipe, port = _server(
        server_pkg, "tensor_query_serversrc name=ss port=0 id=52 ! "
        f"tensor_filter framework={fw} model=q_double ! "
        "tensor_query_serversink id=52")
    rng = np.random.default_rng(9)
    frames = [[rng.standard_normal((2, 4)).astype(np.float32)]
              for _ in range(4)]
    try:
        got, _ = _client_results(client_pkg, port, frames)
    finally:
        pipe.stop()
    assert len(got) == 4
    for buf, (x,) in zip(got, frames):
        assert np.asarray(buf[0]).tobytes() == (x * 2.0).tobytes()


def test_pipelined_client_keeps_order():
    pipe, port = _server("port", "tensor_query_serversrc name=ss port=0 "
                                 "id=53 ! tensor_query_serversink id=53")
    frames = [[np.full((3,), i, np.int32)] for i in range(20)]
    try:
        got, qc = _client_results("port", port, frames, window=4)
        sync, _ = _client_results("port", port, frames, window=1)
    finally:
        pipe.stop()
    assert [b.pts for b in got] == list(range(20))
    assert [int(np.asarray(b[0])[0]) for b in got] == list(range(20))
    assert [np.asarray(b[0]).tobytes() for b in got] == \
        [np.asarray(b[0]).tobytes() for b in sync]
    assert qc.get_property("frames-dropped") == 0
    with pytest.raises(ValueError, match="read-only"):
        qc.set_property("frames-dropped", 3)


def test_client_fails_over_to_a_live_server():
    pipe, port = _server("port", "tensor_query_serversrc name=ss port=0 "
                                 "id=54 ! tensor_query_serversink id=54")
    client = tnt.parse_launch(
        f"tensor_query_client name=c servers=127.0.0.1:1,127.0.0.1:{port} "
        "timeout=2")
    src, sink = AppSrc(name="src"), TensorSink(name="out")
    client.add(src, sink)
    src.link(client.get("c"))
    client.get("c").link(sink)
    try:
        client.start()
        src.push([np.arange(4, dtype=np.float32)], pts=0)
        src.end_of_stream()
        msg = client.wait(timeout=WAIT)
        assert msg is not None and msg.kind == "eos", msg
        np.testing.assert_array_equal(sink.buffers[0][0],
                                      np.arange(4, dtype=np.float32))
    finally:
        client.stop()
        pipe.stop()


def test_client_with_every_server_down_errors():
    client = tnt.parse_launch("appsrc name=src ! tensor_query_client "
                              "servers=127.0.0.1:1 timeout=0.3 max-retry=1 "
                              "! tensor_sink")
    client.start()
    try:
        client.get("src").push([np.zeros(2, np.float32)])
        msg = client.wait(timeout=WAIT)
        assert msg is not None and msg.kind == "error"
        assert "unreachable" in str(msg.error)
    finally:
        client.stop()


#: the resilient transport's and the fleet's properties, ported with them
#: (ROADMAP 26a, 26b): (element, property, a value, the value it reads as)
RESILIENCE_PROPS = [
    (TensorQueryClient, "reliable", "true", True),
    (TensorQueryClient, "propagate-deadline", "true", True),
    (TensorQueryClient, "breaker-failures", "3", 3),
    (TensorQueryClient, "breaker-reset-ms", "10", 10.0),
    (TensorQueryClient, "hedge-ms", "5", 5.0),
    (TensorQueryClient, "reconnect-backoff-ms", "9", 9.0),
    (TensorQueryClient, "balance", "shortest-slack", "shortest-slack"),
    (TensorQueryClient, "discovery-stale-s", "2", 2.0),
    (TensorQueryServerSrc, "reliable", "true", True),
    (TensorQueryServerSrc, "metrics-port", "9090", 9090),
    (TensorQueryServerSrc, "advertise-interval-s", "1", 1.0),
]

#: the reference wire's properties, ported with it (ROADMAP 26d)
REFWIRE_PROPS = [
    (TensorQueryClient, "wire", "nnstreamer"),
    (TensorQueryClient, "sink-port", 3001),
    (TensorQueryServerSrc, "wire", "nnstreamer"),
    (TensorQueryServerSrc, "caps", "other/tensors"),
]


#: broker discovery's properties, ported with it (ROADMAP 26c)
DISCOVERY_PROPS = [
    (TensorQueryClient, "operation", "detect"),
    (TensorQueryClient, "broker-host", "10.0.0.1"),
    (TensorQueryClient, "broker-port", 1884),
    (TensorQueryServerSrc, "operation", "detect"),
    (TensorQueryServerSrc, "broker-port", 1884),
    (TensorQueryServerSrc, "broker-host", "10.0.0.1"),
    (TensorQueryServerSrc, "advertise-host", "10.0.0.2"),
]


@pytest.mark.parametrize("cls,prop,value,want", RESILIENCE_PROPS,
                         ids=[f"{c.ELEMENT_NAME}-{p}" for c, p, _, _ in
                              RESILIENCE_PROPS])
def test_resilience_properties_are_settable(cls, prop, value, want):
    """Each property parses from a launch string's text as the JAX
    element parses it, and defaults to the JAX element's default."""
    from nnstreamer_tpu.registry import ELEMENT as JELEMENT
    from nnstreamer_tpu.registry import get_subplugin as jget

    jcls = jget(JELEMENT, cls.ELEMENT_NAME)
    el, jel = cls(**{prop: value}), jcls(**{prop: value})
    assert el.get_property(prop) == jel.get_property(prop) == want
    key = prop.replace("-", "_")
    assert cls.PROPERTIES[key] == jcls.PROPERTIES[key]


@pytest.mark.parametrize("cls,prop,value", REFWIRE_PROPS,
                         ids=[f"{c.ELEMENT_NAME}-{p}" for c, p, _ in
                              REFWIRE_PROPS])
def test_reference_wire_properties_are_settable(cls, prop, value):
    el = cls(**{prop: value})
    assert el.get_property(prop) == value


@pytest.mark.parametrize("cls,prop,value", DISCOVERY_PROPS,
                         ids=[f"{c.ELEMENT_NAME}-{p}" for c, p, _ in
                              DISCOVERY_PROPS])
def test_discovery_properties_are_settable(cls, prop, value):
    el = cls(**{prop: value})
    assert el.get_property(prop) == value


def test_serversink_needs_the_client_id_and_a_paired_source():
    pipe, _ = _server("port", "tensor_query_serversrc name=ss port=0 id=55 "
                              "! tensor_query_serversink id=55")
    try:
        sink = TensorQueryServerSink(id=55)
        with pytest.raises(FlowError, match="query_client_id"):
            sink._chain_entry(sink.sinkpad,
                              TensorBuffer([np.zeros(1, np.float32)]))
        lonely = TensorQueryServerSink(id=56)
        with pytest.raises(FlowError, match="paired serversrc"):
            lonely._chain_entry(lonely.sinkpad, TensorBuffer(
                [np.zeros(1)], meta={"query_client_id": 1}))
    finally:
        pipe.stop()


# -- the tiny flagship offloaded with int8 transport ---------------------------
SIZE, CLASSES, FRAMES = 32, 10, 4


def _offload_labels(pkg, labels, model, extra=""):
    server, port = _server(
        pkg, "tensor_query_serversrc name=ss port=0 id=57 ! "
        f"tensor_quant_dec ! tensor_filter framework=jax model={model} "
        f"{extra}! tensor_decoder mode=image_labeling option1={labels} ! "
        "tensor_query_serversink id=57")
    try:
        client = PKGS[pkg].parse_launch(
            f"videotestsrc num-buffers={FRAMES} width={SIZE} height={SIZE} "
            "pattern=ball ! tensor_converter ! tensor_transform "
            "mode=arithmetic option=typecast:float32,add:-127.5,div:127.5 ! "
            "tensor_quant_enc ! tensor_query_client dest-host=127.0.0.1 "
            f"dest-port={port} timeout=30 ! tensor_sink name=out")
        out = []
        client.get("out").connect(lambda buf: out.append(
            np.asarray(buf.to_host()[0]).tobytes().decode()))
        msg = client.run(timeout=WAIT)
        assert msg is not None and msg.kind == "eos", msg
    finally:
        server.stop()
    return out


def test_tiny_flagship_offload_matches_jax(tmp_path):
    labels = tmp_path / "labels.txt"
    labels.write_text("".join(f"label_{i}\n" for i in range(CLASSES)))
    apply_fn, variables, in_info, out_info = jax_mobilenet_v2(
        num_classes=CLASSES, image_size=SIZE, dtype=jnp.float32, seed=5)
    module = MobileNetV2(num_classes=CLASSES)
    module.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                        variables)))
    register_jax_model("q_mnv2", apply_fn, variables, in_info=in_info,
                       out_info=out_info)
    register_torch_model(
        "q_mnv2", module.eval(),
        tnt.TensorsInfo.from_str(f"3:{SIZE}:{SIZE}:1", "float32"),
        tnt.TensorsInfo.from_str(f"{CLASSES}:1", "float32"))
    try:
        want = _offload_labels("jax", str(labels), "q_mnv2")
        got = _offload_labels("port", str(labels), "q_mnv2",
                              "accelerator=true:cpu ")
    finally:
        unregister_jax_model("q_mnv2")
        unregister_torch_model("q_mnv2")
    assert len(got) == len(want) == FRAMES
    assert got == want
    assert all(s.startswith("label_") for s in got)
