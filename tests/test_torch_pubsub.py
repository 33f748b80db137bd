"""The pub/sub broker, the ``tensor_pubsub_sink``/``src`` elements (with
their ``mqttsink``/``mqttsrc`` aliases) and broker discovery on the query
elements in the PyTorch port, held to the JAX package
(``nnstreamer_tpu/query/pubsub.py``, ``discovery.py``,
``elements/pubsub.py``, ``elements/query.py``).

- The cases of ``tests/test_pubsub.py`` run against the port.
- One package's sink publishes and a src of each package subscribes, over
  the shim broker and over MQTT, each broker from the other package: the
  buffers are bit-identical and each src's pts are the sender's shifted by
  the difference of the two base epochs.
- A port client discovers a JAX server and a JAX client a port server;
  a port client fails over past a ghost ad over MQTT; the tiny flagship
  behind ``operation=`` labels as the JAX package's offload.

Every socket is on 127.0.0.1 and every wait is bounded.
"""

import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.elements.sink import TensorSink as JaxSink
from nnstreamer_tpu.elements.source import AppSrc as JaxAppSrc
from nnstreamer_tpu.filters import register_custom_easy as jax_custom_easy
from nnstreamer_tpu.filters.jax_backend import (
    register_jax_model,
    unregister_jax_model,
)
from nnstreamer_tpu.models.mobilenet_v2 import mobilenet_v2 as jax_mobilenet_v2
from nnstreamer_tpu.query import discovery as jdisco
from nnstreamer_tpu.query import mqtt as JM
from nnstreamer_tpu.query import pubsub as jpubsub
from nnstreamer_tpu_torch.elements.pubsub import (
    TensorPubSubSink,
    TensorPubSubSrc,
)
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.elements.source import AppSrc
from nnstreamer_tpu_torch.filters import register_custom_easy
from nnstreamer_tpu_torch.filters.custom import unregister_custom_easy
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2, params_from_jax
from nnstreamer_tpu_torch.query import discovery
from nnstreamer_tpu_torch.query import mqtt as M
from nnstreamer_tpu_torch.query import protocol as P
from nnstreamer_tpu_torch.query.pubsub import Broker, Client

PKGS = {"port": tnt, "jax": jnt}
WAIT = 30  # seconds: every pipeline wait in this file


@pytest.fixture(autouse=True)
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


@pytest.fixture
def broker():
    b = Broker(port=0).start()
    yield b
    b.stop()


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def _closed_port() -> int:
    probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


# -- the shim broker (tests/test_pubsub.py's cases on the port) ----------------
def test_pub_sub_roundtrip(broker):
    got = []
    sub = Client("127.0.0.1", broker.port)
    sub.subscribe("a/b", lambda t, p: got.append((t, p)))
    time.sleep(0.1)
    pub = Client("127.0.0.1", broker.port)
    pub.publish("a/b", b"hello")
    assert _wait(lambda: got == [("a/b", b"hello")])
    sub.close()
    pub.close()


def test_retained_delivered_to_late_subscriber(broker):
    pub = Client("127.0.0.1", broker.port)
    pub.publish("cfg/x", b"v1", retain=True)
    time.sleep(0.1)
    got = []
    sub = Client("127.0.0.1", broker.port)
    sub.subscribe("cfg/#", lambda t, p: got.append((t, p)))
    assert _wait(lambda: got == [("cfg/x", b"v1")])
    # an empty retained publish deletes the entry
    pub.publish("cfg/x", b"", retain=True)
    time.sleep(0.1)
    late = []
    sub2 = Client("127.0.0.1", broker.port)
    sub2.subscribe("cfg/#", lambda t, p: late.append(t))
    time.sleep(0.2)
    assert late == []
    for c in (sub, sub2, pub):
        c.close()


def test_wildcard(broker):
    got = []
    sub = Client("127.0.0.1", broker.port)
    sub.subscribe("ns/#", lambda t, p: got.append(t))
    time.sleep(0.1)
    pub = Client("127.0.0.1", broker.port)
    pub.publish("ns/one", b"1")
    pub.publish("other/two", b"2")
    pub.publish("ns/three", b"3")
    assert _wait(lambda: len(got) == 2)
    assert got == ["ns/one", "ns/three"]
    sub.close()
    pub.close()


@pytest.mark.parametrize("client,broker_pkg", [("jax", "port"),
                                               ("port", "jax")])
def test_shim_clients_and_brokers_cross_the_packages(client, broker_pkg):
    b = (Broker if broker_pkg == "port" else jpubsub.Broker)(port=0).start()
    cls = jpubsub.Client if client == "jax" else Client
    try:
        got = []
        sub = cls("127.0.0.1", b.port)
        sub.subscribe("x/#", lambda t, p: got.append((t, p)))
        time.sleep(0.1)
        pub = cls("127.0.0.1", b.port)
        payloads = [np.random.default_rng(i).bytes(5000 * i + 3)
                    for i in range(4)]
        for i, p in enumerate(payloads):
            pub.publish(f"x/{i}", p)
        assert _wait(lambda: len(got) == 4)
        assert got == [(f"x/{i}", p) for i, p in enumerate(payloads)]
        sub.close()
        pub.close()
    finally:
        b.stop()


def test_mqtt_alias_names():
    from nnstreamer_tpu_torch.registry import ELEMENT, get_subplugin

    assert get_subplugin(ELEMENT, "mqttsink") is TensorPubSubSink
    assert get_subplugin(ELEMENT, "mqttsrc") is TensorPubSubSrc
    assert get_subplugin(ELEMENT, "tensor_pubsub_sink") is TensorPubSubSink


def test_stream_over_broker(broker):
    recv = tnt.parse_launch(
        f"tensor_pubsub_src host=127.0.0.1 port={broker.port} "
        "sub-topic=t/video num-buffers=3 ! tensor_sink name=out")
    recv.start()
    time.sleep(0.2)  # the subscription lands first
    send = tnt.parse_launch(
        "videotestsrc num-buffers=3 width=8 height=8 ! tensor_converter ! "
        f"tensor_pubsub_sink host=127.0.0.1 port={broker.port} "
        "pub-topic=t/video")
    send.run(timeout=WAIT)
    msg = recv.wait(timeout=WAIT)
    recv.stop()
    assert msg is not None and msg.kind == "eos"
    outs = recv.get("out").buffers
    assert len(outs) == 3
    assert outs[0][0].shape == (1, 8, 8, 3)
    assert outs[0].pts is not None  # rebased timestamps


def test_unreachable_broker_raises_at_start():
    pipe = tnt.parse_launch(
        f"appsrc ! tensor_pubsub_sink port={_closed_port()}")
    with pytest.raises(OSError):
        pipe.start()
    pipe.stop()


# -- one sink, a src of each package ---------------------------------------------
def _frames(seed, n=4):
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal((2, 3)).astype(np.float32),
             rng.integers(0, 256, (1, 4, 4, 3), dtype=np.uint8),
             rng.integers(-9, 9, (5,), dtype=np.int32)]
            for _ in range(n)]


def _subscriber(pkg, spec, n):
    src_cls = TensorPubSubSrc if pkg == "port" else \
        jnt.registry.get_subplugin(jnt.registry.ELEMENT, "tensor_pubsub_src")
    sink_cls = TensorSink if pkg == "port" else JaxSink
    pipe = PKGS[pkg].parse_launch(
        f"{spec} sub-topic=cross/t num-buffers={n} name=src ! "
        "tensor_sink name=out")
    assert isinstance(pipe.get("src"), src_cls)
    assert isinstance(pipe.get("out"), sink_cls)
    pipe.start()
    return pipe


@pytest.mark.parametrize("transport", ["shim", "mqtt"])
@pytest.mark.parametrize("publisher", ["jax", "port"])
def test_streams_cross_the_packages_bit_for_bit(transport, publisher):
    """A ``publisher`` sink and the other package's broker; a port and a
    JAX src on the topic receive the same buffers, bit for bit, each with
    pts rebased by the difference of the base epochs."""
    other = "port" if publisher == "jax" else "jax"
    if transport == "shim":
        b = (Broker if other == "port" else jpubsub.Broker)(port=0).start()
        spec = f"tensor_pubsub_src host=127.0.0.1 port={b.port}"
        sink_spec = f"host=127.0.0.1 port={b.port}"
        close = b.stop
    else:
        b = (M if other == "port" else JM).MqttBroker()
        spec = f"mqttsrc broker=mqtt://127.0.0.1:{b.port}"
        sink_spec = f"broker=mqtt://127.0.0.1:{b.port}"
        close = b.close
    frames = _frames(7)
    pts = [1_000 + 33_000_000 * i for i in range(len(frames))]
    subs = {}
    send = None
    try:
        subs = {pkg: _subscriber(pkg, spec, len(frames))
                for pkg in ("port", "jax")}
        time.sleep(0.3)  # both subscriptions land first
        send = PKGS[publisher].parse_launch(
            f"tensor_pubsub_sink name=snk {sink_spec} pub-topic=cross/t")
        app = (AppSrc if publisher == "port" else JaxAppSrc)(name="in")
        send.add(app)
        app.link(send.get("snk"))
        send.start()
        for f, t in zip(frames, pts):
            app.push(f, pts=t)
        app.end_of_stream()
        for pkg, pipe in subs.items():
            msg = pipe.wait(timeout=WAIT)
            assert msg is not None and msg.kind == "eos", (pkg, msg)
    finally:
        if send is not None:
            send.stop()
        for pipe in subs.values():
            pipe.stop()
        close()
    sink_base = send.get("snk")._base_epoch
    for pkg, pipe in subs.items():
        got = pipe.get("out").buffers
        assert len(got) == len(frames), pkg
        diff = sink_base - pipe.get("src")._base_epoch
        assert [b.pts for b in got] == [t + diff for t in pts], pkg
        for buf, want in zip(got, frames):
            assert len(buf.tensors) == len(want)
            for a, w in zip(buf.tensors, want):
                a = np.asarray(a)
                assert (a.dtype, a.shape) == (w.dtype, w.shape), pkg
                assert a.tobytes() == w.tobytes(), pkg
    port_meta = [b.meta.get("caps_str") for b in subs["port"].get(
        "out").buffers]
    jax_meta = [b.meta.get("caps_str") for b in subs["jax"].get(
        "out").buffers]
    assert port_meta == jax_meta


@pytest.mark.parametrize("transport", ["shim", "mqtt"])
def test_the_port_src_meta_equals_the_jax_src_meta(transport):
    """ROADMAP C.41, closed: a port src and a JAX src on the same topic
    give their buffers the same meta, the sender's send stamp as
    ``dist_sent_wall`` (the distributed trace's hop anchor) included."""
    if transport == "shim":
        b = Broker(port=0).start()
        spec = f"tensor_pubsub_src host=127.0.0.1 port={b.port}"
        close = b.stop
    else:
        b = M.MqttBroker()
        spec = f"mqttsrc broker=mqtt://127.0.0.1:{b.port}"
        close = b.close
    try:
        pipes = {pkg: _subscriber(pkg, spec, 1) for pkg in ("port", "jax")}
        time.sleep(0.3)
        pub = tnt.parse_launch(
            f"appsrc name=a ! tensor_pubsub_sink {spec.split(' ', 1)[1]} "
            "pub-topic=cross/t")
        pub.get("a").push([np.arange(3, dtype=np.int8)], pts=5)
        pub.get("a").end_of_stream()
        try:
            assert pub.run(timeout=WAIT).kind == "eos"
            for pipe in pipes.values():
                assert pipe.wait(timeout=WAIT).kind == "eos"
        finally:
            pub.stop()
            for pipe in pipes.values():
                pipe.stop()
    finally:
        close()
    (port_buf,) = pipes["port"].get("out").buffers
    (jax_buf,) = pipes["jax"].get("out").buffers
    src_keys = {"dist_sent_wall", "caps_str"}
    port_meta = {k: v for k, v in port_buf.meta.items() if k in src_keys}
    jax_meta = {k: v for k, v in jax_buf.meta.items() if k in src_keys}
    assert "dist_sent_wall" in port_meta
    assert port_meta == jax_meta
    assert set(port_buf.meta) == set(jax_buf.meta)


# -- discovery ------------------------------------------------------------------
def test_advertise_and_discover(broker):
    adv = discovery.ServerAdvertiser("127.0.0.1", broker.port, "detect",
                                     "10.0.0.5", 4242)
    adv.publish()
    time.sleep(0.1)
    disco = discovery.ServerDiscovery("127.0.0.1", broker.port, "detect")
    assert ("10.0.0.5", 4242) in disco.wait_servers(timeout=5)
    disco.close()
    adv.retract()


def test_advertise_and_discover_over_real_mqtt():
    b = M.MqttBroker(port=0)
    try:
        adv = discovery.ServerAdvertiser("mqtt://127.0.0.1", b.port, "seg",
                                         "10.0.0.9", 7777)
        adv.publish()
        time.sleep(0.1)
        disco = discovery.ServerDiscovery("mqtt://127.0.0.1", b.port, "seg")
        assert ("10.0.0.9", 7777) in disco.wait_servers(timeout=5)
        adv.retract()  # the tombstone retracts it for new subscribers
        time.sleep(0.1)
        disco2 = discovery.ServerDiscovery("mqtt://127.0.0.1", b.port, "seg")
        assert disco2.wait_servers(timeout=0.5) == []
        disco.close()
        disco2.close()
    finally:
        b.close()


@pytest.mark.parametrize("advertiser,finder,kind", [
    ("port", "jax", "shim"), ("jax", "port", "shim"),
    ("port", "jax", "mqtt"), ("jax", "port", "mqtt")])
def test_ads_cross_the_packages(advertiser, finder, kind):
    """An ad of one package is found by the other's discovery, with the
    same payload fields."""
    amod = discovery if advertiser == "port" else jdisco
    fmod = discovery if finder == "port" else jdisco
    if kind == "shim":
        b = Broker(port=0).start()
        host, close = "127.0.0.1", b.stop
    else:
        b = JM.MqttBroker(port=0)
        host, close = "mqtt://127.0.0.1", b.close
    try:
        adv = amod.ServerAdvertiser(host, b.port, "op", "10.1.2.3", 5151,
                                    metrics_port=9100)
        adv.publish()
        disco = fmod.ServerDiscovery(host, b.port, "op")
        assert disco.wait_servers(timeout=5) == [("10.1.2.3", 5151)]
        assert disco.metrics_endpoints() == [("10.1.2.3", 9100)]
        assert disco.load("10.1.2.3", 5151) is None
        adv.retract()
        assert _wait(lambda: disco.servers_now() == [])
        disco.close()
    finally:
        close()


def _double_model(pkg, name):
    info = (tnt if pkg == "port" else jnt).TensorsInfo.from_str("4", "float32")
    fn = (register_custom_easy if pkg == "port" else jax_custom_easy)
    fn(name, lambda ins: [np.asarray(ins[0]) * 3], info, info)


def _discovering_client(pkg, broker_host, broker_port, frames, extra=""):
    src_cls, sink_cls = (AppSrc, TensorSink) if pkg == "port" else \
        (JaxAppSrc, JaxSink)
    client = PKGS[pkg].parse_launch(
        f"tensor_query_client name=c operation=triple "
        f"broker-host={broker_host} broker-port={broker_port} timeout=5 "
        f"{extra}")
    src, sink = src_cls(name="src"), sink_cls(name="out")
    client.add(src, sink)
    src.link(client.get("c"))
    client.get("c").link(sink)
    client.start()
    try:
        for i, f in enumerate(frames):
            src.push([f], pts=i)
        src.end_of_stream()
        msg = client.wait(timeout=WAIT)
        assert msg is not None and msg.kind == "eos", str(msg)
        return list(sink.buffers)
    finally:
        client.stop()


@pytest.mark.parametrize("client_pkg,server_pkg,kind", [
    ("port", "jax", "shim"), ("jax", "port", "shim"),
    ("port", "jax", "mqtt"), ("jax", "port", "mqtt"),
    ("port", "port", "shim")])
def test_query_client_discovers_a_server(client_pkg, server_pkg, kind):
    _double_model(server_pkg, "ps_triple")
    if kind == "shim":
        b = Broker(port=0).start()
        host, close = "127.0.0.1", b.stop
    else:
        b = M.MqttBroker(port=0)
        host, close = "mqtt://127.0.0.1", b.close
    server = PKGS[server_pkg].parse_launch(
        "tensor_query_serversrc name=s port=0 operation=triple "
        f"broker-host={host} broker-port={b.port} ! "
        "tensor_filter framework=custom-easy model=ps_triple ! "
        "tensor_query_serversink")
    frames = [np.arange(4, dtype=np.float32) + i for i in range(3)]
    try:
        server.start()
        got = _discovering_client(client_pkg, host, b.port, frames)
        # the ad leaves with the server
        server.stop()
        disco = discovery.ServerDiscovery(host, b.port, "triple")
        assert disco.wait_servers(timeout=0.5) == []
        disco.close()
    finally:
        server.stop()
        close()
        if server_pkg == "port":
            unregister_custom_easy("ps_triple")
    assert [b.pts for b in got] == [0, 1, 2]
    for buf, f in zip(got, frames):
        assert np.asarray(buf[0]).tobytes() == (f * 3).tobytes()


def test_client_fails_over_past_a_ghost_ad_over_mqtt():
    """A ghost ad names a closed port; the port's client walks past it to
    the live server it found through the same MQTT broker."""
    _double_model("port", "ps_triple")
    b = M.MqttBroker(port=0)
    ghost = server = None
    try:
        ghost = discovery.ServerAdvertiser("mqtt://127.0.0.1", b.port,
                                           "triple", "127.0.0.1",
                                           _closed_port())
        ghost.publish()
        server = tnt.parse_launch(
            "tensor_query_serversrc name=s port=0 operation=triple "
            f"broker-host=mqtt://127.0.0.1 broker-port={b.port} ! "
            "tensor_filter framework=custom-easy model=ps_triple ! "
            "tensor_query_serversink")
        server.start()
        disco = discovery.ServerDiscovery("mqtt://127.0.0.1", b.port,
                                          "triple")
        assert len(disco.wait_servers(timeout=5)) == 2
        disco.close()
        frames = [np.arange(4, dtype=np.float32)]
        got = _discovering_client("port", "mqtt://127.0.0.1", b.port,
                                  frames, "max-retry=2")
        assert np.asarray(got[0][0]).tobytes() == (frames[0] * 3).tobytes()
    finally:
        if ghost is not None:
            ghost.retract()
        if server is not None:
            server.stop()
        b.close()
        unregister_custom_easy("ps_triple")


def test_no_advertised_server_raises():
    b = Broker(port=0).start()
    client = tnt.parse_launch(
        f"appsrc name=src ! tensor_query_client operation=nobody "
        f"broker-port={b.port} timeout=0.3 ! tensor_sink")
    client.start()
    try:
        client.get("src").push([np.zeros(2, np.float32)])
        msg = client.wait(timeout=WAIT)
        assert msg is not None and msg.kind == "error"
        assert "no servers advertise operation 'nobody'" in str(msg.error)
    finally:
        client.stop()
        b.stop()


def test_serversrc_with_an_unreachable_broker_raises_at_start():
    server = tnt.parse_launch(
        "tensor_query_serversrc port=0 operation=x "
        f"broker-port={_closed_port()} ! tensor_query_serversink")
    with pytest.raises(OSError):
        server.start()
    server.stop()


# -- the tiny flagship behind operation= ----------------------------------------
SIZE, CLASSES, FRAMES = 32, 10, 4


def _discovered_offload_labels(pkg, labels, model, broker_port, extra=""):
    server = PKGS[pkg].parse_launch(
        "tensor_query_serversrc name=ss port=0 id=71 operation=classify "
        f"broker-port={broker_port} ! tensor_quant_dec ! "
        f"tensor_filter framework=jax model={model} {extra}! "
        f"tensor_decoder mode=image_labeling option1={labels} ! "
        "tensor_query_serversink id=71")
    server.start()
    try:
        client = PKGS[pkg].parse_launch(
            f"videotestsrc num-buffers={FRAMES} width={SIZE} height={SIZE} "
            "pattern=ball ! tensor_converter ! tensor_transform "
            "mode=arithmetic option=typecast:float32,add:-127.5,div:127.5 ! "
            "tensor_quant_enc ! tensor_query_client operation=classify "
            f"broker-port={broker_port} timeout=30 ! tensor_sink name=out")
        out = []
        client.get("out").connect(lambda buf: out.append(
            np.asarray(buf.to_host()[0]).tobytes().decode()))
        msg = client.run(timeout=WAIT)
        assert msg is not None and msg.kind == "eos", msg
    finally:
        server.stop()
    return out


def test_tiny_flagship_behind_operation_matches_jax(tmp_path, broker):
    labels = tmp_path / "labels.txt"
    labels.write_text("".join(f"label_{i}\n" for i in range(CLASSES)))
    apply_fn, variables, in_info, out_info = jax_mobilenet_v2(
        num_classes=CLASSES, image_size=SIZE, dtype=jnp.float32, seed=5)
    module = MobileNetV2(num_classes=CLASSES)
    module.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                        variables)))
    register_jax_model("ps_mnv2", apply_fn, variables, in_info=in_info,
                       out_info=out_info)
    register_torch_model(
        "ps_mnv2", module.eval(),
        tnt.TensorsInfo.from_str(f"3:{SIZE}:{SIZE}:1", "float32"),
        tnt.TensorsInfo.from_str(f"{CLASSES}:1", "float32"))
    try:
        want = _discovered_offload_labels("jax", str(labels), "ps_mnv2",
                                          broker.port)
        got = _discovered_offload_labels("port", str(labels), "ps_mnv2",
                                         broker.port, "accelerator=true:cpu ")
    finally:
        unregister_jax_model("ps_mnv2")
        unregister_torch_model("ps_mnv2")
    assert len(got) == len(want) == FRAMES
    assert got == want
    assert all(s.startswith("label_") for s in got)
