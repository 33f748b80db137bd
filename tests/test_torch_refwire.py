"""The port's reference wire (``query/refwire.py``, ``tensor_query_client
wire=nnstreamer``, ``tensor_query_serversrc wire=nnstreamer caps=...``)
held to the JAX package's over 127.0.0.1.

- The ctypes oracle of ``tests/test_refwire.py``: every offset, size and
  padding hole of ``TensorQueryDataInfo`` against the port's struct codec.
- The frames of one buffer are byte-identical from both packages.
- A hand-framed reference client (``tests/test_refwire.py``'s raw-struct
  helpers) offloads through the port's server; a port client offloads to
  the JAX package's pure-Python server and a JAX client to the port's.
- The reference's admission test: incompatible caps are DENYed.
- Two deliberate differences from the JAX module (ROADMAP C.36, C.37): a
  data info announcing 17 memories raises ``RefWireError``, and the client
  announces only fixated caps.
- The offload pipeline with a port model returns what the JAX pipeline
  with ``refwire_triple`` returns.

The JAX servers run with ``NNSTPU_PURE_PY_SERVER=1``: the JAX package's
native reference-wire core approves every client, while the port keeps its
reference wire on Python, native library or not (ROADMAP C.50,
``tests/test_torch_native.py``).
"""

import ctypes
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.query import refwire as JR
from nnstreamer_tpu_torch.query import refwire as R
from nnstreamer_tpu_torch.query.server import QueryServer
from tests.test_refwire import (
    CAPS,
    RefDataInfo,
    _reference_client_roundtrip,
    _serve_double,
)


@pytest.fixture
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


@pytest.fixture
def pure_py(monkeypatch):
    monkeypatch.setenv("NNSTPU_PURE_PY_SERVER", "1")


class TestCtypesOracle:
    def test_data_info_layout_matches_compiler(self):
        assert ctypes.sizeof(RefDataInfo) == R.DATA_INFO_SIZE == 176
        assert RefDataInfo.num_mems.offset == 40
        assert RefDataInfo.mem_sizes.offset == 48

    def test_data_info_bytes_identical_to_ctypes(self):
        c = RefDataInfo(base_time=123456789, sent_time=-42,
                        duration=R.CLOCK_NONE, dts=R.CLOCK_NONE,
                        pts=777, num_mems=2)
        c.mem_sizes[0] = 48
        c.mem_sizes[1] = 1024
        ours = R.pack_data_info(2, [48, 1024], pts=777, dts=None,
                                duration=None, base_time=123456789,
                                sent_time=-42)
        assert ours == bytes(c)
        assert ours == JR.pack_data_info(2, [48, 1024], pts=777, dts=None,
                                         duration=None, base_time=123456789,
                                         sent_time=-42)

    def test_data_info_unpack_from_ctypes_bytes(self):
        c = RefDataInfo(base_time=1, sent_time=2, duration=3, dts=4,
                        pts=5, num_mems=1)
        c.mem_sizes[0] = 99
        info = R.unpack_data_info(bytes(c))
        assert info == dict(base_time=1, sent_time=2, duration=3, dts=4,
                            pts=5, num_mems=1, mem_sizes=[99])
        assert info == JR.unpack_data_info(bytes(c))

    def test_client_id_is_int64(self):
        assert R._CLIENT_ID.size == ctypes.sizeof(ctypes.c_int64)

    def test_cmd_is_c_enum_int(self):
        assert R._CMD.size == ctypes.sizeof(ctypes.c_int)


def test_seventeen_memories_raise_refwire_error():
    """ROADMAP C.36 (deliberate): the JAX ``unpack_data_info`` accepts
    ``num_mems`` > 16 and a later index raises ``IndexError``; the port
    refuses the header, as the C parser does."""
    c = RefDataInfo(base_time=0, sent_time=0, duration=R.CLOCK_NONE,
                    dts=R.CLOCK_NONE, pts=0, num_mems=17)
    with pytest.raises(R.RefWireError, match="17 memories"):
        R.unpack_data_info(bytes(c))
    assert issubclass(R.RefWireError, tnt.query.protocol.QueryProtocolError)
    assert len(JR.unpack_data_info(bytes(c))["mem_sizes"]) == 16


@pytest.mark.parametrize("mems,pts", [
    ([np.arange(12, dtype=np.float32).tobytes()], 31337),
    ([b"\x01\x02\x03", b"", np.ones(5, np.int64).tobytes()], None),
], ids=["one", "three"])
def test_frames_byte_identical_to_jax(monkeypatch, mems, pts):
    monkeypatch.setattr(time, "monotonic_ns", lambda: 123_456_789_000)
    assert R.pack_buffer_frames(mems, pts=pts) == \
        JR.pack_buffer_frames(mems, pts=pts)


def test_buffer_to_mems_matches_jax_and_carries_bfloat16():
    arrays = [np.arange(6, dtype=np.int16).reshape(2, 3),
              np.linspace(0, 1, 4, dtype=np.float32)]
    ours = R.buffer_to_mems(tnt.TensorBuffer(arrays))
    assert ours == JR.buffer_to_mems(jnt.TensorBuffer(arrays))
    bf = torch.arange(4, dtype=torch.float32).to(torch.bfloat16)
    (raw,) = R.buffer_to_mems(tnt.TensorBuffer([bf]))
    cfg = tnt.TensorsConfig.from_arrays([bf])
    back = R.mems_to_buffer([raw], cfg)
    assert torch.equal(back.tensors[0], bf)


def _serve_triple(server, n):
    for _ in range(n):
        buf = server.get_buffer(timeout=10)
        assert buf is not None
        server.send_result(buf.meta["query_client_id"], buf.with_tensors(
            [np.asarray(t) * 3 for t in buf.tensors]))


def test_reference_client_roundtrip_through_the_port_server():
    """``tests/test_refwire.py``'s hand-framed reference client against
    the port's server: the caps echo, the doubled tensor, typed from the
    configured caps, and the pts."""
    server = QueryServer(host="127.0.0.1", port=0, caps_str=CAPS,
                         wire="nnstreamer").start()
    seen = []
    try:
        def grab():
            buf = server.get_buffer(timeout=10)
            seen.append(buf)
            server.send_result(buf.meta["query_client_id"], buf.with_tensors(
                [np.asarray(t) * 2 for t in buf.tensors]))

        t = threading.Thread(target=grab, daemon=True)
        t.start()
        x = np.arange(12, dtype=np.float32).reshape(3, 4)
        _, server_caps, rinfo, mems = _reference_client_roundtrip(
            server.port, server.sink_port, x.tobytes())
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        server.stop()
    assert server_caps == CAPS
    got = np.frombuffer(mems[0], np.float32).reshape(3, 4)
    np.testing.assert_array_equal(got, x * 2)
    assert seen[0].tensors[0].shape == (3, 4)
    assert seen[0].tensors[0].dtype == np.float32
    assert seen[0].pts == 31337
    assert rinfo["pts"] == 31337


def test_port_client_against_the_jax_server(pure_py):
    from nnstreamer_tpu.query.server import QueryServer as JQueryServer

    server = JQueryServer(host="127.0.0.1", port=0, caps_str=CAPS,
                          wire="nnstreamer").start()
    assert not server.native
    try:
        t = threading.Thread(target=_serve_double, args=(server, 3),
                             daemon=True)
        t.start()
        client = R.RefWireClient("127.0.0.1", server.port,
                                 sink_port=server.sink_port, in_caps=CAPS)
        try:
            assert client.server_caps == CAPS
            # the JAX server drops a result whose sink connection its
            # accept thread has not taken yet (ROADMAP C.39): wait for it
            deadline = time.monotonic() + 5
            while client.client_id not in server._refwire._sinks:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            for i in range(3):
                x = np.full((3, 4), i, np.float32)
                client.send([x.tobytes()], pts=100 + i)
                info, mems = client.recv_result()
                assert info["pts"] == 100 + i
                np.testing.assert_array_equal(
                    np.frombuffer(mems[0], np.float32).reshape(3, 4), x * 2)
        finally:
            client.close()
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        server.stop()


def test_jax_client_against_the_port_server():
    server = QueryServer(host="127.0.0.1", port=0, caps_str=CAPS,
                         wire="nnstreamer").start()
    try:
        t = threading.Thread(target=_serve_triple, args=(server, 3),
                             daemon=True)
        t.start()
        client = JR.RefWireClient("127.0.0.1", server.port,
                                  sink_port=server.sink_port, in_caps=CAPS)
        try:
            assert client.server_caps == CAPS
            for i in range(3):
                x = np.full((3, 4), i + 1, np.float32)
                client.send([x.tobytes()], pts=7 + i)
                info, mems = client.recv_result()
                assert info["pts"] == 7 + i
                np.testing.assert_array_equal(
                    np.frombuffer(mems[0], np.float32).reshape(3, 4), x * 3)
        finally:
            client.close()
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        server.stop()


@pytest.mark.parametrize("side", ["port", "jax"])
def test_server_denies_incompatible_caps(side, pure_py):
    """The reference's admission test on both packages' pure-Python
    servers, asked by the port's client: DENY for tensor caps that neither
    config-equal nor intersect, and for other media; APPROVE for the same
    caps and for an empty announcement."""
    if side == "port":
        server = QueryServer(host="127.0.0.1", port=0, caps_str=CAPS,
                             wire="nnstreamer").start()
    else:
        from nnstreamer_tpu.query.server import QueryServer as JQueryServer

        server = JQueryServer(host="127.0.0.1", port=0, caps_str=CAPS,
                              wire="nnstreamer").start()
    try:
        bad = ("other/tensors,format=static,num_tensors=1,"
               "dimensions=8:8,types=uint8")
        for caps in (bad, "video/x-raw,width=8,height=8"):
            with pytest.raises(R.RefWireError, match="denied") as err:
                R.RefWireClient("127.0.0.1", server.port,
                                sink_port=server.sink_port, in_caps=caps)
            assert CAPS in str(err.value)  # DENY carries the server caps
        for caps in (CAPS, ""):
            ok = R.RefWireClient("127.0.0.1", server.port,
                                 sink_port=server.sink_port, in_caps=caps)
            assert ok.server_caps == CAPS
            ok.close()
    finally:
        server.stop()


def test_hostile_data_info_closes_its_connection_and_the_server_serves_on():
    server = QueryServer(host="127.0.0.1", port=0, caps_str=CAPS,
                         wire="nnstreamer").start()
    try:
        s = socket.create_connection(("127.0.0.1", server.port), timeout=5)
        assert struct.unpack("<i", s.recv(4))[0] == R.CMD_CLIENT_ID
        s.recv(8)
        c = RefDataInfo(base_time=0, sent_time=0, duration=R.CLOCK_NONE,
                        dts=R.CLOCK_NONE, pts=0, num_mems=17)
        s.sendall(struct.pack("<i", R.CMD_TRANSFER_START) + bytes(c))
        s.settimeout(5)
        assert s.recv(1) == b""  # the server closed this connection
        s.close()
        t = threading.Thread(target=_serve_triple, args=(server, 1),
                             daemon=True)
        t.start()
        x = np.arange(12, dtype=np.float32).reshape(3, 4)
        _, _, _, mems = _reference_client_roundtrip(
            server.port, server.sink_port, x.tobytes())
        t.join(timeout=10)
        np.testing.assert_array_equal(
            np.frombuffer(mems[0], np.float32).reshape(3, 4), x * 3)
    finally:
        server.stop()


def test_client_sends_only_fixated_caps():
    """ROADMAP C.37 (deliberate): a list or a range in the caps a client
    would announce raises, naming the field, where the JAX client sends
    this package's Python spelling of it."""
    from nnstreamer_tpu_torch.pipeline.caps import Caps, IntRange

    fixed = Caps("other/tensors", {"format": "static", "num_tensors": 1,
                                   "dimensions": "4:3", "types": "float32"})
    assert R.fixated_caps_string(fixed) == fixed.to_string()
    for field, value in (("types", ["float32", "uint8"]),
                         ("num_tensors", IntRange(1, 4))):
        with pytest.raises(R.RefWireError, match=field):
            R.fixated_caps_string(fixed.with_fields(**{field: value}))


# -- the offload pipeline (tests/test_refwire.py::TestElementsRefwire) --------
class _Triple(torch.nn.Module):
    def forward(self, x):
        return x * 3.0


@pytest.fixture
def triple_models():
    from nnstreamer_tpu.filters.jax_backend import (
        register_jax_model,
        unregister_jax_model,
    )
    from nnstreamer_tpu_torch.filters.torch_backend import (
        register_torch_model,
        unregister_torch_model,
    )

    register_jax_model("refwire_triple", lambda x: (x * 3.0,), None)
    register_torch_model("refwire_triple", _Triple())
    yield "refwire_triple"
    unregister_jax_model("refwire_triple")
    unregister_torch_model("refwire_triple")


def _offload(pkg, model, frames, client_pkg=None):
    """The server string of ``tests/test_refwire.py`` in ``pkg`` and the
    appsrc-fed client in ``client_pkg`` (default ``pkg``): the results the
    client's sink received, and the client's sent-bytes count."""
    client_pkg = client_pkg or pkg
    server = pkg.parse_launch(
        "tensor_query_serversrc name=ssrc port=0 wire=nnstreamer "
        f"caps={CAPS} ! tensor_filter framework=jax model={model} ! "
        "queue max-size-buffers=8 materialize-host=true ! "
        "tensor_query_serversink id=0")
    server.start()
    try:
        ssrc = server.get("ssrc")
        deadline = time.monotonic() + 5
        while ssrc.server is None and time.monotonic() < deadline:
            time.sleep(0.01)
        client = client_pkg.parse_launch(
            "appsrc name=src ! tensor_query_client name=c "
            f"port={ssrc.port} sink-port={ssrc.result_port} "
            "wire=nnstreamer ! tensor_sink name=out")
        client.start()
        try:
            src = client.get("src")
            for i, f in enumerate(frames):
                src.push([f], pts=i)
            src.end_of_stream()
            msg = client.wait(timeout=30)
            assert msg is not None and msg.kind == "eos", msg
            return list(client.get("out").buffers)
        finally:
            client.stop()
    finally:
        server.stop()


def test_offload_pipeline_matches_the_jax_pipeline(cpu_device, pure_py,
                                                   triple_models):
    rng = np.random.default_rng(26)
    frames = [rng.standard_normal((3, 4)).astype(np.float32)
              for _ in range(6)]
    port = _offload(tnt, triple_models, frames)
    jax_out = _offload(jnt, triple_models, frames)
    assert len(port) == len(jax_out) == len(frames)
    for i, (a, b) in enumerate(zip(port, jax_out)):
        a0, b0 = np.asarray(a.tensors[0]), np.asarray(b.tensors[0])
        assert a0.dtype == b0.dtype == np.float32
        assert a0.tobytes() == b0.tobytes()
        np.testing.assert_array_equal(a0, frames[i] * 3)
        assert a.pts == b.pts == i


@pytest.mark.parametrize("server_side,client_side",
                         [("port", "jax"), ("jax", "port")])
def test_offload_across_the_packages(cpu_device, pure_py, triple_models,
                                     server_side, client_side):
    pkgs = {"port": tnt, "jax": jnt}
    frames = [np.full((3, 4), i, np.float32) for i in range(4)]
    out = _offload(pkgs[server_side], triple_models, frames,
                   client_pkg=pkgs[client_side])
    assert len(out) == 4
    for i, b in enumerate(out):
        np.testing.assert_array_equal(np.asarray(b.tensors[0]),
                                      frames[i] * 3)


def test_client_element_denied_names_the_server_caps(cpu_device):
    server = QueryServer(host="127.0.0.1", port=0, caps_str=CAPS,
                         wire="nnstreamer").start()
    try:
        client = tnt.parse_launch(
            "appsrc name=src caps=other/tensors,format=static,"
            "num_tensors=1,dimensions=8:8,types=uint8 ! "
            f"tensor_query_client port={server.port} "
            f"sink-port={server.sink_port} wire=nnstreamer max-retry=1 "
            "timeout=5 ! tensor_sink name=out")
        src = client.get("src")
        src.push([np.zeros((8, 8), np.uint8)])
        src.end_of_stream()
        with pytest.raises(Exception, match="denied"):
            client.run(timeout=30)
    finally:
        server.stop()


def test_client_counts_the_bytes_it_sends(cpu_device, pure_py,
                                          triple_models):
    frames = [np.zeros((3, 4), np.float32)] * 2
    server = tnt.parse_launch(
        "tensor_query_serversrc name=ssrc port=0 wire=nnstreamer "
        f"caps={CAPS} ! tensor_filter framework=jax model={triple_models} "
        "! tensor_query_serversink id=0")
    server.start()
    try:
        ssrc = server.get("ssrc")
        while ssrc.server is None:
            time.sleep(0.01)
        # a pipeline name of its own: the counter is process-wide
        client = tnt.parse_launch(
            "appsrc name=src ! tensor_query_client name=c "
            f"port={ssrc.port} sink-port={ssrc.result_port} "
            "wire=nnstreamer ! tensor_sink name=out",
            pipeline=tnt.Pipeline(name="refwire-sent-bytes"))
        src = client.get("src")
        for f in frames:
            src.push([f])
        src.end_of_stream()
        assert client.run(timeout=30).kind == "eos"
    finally:
        server.stop()
    # a frame: START (4 + 176) + DATA (4 + 8 + 48) + END (4 + 176)
    assert client.get("c").obs_snapshot()["sent_bytes"] == 2 * 420


def test_shape_changing_server_types_results_by_its_output_caps(cpu_device):
    """The chip script's flagship-behind-the-wire at a small size: uint8
    frames to ``tensor_transform ! tensor_filter`` (a 32×32, 10-class
    MobileNetV2) behind ``wire=nnstreamer``. APPROVE announces the
    serversink's float32 [10:1] caps (ROADMAP C.40), so the client types
    its results, which are bit-identical, in order, to an in-process run
    of the same transform ! filter on the same frames."""
    from nnstreamer_tpu_torch.filters.torch_backend import (
        register_torch_model,
        unregister_torch_model,
    )
    from nnstreamer_tpu_torch.models.mobilenet_v2 import mobilenet_v2

    size, classes, n = 32, 10, 12
    module, _, _ = mobilenet_v2(num_classes=classes, image_size=size,
                                dtype=torch.float32, seed=3)
    register_torch_model("refwire_mnv2", module)
    caps = (f"other/tensors,format=static,num_tensors=1,"
            f"dimensions=3:{size}:{size}:1,types=uint8")
    body = ("tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! "
            "tensor_filter framework=jax model=refwire_mnv2")
    rng = np.random.default_rng(40)
    frames = [rng.integers(0, 256, (1, size, size, 3), dtype=np.uint8)
              for _ in range(n)]
    try:
        server = tnt.parse_launch(
            f"tensor_query_serversrc name=ss port=0 wire=nnstreamer "
            f"caps={caps} ! {body} ! tensor_query_serversink name=sk")
        server.start()
        try:
            deadline = time.monotonic() + 30
            while server.get("sk").sinkpad.caps is None:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            ss = server.get("ss")
            client = tnt.parse_launch(
                f"appsrc name=src caps={caps} ! tensor_query_client "
                f"wire=nnstreamer port={ss.port} "
                f"sink-port={ss.result_port} ! tensor_sink name=out")
            src = client.get("src")
            for i, f in enumerate(frames):
                src.push([f], pts=i)
            src.end_of_stream()
            assert client.run(timeout=120).kind == "eos"
        finally:
            server.stop()
        local = tnt.parse_launch(f"appsrc name=src caps={caps} ! {body} ! "
                                 "tensor_sink name=out")
        src = local.get("src")
        for i, f in enumerate(frames):
            src.push([f], pts=i)
        src.end_of_stream()
        assert local.run(timeout=120).kind == "eos"
    finally:
        unregister_torch_model("refwire_mnv2")
    got = client.get("out").buffers
    want = local.get("out").buffers
    assert len(got) == len(want) == n
    assert [b.pts for b in got] == list(range(n))
    for a, b in zip(got, want):
        a0, b0 = np.asarray(a[0]), np.asarray(b[0])
        assert a0.dtype == np.float32 and a0.shape == (1, classes)
        assert a0.tobytes() == b0.tobytes()
