"""gRPC tensor streams in the port (``query/grpc_bridge.py``,
``elements/grpc_io.py``) held to the JAX package's over 127.0.0.1.

- Every ``idl`` encodes a buffer to the JAX codec's bytes, and a stream
  crosses the packages both ways, on SendTensors and on RecvTensors, with
  every payload byte-identical.
- ``tensor_src_grpc``/``tensor_sink_grpc`` stream between a port pipeline
  and a JAX one in both roles (push and pull).
- The ``grpc.call`` fault fires where the JAX bridge's does, with the same
  exception for every kind, from a spec or from ``NNSTPU_FAULTS``
  (``tests/test_resilience.py``'s grpc cases).

These tests import the JAX package, so they run on the CPU; on the card
``chip_smoke.py``'s ``grpc`` phase streams CUDA frames through the two
elements.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("grpc")

import nnstreamer_tpu as jnt  # noqa: E402
import nnstreamer_tpu_torch as tnt  # noqa: E402
from nnstreamer_tpu.pipeline import faults as JF  # noqa: E402
from nnstreamer_tpu.query import grpc_bridge as JG  # noqa: E402
from nnstreamer_tpu.tensors.buffer import TensorBuffer as JaxBuffer  # noqa: E402
from nnstreamer_tpu_torch.pipeline import faults as F  # noqa: E402
from nnstreamer_tpu_torch.query import grpc_bridge as G  # noqa: E402
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer  # noqa: E402

IDLS = ["protobuf", "flexbuf", "flatbuf", "nnstpu-flex"]
MODS = {"port": (G, TensorBuffer), "jax": (JG, JaxBuffer)}


@pytest.fixture(autouse=True)
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


def _arrays(seed, n=4):
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal((2, 3)).astype(np.float32),
             rng.integers(-99, 99, (4,), dtype=np.int32),
             rng.integers(0, 255, (1, 4, 4, 3), dtype=np.uint8)]
            for _ in range(n)]


def _buffers(pkg, seed, n=4):
    cls = MODS[pkg][1]
    return [cls(arrs, pts=i * 10) for i, arrs in enumerate(_arrays(seed, n))]


def _payload(buf):
    return [np.asarray(t).tobytes() for t in buf.tensors]


@pytest.mark.parametrize("idl", IDLS)
def test_codecs_encode_the_jax_bytes(idl):
    enc, dec = G._codecs(idl)
    jenc, _ = JG._codecs(idl)
    for tb, jb in zip(_buffers("port", 1), _buffers("jax", 1)):
        blob = enc(tb)
        assert blob == jenc(jb)
        assert _payload(dec(blob)) == _payload(tb)


@pytest.mark.parametrize("idl", IDLS)
def test_torch_tensors_encode_as_their_numpy_twins(idl):
    """A buffer of torch tensors is fetched to the host once and encodes to
    the bytes of its numpy twin."""
    enc, _ = G._codecs(idl)
    arrs = _arrays(2, 1)[0]
    assert enc(TensorBuffer([torch.from_numpy(a) for a in arrs], pts=0)) \
        == enc(TensorBuffer(arrs, pts=0))


@pytest.mark.parametrize("idl", IDLS)
@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port")])
def test_send_stream_crosses_the_packages(idl, client, server):
    got = []
    srv = MODS[server][0].TensorServiceServer(
        port=0, idl=idl, on_recv=got.append).start()
    try:
        cli = MODS[client][0].TensorServiceClient(
            port=srv.port, idl=idl).wait_ready(timeout=10)
        frames = _buffers(client, 3)
        cli.send_stream(iter(frames))
        cli.close()
    finally:
        srv.stop()
    assert len(got) == len(frames)
    for a, b in zip(got, frames):
        assert _payload(a) == _payload(b)
    if idl == "nnstpu-flex":  # the native framing keeps pts and rank
        assert [b.pts for b in got] == [0, 10, 20, 30]
        assert got[0].tensors[2].shape == (1, 4, 4, 3)


@pytest.mark.parametrize("idl", IDLS)
@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port")])
def test_recv_stream_crosses_the_packages(idl, client, server):
    srv = MODS[server][0].TensorServiceServer(port=0, idl=idl).start()
    try:
        frames = _buffers(server, 4, 3)
        for f in frames:
            srv.send(f)
        cli = MODS[client][0].TensorServiceClient(
            port=srv.port, idl=idl).wait_ready(timeout=10)
        it = cli.recv_stream(timeout=30)
        out = [next(it) for _ in range(3)]
        cli.close()
    finally:
        srv.stop()
    for a, b in zip(out, frames):
        assert _payload(a) == _payload(b)


def _grpc_pipelines(src_pkg, sink_pkg, src_server, idl, n=5):
    """A videotestsrc ! tensor_converter ! tensor_sink_grpc pipeline of
    ``sink_pkg`` streaming into a tensor_src_grpc ! tensor_sink pipeline of
    ``src_pkg``; returns the received buffers and what was sent."""
    pkgs = {"port": tnt, "jax": jnt}
    body = (f"videotestsrc num-buffers={n} width=4 height=4 pattern=ball ! "
            "tensor_converter")
    if src_server:
        rx = pkgs[src_pkg].parse_launch(
            f"tensor_src_grpc name=rx server=true port=0 num-buffers={n} "
            f"idl={idl} ! tensor_sink name=out")
        rx.start()
        try:
            tx = pkgs[sink_pkg].parse_launch(
                f"{body} ! tee name=t ! queue ! tensor_sink_grpc name=tx "
                f"server=false idl={idl} port={rx.get('rx').port} "
                "t. ! queue ! tensor_sink name=sent")
            msg = tx.run(timeout=60)
            assert msg is not None and msg.kind == "eos", msg
            got = rx.get("out").wait(n, timeout=30)
            return got, list(tx.get("sent").buffers)
        finally:
            rx.stop()
    tx = pkgs[sink_pkg].parse_launch(
        f"{body} ! tee name=t ! queue ! tensor_sink_grpc name=tx "
        f"server=true port=0 idl={idl} t. ! queue ! tensor_sink name=sent")
    tx.start()
    try:
        rx = pkgs[src_pkg].parse_launch(
            f"tensor_src_grpc name=rx server=false idl={idl} "
            f"port={tx.get('tx').port} num-buffers={n} ! "
            "tensor_sink name=out")
        rx.start()
        try:
            got = rx.get("out").wait(n, timeout=30)
        finally:
            rx.stop()
        assert tx.wait(timeout=30).kind == "eos"
        return got, list(tx.get("sent").buffers)
    finally:
        tx.stop()


@pytest.mark.parametrize("idl", ["protobuf", "nnstpu-flex"])
@pytest.mark.parametrize("src_server", [True, False],
                         ids=["push", "pull"])
@pytest.mark.parametrize("src_pkg,sink_pkg",
                         [("port", "jax"), ("jax", "port")])
def test_grpc_elements_stream_between_the_packages(idl, src_server, src_pkg,
                                                   sink_pkg):
    got, sent = _grpc_pipelines(src_pkg, sink_pkg, src_server, idl)
    assert len(got) == len(sent) == 5
    for a, b in zip(got, sent):
        assert _payload(a) == _payload(b)
        assert np.asarray(a.tensors[0]).size == 4 * 4 * 3


def test_grpc_elements_loopback_on_the_port():
    got, sent = _grpc_pipelines("port", "port", True, "flatbuf")
    assert len(got) == 5 and _payload(got[4]) == _payload(sent[4])
    assert np.asarray(got[0].tensors[0]).shape == (1, 4, 4, 3)


# -- the grpc.call fault site (tests/test_resilience.py's grpc cases) ----------
@pytest.mark.parametrize("kind", ["disconnect", "drop", "corrupt", "raise"])
@pytest.mark.parametrize("call", ["send_stream", "recv_stream"])
def test_grpc_call_fault_raises_as_the_jax_bridge(kind, call):
    """Every kind fires at the stream's opening in both packages: a
    transport verdict is a ``ConnectionError``, ``raise`` an
    ``InjectedFault``."""
    names = []
    for mod, fmod in ((G, F), (JG, JF)):
        svc = mod.TensorServiceServer(port=0).start()
        old = fmod.ACTIVE
        fmod.ACTIVE = fmod.FaultInjector(
            fmod.parse_faults(f"grpc.call:nth=1,kind={kind}"), seed=0)
        try:
            client = mod.TensorServiceClient(port=svc.port)
            with pytest.raises(Exception) as err:
                arg = iter([]) if call == "send_stream" else None
                getattr(client, call)(*([arg] if arg is not None else []))
            names.append(type(err.value).__name__)
            # nth=1: the second call goes through
            if call == "send_stream":
                client.wait_ready(timeout=10).send_stream(iter([]))
            client.close()
        finally:
            fmod.ACTIVE = old
            svc.stop()
    assert names[0] == names[1]
    assert names[0] == ("InjectedFault" if kind == "raise"
                        else "ConnectionError")


def test_grpc_call_fault_activates_from_the_environment(monkeypatch):
    monkeypatch.setenv("NNSTPU_FAULTS", "grpc.call:every=2,kind=disconnect")
    monkeypatch.setenv("NNSTPU_FAULTS_SEED", "3")
    F.deactivate()
    inj = F.maybe_activate_env()
    try:
        assert inj is F.ACTIVE and list(inj._rules) == ["grpc.call"]
        svc = G.TensorServiceServer(port=0).start()
        try:
            client = G.TensorServiceClient(port=svc.port).wait_ready(10)
            client.send_stream(iter([]))           # occurrence 1
            with pytest.raises(ConnectionError):   # occurrence 2
                client.send_stream(iter([]))
            client.close()
        finally:
            svc.stop()
        assert inj.snapshot()["grpc.call"] == 1  # one fault fired
    finally:
        F.deactivate()


def test_close_idempotent_and_context_manager():
    svc = G.TensorServiceServer(port=0).start()
    try:
        with G.TensorServiceClient(port=svc.port) as client:
            client.wait_ready(timeout=10)
        client.close()  # second close: no raise
        client.close()
        assert not hasattr(client, "__del__")
    finally:
        svc.stop()


def test_unknown_idl_names_the_choices():
    with pytest.raises(ValueError, match="nnstpu-flex"):
        G._codecs("json")
