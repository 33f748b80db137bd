"""The port's native runtime core (``nnstreamer_tpu_torch/native.py``) and
the transports that run on it, held to the JAX package's ``native.py`` on
the same seeded numpy inputs, with exact equality (all host code).

- The library builds from ``native/*.cc`` into the port's own
  ``_build/native/`` and never rewrites ``native/libnnstpu.so``.
- ``fnv1a``, ``cpu_features``, the sparse arrays (``-0.0`` and NaN
  included) and ``send_frame``'s bytes equal the JAX module's.
- A classic ``QueryServer`` runs on the epoll core (``server.native``) and
  falls back to Python as the JAX server does; the two packages' clients
  and servers talk across both transports, frame for frame.
- ``tests/test_query.py``'s ``TestServerTransports`` and ``TestServerSoak``
  on the port, asserting ``server.native`` with no skip.
- The JAX ``native-epoll`` cases of ``tests/test_refwire.py`` against the
  port's reference wire, which stays on Python (ROADMAP C.50), and the pin
  of C.50: a mismatched reference client is approved by the JAX native
  core and denied by the port.
"""

import builtins
import logging
import os
import socket
import subprocess
import threading
import time
from pathlib import Path
from types import SimpleNamespace
from typing import List

import numpy as np
import pytest
import torch

import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu import native as jnative
from nnstreamer_tpu.query import protocol as JP
from nnstreamer_tpu.query.server import QueryServer as JQueryServer
from nnstreamer_tpu.tensors.buffer import TensorBuffer as JaxBuffer
from nnstreamer_tpu_torch import native as tnative
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.elements.source import AppSrc
from nnstreamer_tpu_torch.filters import register_custom_easy
from nnstreamer_tpu_torch.filters.custom import unregister_custom_easy
from nnstreamer_tpu_torch.query import protocol as P
from nnstreamer_tpu_torch.query import refwire as R
from nnstreamer_tpu_torch.query.server import QueryServer
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer
from tests.test_refwire import CAPS, _reference_client_roundtrip, _serve_double
from tests.test_torch_query import _client_results, _frame_tensors, _server

MISMATCHED = ("other/tensors,format=static,num_tensors=1,"
              "dimensions=8:8,types=uint8")


@pytest.fixture(autouse=True)
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


@pytest.fixture(scope="module", autouse=True)
def libraries():
    assert tnative.get_lib() is not None, "the port's library did not load"
    assert jnative.get_lib() is not None, "libnnstpu.so did not load"


# -- the build -----------------------------------------------------------------
def test_the_library_loads_from_the_ports_build_directory():
    path = tnative.library_path()
    assert path.parent == tnative.BUILD_DIR
    assert path.parent == tnative.PKG_DIR / "_build" / "native"
    assert tnative.get_lib()._name == str(path)
    assert path.name.startswith("libnnstpu-") and path.is_file()


def _record_build_writes(monkeypatch) -> List[Path]:
    """Every path the port's ``native.build()`` writes, recorded from
    inside the module: a file opened for writing, the compiler's ``-o``
    target and both ends of the rename. Other processes (the JAX
    package's own build, run by any worker that loads its library) may
    write under ``native/`` meanwhile; this records the port's writes
    alone."""
    writes: List[Path] = []

    def _open(path, mode="r", *args, **kwargs):
        if any(c in mode for c in "wax+"):
            writes.append(Path(path))
        return builtins.open(path, mode, *args, **kwargs)

    def _run(cmd, *args, **kwargs):
        writes.append(Path(cmd[cmd.index("-o") + 1]))
        return subprocess.run(cmd, *args, **kwargs)

    def _replace(src, dst):
        writes.extend([Path(src), Path(dst)])
        return os.replace(src, dst)

    monkeypatch.setattr(tnative, "open", _open, raising=False)
    monkeypatch.setattr(tnative, "subprocess", SimpleNamespace(
        run=_run, CalledProcessError=subprocess.CalledProcessError))
    monkeypatch.setattr(tnative, "os", SimpleNamespace(
        environ=os.environ, getpid=os.getpid, replace=_replace))
    return writes


def test_a_build_writes_only_under_its_build_directory(tmp_path,
                                                       monkeypatch):
    build_dir = tmp_path / "native"
    monkeypatch.setattr(tnative, "BUILD_DIR", build_dir)
    writes = _record_build_writes(monkeypatch)
    assert tnative.build()
    out = tnative.library_path()
    assert out.is_file() and out.parent == build_dir
    assert sorted(p.name for p in out.parent.iterdir()) == \
        sorted([".build.lock", out.name])
    # the lock, the compiler's temporary and the rename into place
    assert build_dir / ".build.lock" in writes and out in writes
    assert any(p.suffix == ".tmp" for p in writes), writes
    outside = [p for p in writes if build_dir not in p.parents]
    assert not outside, outside
    assert not list(tnative.SRC_DIR.glob("libnnstpu-*"))
    # a second build finds the library and compiles nothing
    mtime = out.stat().st_mtime_ns
    del writes[:]
    assert tnative.build() and out.stat().st_mtime_ns == mtime
    assert writes == [build_dir / ".build.lock"]


def test_the_library_key_follows_the_flags(monkeypatch):
    a = tnative.library_path()
    monkeypatch.setattr(tnative, "CXXFLAGS", tnative.CXXFLAGS + ["-g"])
    assert tnative.library_path() != a


def test_without_sources_nothing_builds(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "SRC_DIR", tmp_path)
    assert tnative.library_path() is None
    assert not tnative.build()


# -- the helpers against the JAX module ----------------------------------------
def test_cpu_features_equal_the_jax_modules():
    assert tnative.cpu_features() == jnative.cpu_features()
    assert tnative.cpu_features()["native"] and tnative.available()


@pytest.mark.parametrize("n", [0, 1, 7, 4096])
def test_fnv1a_equals_the_jax_modules(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert tnative.fnv1a(data) == jnative.fnv1a(data)


def test_c51_fnv1a_library_and_fallback_disagree_in_both_packages(
        monkeypatch):
    """ROADMAP C.51, a fault the port shares: ``native/nnstpu.cc`` seeds
    FNV-1a with 1469598103934665603, a digit short of the offset basis
    14695981039346656037 the Python fallback uses, so a checksum depends
    on whether the library loaded. Each package's library agrees with the
    other's, and so does each fallback."""
    data = np.random.default_rng(5).integers(0, 256, 333, np.uint8).tobytes()
    lib_hash = tnative.fnv1a(data)
    assert lib_hash == jnative.fnv1a(data)
    assert tnative.fnv1a(b"") == jnative.fnv1a(b"") == 1469598103934665603
    for mod in (tnative, jnative):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", True)
    assert tnative.fnv1a(b"") == jnative.fnv1a(b"") == 0xCBF29CE484222325
    assert tnative.fnv1a(data) == jnative.fnv1a(data) != lib_hash


def _sparse_input(dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(257).astype(np.float64)
    x[rng.random(257) < 0.7] = 0.0
    if np.dtype(dtype).kind == "f":
        x = x.astype(dtype)
        x[3], x[4], x[5] = -0.0, np.nan, np.inf
        return x
    return (x * 50).astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float16,
                                   np.float32, np.int32, np.float64,
                                   np.int64])
def test_sparse_arrays_equal_the_jax_modules(dtype):
    x = _sparse_input(dtype, 11)
    bits = x.view(f"u{x.itemsize}")
    idx, vals = tnative.sparse_encode_arrays(bits)
    jidx, jvals = jnative.sparse_encode_arrays(bits)
    assert idx.dtype == jidx.dtype == np.uint32
    assert idx.tobytes() == jidx.tobytes()
    assert vals.tobytes() == jvals.tobytes()
    if np.dtype(dtype).kind == "f":
        assert {3, 4, 5} <= set(idx.tolist())  # -0.0, NaN, inf are kept
    dense = tnative.sparse_decode_arrays(idx, vals, bits.size)
    assert dense.tobytes() == bits.tobytes()
    assert dense.tobytes() == \
        jnative.sparse_decode_arrays(jidx, jvals, bits.size).tobytes()


def test_sparse_fallback_equals_the_library(monkeypatch):
    bits = _sparse_input(np.float32, 12).view(np.uint32)
    idx, vals = tnative.sparse_encode_arrays(bits)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", True)
    fidx, fvals = tnative.sparse_encode_arrays(bits)
    assert fidx.tobytes() == idx.tobytes()
    assert fvals.tobytes() == vals.tobytes()
    assert tnative.sparse_decode_arrays(fidx, fvals, bits.size).tobytes() \
        == bits.tobytes()


@pytest.mark.parametrize("native_lib", [True, False],
                         ids=["library", "fallback"])
def test_sparse_decode_rejects_an_index_out_of_range(native_lib,
                                                     monkeypatch):
    if not native_lib:
        monkeypatch.setattr(tnative, "_lib", None)
        monkeypatch.setattr(tnative, "_tried", True)
    with pytest.raises(ValueError, match="out of range"):
        tnative.sparse_decode_arrays(np.array([9], np.uint32),
                                     np.array([1], np.uint8), 4)


def _read_all(sock, n):
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        assert chunk
        out += chunk
    return out


@pytest.mark.parametrize("timeout", [None, 5.0],
                         ids=["blocking-native", "timeout-python"])
@pytest.mark.parametrize("size", [0, 5, 70_000])
def test_send_frame_bytes_equal_the_jax_modules(timeout, size):
    payload = np.random.default_rng(size).integers(
        0, 256, size, np.uint8).tobytes()
    frames = []
    for mod in (tnative, jnative):
        a, b = socket.socketpair()
        try:
            a.settimeout(timeout)
            t = threading.Thread(target=mod.send_frame,
                                 args=(a, 0x4E545131, 3, payload),
                                 daemon=True)
            t.start()
            b.settimeout(10)
            frames.append(_read_all(b, 16 + size))
            t.join(timeout=10)
        finally:
            a.close()
            b.close()
    assert frames[0] == frames[1]
    assert frames[0][16:] == payload


@pytest.mark.parametrize("timeout", [None, 5.0],
                         ids=["blocking-native", "timeout-python"])
def test_protocol_frames_cross_the_packages_on_both_paths(timeout):
    """``send_msg``/``recv_msg`` on a blocking socket take the native
    ``writev``/``recv``; with a timeout, Python. Either way the frames are
    the JAX package's."""
    body = P.pack_buffer(TensorBuffer(_frame_tensors(3), pts=9))
    a, b = socket.socketpair()
    try:
        a.settimeout(timeout)
        b.settimeout(timeout)
        for _ in range(3):
            P.send_msg(a, P.Cmd.TRANSFER, body)
            assert JP.recv_msg(b) == (JP.Cmd.TRANSFER, body)
            JP.send_msg(b, JP.Cmd.RESULT, body)
            assert P.recv_msg(a) == (P.Cmd.RESULT, body)
        P.send_msg(a, P.Cmd.PING)
        assert P.recv_msg(b) == (P.Cmd.PING, b"")
    finally:
        a.close()
        b.close()


def test_native_recv_rejects_a_bad_magic():
    a, b = socket.socketpair()
    try:
        b.settimeout(None)
        a.sendall(b"\0" * 16)
        with pytest.raises(P.QueryProtocolError, match="bad magic"):
            P.recv_msg(b)
    finally:
        a.close()
        b.close()


# -- transport selection --------------------------------------------------------
def test_a_classic_server_runs_on_the_native_core():
    srv = QueryServer(host="127.0.0.1", port=0).start()
    try:
        assert srv.native and srv.port > 0
    finally:
        srv.stop()
    assert not srv.native


@pytest.mark.parametrize("why", ["env", "resilient", "no-library",
                                 "refwire"])
def test_the_python_transport_serves_when_the_core_cannot(why, monkeypatch,
                                                          caplog):
    kw = {}
    if why == "env":
        monkeypatch.setenv("NNSTPU_PURE_PY_SERVER", "1")
    elif why == "resilient":
        kw["resilient"] = True
    elif why == "no-library":
        monkeypatch.setattr(tnative, "_lib", None)
        monkeypatch.setattr(tnative, "_tried", True)
    else:
        kw.update(wire="nnstreamer", caps_str=CAPS)
    # the port's loggers do not propagate: listen on the server's own
    logger = logging.getLogger(srv_log_name())
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger=logger.name):
            srv = QueryServer(host="127.0.0.1", port=0, **kw).start()
    finally:
        logger.removeHandler(caplog.handler)
    try:
        assert not srv.native
        if why == "no-library":
            assert "native server core unavailable" in caplog.text
        if why != "refwire":
            assert _echo_once(srv) == b"ok"
    finally:
        srv.stop()


def srv_log_name():
    from nnstreamer_tpu_torch.query import server as S

    return S.log.name


def _echo_once(srv):
    """One echo round trip through a classic server, by hand."""
    sock, cid = _handshake(srv.port, b"")
    try:
        P.send_buffer(sock, TensorBuffer([np.frombuffer(b"ok", np.uint8)]))
        got = srv.get_buffer(timeout=10)
        assert got is not None and srv.send_result(cid, got)
        cmd, payload = P.recv_msg(sock)
        assert cmd is P.Cmd.RESULT
        return np.asarray(P.unpack_buffer(payload)[0]).tobytes()
    finally:
        sock.close()


def _handshake(port, caps):
    sock = P.connect("127.0.0.1", port, timeout=10)
    P.send_msg(sock, P.Cmd.REQUEST_INFO, b"caps")
    cmd, payload = P.recv_msg(sock)
    assert cmd is P.Cmd.APPROVE and payload == caps
    cmd, payload = P.recv_msg(sock)
    assert cmd is P.Cmd.CLIENT_ID
    return sock, int(payload.decode())


def _raw_session(port, body):
    """Handshake, one TRANSFER and the raw bytes of the replies: the
    APPROVE and CLIENT_ID frames, then (after the echo) the RESULT."""
    sock = socket.create_connection(("127.0.0.1", port), timeout=10)
    sock.sendall(JP._HDR.pack(JP._MAGIC, int(JP.Cmd.REQUEST_INFO), 4)
                 + b"caps")
    hs = b""
    for _ in range(2):
        hdr = _read_all(sock, 16)
        hs += hdr + _read_all(sock, JP._HDR.unpack(hdr)[2])
    sock.sendall(JP._HDR.pack(JP._MAGIC, int(JP.Cmd.TRANSFER), len(body))
                 + body)
    return sock, hs


@pytest.mark.parametrize("transport", ["native", "purepy"])
def test_server_frames_are_byte_identical_to_the_jax_servers(transport,
                                                             monkeypatch):
    if transport == "purepy":
        monkeypatch.setenv("NNSTPU_PURE_PY_SERVER", "1")
    body = JP.pack_buffer(JaxBuffer(_frame_tensors(4), pts=77))
    replies = []
    for cls in (QueryServer, JQueryServer):
        srv = cls(host="127.0.0.1", port=0, caps_str="other/tensors").start()
        try:
            assert srv.native == (transport == "native")
            sock, hs = _raw_session(srv.port, body)
            try:
                got = srv.get_buffer(timeout=10)
                assert got is not None
                cid = got.meta["query_client_id"]
                assert P.pack_buffer(got) == body if cls is QueryServer \
                    else JP.pack_buffer(got) == body
                assert srv.send_result(cid, got)
                hdr = _read_all(sock, 16)
                res = hdr + _read_all(sock, JP._HDR.unpack(hdr)[2])
                replies.append((hs, res))
            finally:
                sock.close()
        finally:
            srv.stop()
    assert replies[0] == replies[1]
    assert replies[0][1][16:] == body


@pytest.mark.parametrize("transport", ["native", "purepy"])
@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("jax", "port"), ("port", "jax")])
def test_clients_and_servers_cross_the_packages(client_pkg, server_pkg,
                                                transport, monkeypatch):
    if transport == "purepy":
        monkeypatch.setenv("NNSTPU_PURE_PY_SERVER", "1")
    pipe, port = _server(server_pkg, "tensor_query_serversrc name=ss "
                                     "port=0 id=61 ! "
                                     "tensor_query_serversink id=61")
    frames = [_frame_tensors(s) for s in range(4)]
    try:
        assert pipe.get("ss").server.native == (transport == "native")
        got, _ = _client_results(client_pkg, port, frames, window=2)
    finally:
        pipe.stop()
    assert [b.pts for b in got] == [0, 1, 2, 3]
    for buf, want in zip(got, frames):
        for a, b in zip(buf.tensors, want):
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_a_reliable_client_is_dropped_by_the_native_core():
    pipe, port = _server("port", "tensor_query_serversrc name=ss port=0 "
                                 "id=62 ! tensor_query_serversink id=62")
    try:
        assert pipe.get("ss").server.native
        msg = _reliable_client_message(port)
        assert msg is not None and msg.kind == "error", msg
        assert "HELLO" in str(msg.error)
    finally:
        pipe.stop()


def _reliable_client_message(port):
    client = tnt.parse_launch(
        "appsrc name=src ! tensor_query_client name=qc reliable=true "
        f"dest-host=127.0.0.1 dest-port={port} timeout=5 max-retry=0 ! "
        "tensor_sink name=out")
    client.start()
    try:
        client.get("src").push([np.zeros(3, np.float32)])
        client.get("src").end_of_stream()
        return client.wait(timeout=30)
    finally:
        client.stop()


# -- tests/test_query.py::TestServerTransports on the port ----------------------
class TestServerTransports:
    """Same behavior from the native epoll core and the Python transport."""

    @pytest.fixture(params=["native", "purepy"])
    def server(self, request, monkeypatch):
        if request.param == "purepy":
            monkeypatch.setenv("NNSTPU_PURE_PY_SERVER", "1")
        srv = QueryServer(host="127.0.0.1", port=0,
                          caps_str="other/tensors").start()
        assert srv.native == (request.param == "native")
        yield srv
        srv.stop()

    def test_handshake_transfer_result(self, server):
        rng = np.random.default_rng(0)
        sock, cid = _handshake(server.port, b"other/tensors")
        buf = TensorBuffer([rng.standard_normal((3, 4)).astype(np.float32)],
                           pts=7)
        P.send_buffer(sock, buf)
        got = server.get_buffer(timeout=10)
        assert got is not None and got.meta["query_client_id"] == cid
        np.testing.assert_array_equal(got[0], buf[0])
        assert server.send_result(cid, got)
        cmd, payload = P.recv_msg(sock)
        assert cmd is P.Cmd.RESULT
        back = P.unpack_buffer(payload)
        np.testing.assert_array_equal(back[0], buf[0])
        assert back.pts == 7
        sock.close()

    def test_ping_and_bye(self, server):
        sock, cid = _handshake(server.port, b"other/tensors")
        P.send_msg(sock, P.Cmd.PING)
        assert P.recv_msg(sock)[0] is P.Cmd.PING
        P.send_msg(sock, P.Cmd.BYE)
        sock.close()
        # after BYE the client is gone: results are undeliverable
        deadline = time.monotonic() + 5
        while server.send_result(cid, TensorBuffer([np.zeros(1)])):
            assert time.monotonic() < deadline, "BYE never processed"
            time.sleep(0.02)

    def test_many_clients_routing(self, server):
        socks = {}
        for _ in range(8):
            sock, cid = _handshake(server.port, b"other/tensors")
            socks[cid] = sock
        for cid, sock in socks.items():
            P.send_buffer(sock, TensorBuffer(
                [np.full((2,), cid, np.int32)], pts=cid))
        for _ in range(len(socks)):
            got = server.get_buffer(timeout=10)
            assert got is not None
            cid = got.meta["query_client_id"]
            assert int(got[0][0]) == cid  # payload matches its client
            assert server.send_result(cid, got)
        for cid, sock in socks.items():
            cmd, payload = P.recv_msg(sock)
            assert cmd is P.Cmd.RESULT
            assert int(P.unpack_buffer(payload)[0][0]) == cid
            sock.close()

    def test_large_frame_growth(self, server):
        """Frames bigger than the take buffer's initial capacity (64 KiB)
        exercise the grow-and-retry path."""
        rng = np.random.default_rng(1)
        sock, cid = _handshake(server.port, b"other/tensors")
        big = rng.standard_normal((512, 600)).astype(np.float32)  # ~1.2 MB
        P.send_buffer(sock, TensorBuffer([big]))
        got = server.get_buffer(timeout=10)
        assert got is not None and got.meta["query_client_id"] == cid
        np.testing.assert_array_equal(got[0], big)
        sock.close()

    def test_bad_frame_disconnects_client(self, server):
        """A TRANSFER payload that fails buffer unpack disconnects the
        sender on both transports (and does not stall the consumer)."""
        sock, _ = _handshake(server.port, b"other/tensors")
        P.send_msg(sock, P.Cmd.TRANSFER, b"\x01garbage-not-a-buffer")
        assert server.get_buffer(timeout=2) is None
        sock.settimeout(5)
        with pytest.raises((P.QueryProtocolError, OSError)):
            while True:
                P.recv_msg(sock)
        sock.close()

    def test_stop_while_consumer_blocked(self, server):
        """stop() unblocks a thread waiting in get_buffer and never
        crashes (the native core frees only after in-flight calls
        drain)."""
        results = []

        def consumer():
            results.append(server.get_buffer(timeout=30))

        t = threading.Thread(target=consumer, daemon=True)
        t.start()
        time.sleep(0.2)  # let it block inside the wait
        server.stop()
        t.join(timeout=10)
        assert not t.is_alive()
        assert results == [None]


# -- tests/test_query.py::TestServerSoak on the port ----------------------------
class TestServerSoak:
    @staticmethod
    def _make_server(model, pair_id, dim):
        """serversrc → custom-easy(+1) filter → serversink, started."""
        info = tnt.TensorsInfo.from_str(dim, "float32")
        register_custom_easy(model, lambda ins: [np.asarray(ins[0]) + 1.0],
                             info, info)
        server = tnt.parse_launch(
            f"tensor_query_serversrc name=ss port=0 id={pair_id} ! "
            f"tensor_filter framework=custom-easy model={model} ! "
            f"tensor_query_serversink id={pair_id}")
        server.start()
        assert server.get("ss").server.native
        return server, server.get("ss").port

    @staticmethod
    def _make_client(port, window):
        """appsrc → query client → sink pipeline, started."""
        client = tnt.parse_launch(
            f"tensor_query_client name=c dest-host=127.0.0.1 "
            f"dest-port={port} max-in-flight={window} timeout=30")
        src, sink = AppSrc(name="src"), TensorSink(name="out")
        client.add(src, sink)
        src.link(client.get("c"))
        client.get("c").link(sink)
        client.start()
        return client, src, sink

    def test_sustained_offload_500_frames(self):
        """Sustained pipelined load through the native transport: every
        frame accounted for, zero drops, orderly EOS."""
        server, port = self._make_server("soak_inc_t", 77, "16")
        client = None
        try:
            client, src, sink = self._make_client(port, window=8)
            n = 500
            for i in range(n):
                src.push([np.full(16, float(i), np.float32)], pts=i)
            src.end_of_stream()
            msg = client.wait(timeout=120)
            assert msg is not None and msg.kind == "eos", msg
            assert len(sink.buffers) == n
            assert int(client.get("c").get_property("frames_dropped")) == 0
            for i in (0, 123, 499):
                np.testing.assert_allclose(
                    np.asarray(sink.buffers[i][0]), float(i) + 1.0)
        finally:
            if client is not None:
                client.stop()
            server.stop()
            unregister_custom_easy("soak_inc_t")

    def test_concurrent_clients_native_core(self):
        """Four clients on the native transport from separate threads:
        per-connection write mutexes and the atomic take keep every
        stream intact."""
        server, port = self._make_server("conc_inc_t", 78, "8")
        try:
            results = {}

            def client_run(tag):
                c = None
                try:
                    c, src, sink = self._make_client(port, window=4)
                    for i in range(60):
                        src.push([np.full(8, tag * 1000.0 + i, np.float32)],
                                 pts=i)
                    src.end_of_stream()
                    msg = c.wait(timeout=60)
                    vals = [float(np.asarray(b[0])[0])
                            for b in sink.buffers]
                    results[tag] = (msg.kind if msg else None, vals)
                except Exception as e:  # surface in the main thread
                    results[tag] = ("exception", repr(e))
                finally:
                    if c is not None:
                        c.stop()

            threads = [threading.Thread(target=client_run, args=(t,),
                                        daemon=True) for t in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert all(not t.is_alive() for t in threads)
            for tag in range(4):
                kind, vals = results[tag]
                assert kind == "eos", (tag, kind, vals)
                assert vals == [tag * 1000.0 + i + 1.0 for i in range(60)]
        finally:
            server.stop()
            unregister_custom_easy("conc_inc_t")


# -- tests/test_refwire.py's native-epoll cases, and C.50 ----------------------
def test_reference_client_full_roundtrip_with_the_library_loaded():
    """``test_reference_client_full_roundtrip[native-epoll]``: with the
    library loaded and no ``NNSTPU_PURE_PY_SERVER``, the port's reference
    wire still runs on Python, and a hand-framed reference client offloads
    through it."""
    server = QueryServer(host="127.0.0.1", port=0, caps_str=CAPS,
                         wire="nnstreamer").start()
    assert not server.native
    try:
        t = threading.Thread(target=_serve_double, args=(server,),
                             daemon=True)
        t.start()
        x = np.arange(12, dtype=np.float32).reshape(3, 4)
        _, server_caps, _, mems = _reference_client_roundtrip(
            server.port, server.sink_port, x.tobytes())
        t.join(timeout=10)
        assert not t.is_alive()
        assert server_caps == CAPS
        assert len(mems) == 1
        got = np.frombuffer(mems[0], np.float32).reshape(3, 4)
        np.testing.assert_array_equal(got, x * 2)
    finally:
        server.stop()


class _Triple(torch.nn.Module):
    def forward(self, x):
        return x * 3.0


def test_offload_pipeline_with_the_library_loaded():
    """``TestElementsRefwire::test_offload_pipeline[native-epoll]`` on the
    port, with a matched client: the serversrc's reference wire is on
    Python and the results are the input tripled."""
    from nnstreamer_tpu_torch.filters.torch_backend import (
        register_torch_model,
        unregister_torch_model,
    )

    register_torch_model("native_triple", _Triple())
    server = tnt.parse_launch(
        "tensor_query_serversrc name=ssrc port=0 wire=nnstreamer "
        f"caps={CAPS} ! tensor_filter framework=torch model=native_triple "
        "! queue max-size-buffers=8 materialize-host=true ! "
        "tensor_query_serversink id=0")
    server.start()
    try:
        ssrc = server.get("ssrc")
        deadline = time.monotonic() + 5
        while ssrc.server is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not ssrc.server.native
        client = tnt.parse_launch(
            "appsrc name=src ! tensor_query_client name=c "
            f"port={ssrc.port} sink-port={ssrc.result_port} "
            f"wire=nnstreamer ! tensor_sink name=out")
        frames = [np.full((3, 4), i, np.float32) for i in range(4)]
        client.start()
        try:
            for f in frames:
                client.get("src").push([f])
            client.get("src").end_of_stream()
            msg = client.wait(timeout=30)
            assert msg is not None and msg.kind == "eos", msg
            out = client.get("out").buffers
            assert len(out) == 4
            for i, b in enumerate(out):
                np.testing.assert_array_equal(np.asarray(b.tensors[0]),
                                              frames[i] * 3)
                assert np.asarray(b.tensors[0]).dtype == np.float32
        finally:
            client.stop()
    finally:
        server.stop()
        unregister_torch_model("native_triple")


def test_c50_the_jax_native_core_approves_what_the_port_denies():
    """ROADMAP C.50: the JAX package's native reference-wire core answers
    every REQUEST_INFO with APPROVE; the port keeps its reference wire on
    Python, which DENYs caps that do not intersect its own."""
    jsrv = JQueryServer(host="127.0.0.1", port=0, caps_str=CAPS,
                        wire="nnstreamer").start()
    try:
        assert jsrv.native
        ok = R.RefWireClient("127.0.0.1", jsrv.port,
                             sink_port=jsrv.sink_port, in_caps=MISMATCHED)
        assert ok.server_caps == CAPS
        ok.close()
    finally:
        jsrv.stop()
    srv = QueryServer(host="127.0.0.1", port=0, caps_str=CAPS,
                      wire="nnstreamer").start()
    try:
        assert not srv.native
        with pytest.raises(R.RefWireError, match="denied"):
            R.RefWireClient("127.0.0.1", srv.port, sink_port=srv.sink_port,
                            in_caps=MISMATCHED)
    finally:
        srv.stop()


def test_confchk_prints_the_native_runtime(capsys):
    from nnstreamer_tpu_torch.cli import main

    assert main(["--platforms", "cpu", "--confchk"]) == 0
    assert "native runtime : available" in capsys.readouterr().out


def test_jax_package_untouched_by_the_ports_library():
    """The port never loads the JAX package's library: the two handles are
    different files."""
    assert tnative.get_lib()._name != jnative.get_lib()._name
    assert "libnnstpu.so" not in tnative.get_lib()._name
