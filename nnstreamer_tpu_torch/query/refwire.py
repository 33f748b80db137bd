"""Reference-wire tensor_query protocol (``wire=nnstreamer``).

Byte-level interop with the reference's framed-TCP query transport
(``gst/nnstreamer/tensor_query/tensor_query_common.c:320-450``): a
reference edge device can offload to our server, and our client can
offload to a reference server, with no translation layer.

Wire layout (native little-endian — the reference sends raw host
structs; ctypes oracles in ``tests/test_refwire.py`` pin every offset):

- every message starts with ``cmd``: 4-byte C enum
  (``tensor_query_common.h:46-56``):
  0 REQUEST_INFO, 1 RESPOND_APPROVE, 2 RESPOND_DENY, 3 TRANSFER_START,
  4 TRANSFER_DATA, 5 TRANSFER_END, 6 CLIENT_ID
- cmd in {REQUEST_INFO, APPROVE, DENY, TRANSFER_DATA}: ``size_t`` (u64)
  byte count, then that many raw bytes (caps strings are sent
  NUL-terminated; tensor data is raw)
- cmd in {TRANSFER_START, TRANSFER_END}: the 176-byte
  ``TensorQueryDataInfo`` struct — i64 base_time, i64 sent_time,
  u64 duration, u64 dts, u64 pts, u32 num_mems, 4 bytes of alignment
  padding, u64 mem_sizes[16] (``tensor_query_common.h:60-71``,
  NNS_TENSOR_SIZE_LIMIT=16)
- cmd CLIENT_ID: ``query_client_id_t`` = i64 (``tensor_meta.h:21``)

Conversation shape (client = ``tensor_query_client.c:377-445``):

- client → server-src port: server sends CLIENT_ID first (id =
  monotonic time in the reference; any i64 works), client sends
  REQUEST_INFO with its in-caps string, server replies APPROVE with its
  sink caps (or DENY with its src caps)
- client → server-sink port (a SECOND connection): client sends
  CLIENT_ID with the id it was assigned, then reads result buffers
- buffers (either direction): TRANSFER_START(data_info) +
  num_mems × TRANSFER_DATA + TRANSFER_END(data_info)
  (``tensor_query_common.c:976-1100``)

Unlike our ``NTQ1`` framing (query/protocol.py) the reference wire
carries NO per-tensor meta — memory chunks are raw bytes whose
shapes/dtypes come from the negotiated caps, exactly as the reference's
serversrc trusts its configured caps.

A port of the JAX package's module: the frames are byte-identical to its
frames. The port has the pure-Python server only; the JAX package's
native epoll core, which approves every caps, is ROADMAP 26e. Where the
port differs from the JAX module (ROADMAP queue C):

- a ``TensorQueryDataInfo`` announcing more than 16 memories raises
  :class:`RefWireError`, as the C parser refuses it (C.36);
- the client sends only fixated caps (:func:`fixated_caps_string`), since
  a reference server cannot parse a list or a range in this package's
  caps text (C.37);
- a result waits for its client's sink connection to be claimed rather
  than being dropped when it is ready first (C.39);
- APPROVE announces the server pipeline's output caps (its serversink's)
  once they are negotiated, as the reference server does, so a client
  types results whose shape differs from its input (C.40).
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

import torch

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.pipeline.caps import ANY, IntRange
from nnstreamer_tpu_torch.query.protocol import QueryProtocolError
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensors.types import TensorType

log = get_logger("query.refwire")

# TensorQueryCommand (tensor_query_common.h:46-56)
CMD_REQUEST_INFO = 0
CMD_RESPOND_APPROVE = 1
CMD_RESPOND_DENY = 2
CMD_TRANSFER_START = 3
CMD_TRANSFER_DATA = 4
CMD_TRANSFER_END = 5
CMD_CLIENT_ID = 6

NNS_TENSOR_SIZE_LIMIT = 16  # tensor_typedef.h:35

_CMD = struct.Struct("<i")          # C enum: 4-byte int, native endian
_SIZE = struct.Struct("<Q")         # size_t on LP64
_CLIENT_ID = struct.Struct("<q")    # query_client_id_t = int64
#: TensorQueryDataInfo: i64 base_time, i64 sent_time, u64 duration,
#: u64 dts, u64 pts, u32 num_mems, 4-byte alignment hole, u64[16]
_DATA_INFO = struct.Struct("<qqQQQI4x16Q")
DATA_INFO_SIZE = _DATA_INFO.size  # 176

#: GStreamer's GST_CLOCK_TIME_NONE — unset pts/dts on the wire
CLOCK_NONE = 0xFFFFFFFFFFFFFFFF

#: seconds a result waits for its client's sink connection to be claimed
SINK_CLAIM_WAIT_S = 10.0


def _cstr(body: bytes) -> str:
    """Decode a wire C-string: bytes up to the first NUL."""
    return body.split(b"\0", 1)[0].decode(errors="replace")


class RefWireError(QueryProtocolError):
    """Wire violation — subclasses QueryProtocolError so the query
    client's retry/failover paths treat both wires uniformly."""


def pack_data_info(num_mems: int, mem_sizes: List[int],
                   pts: Optional[int] = None, dts: Optional[int] = None,
                   duration: Optional[int] = None,
                   base_time: int = 0, sent_time: int = 0) -> bytes:
    sizes = list(mem_sizes) + [0] * (NNS_TENSOR_SIZE_LIMIT - len(mem_sizes))
    return _DATA_INFO.pack(
        base_time, sent_time,
        CLOCK_NONE if duration is None else duration,
        CLOCK_NONE if dts is None else dts,
        CLOCK_NONE if pts is None else pts,
        num_mems, *sizes)


def unpack_data_info(raw: bytes) -> dict:
    vals = _DATA_INFO.unpack(raw)
    base_time, sent_time, duration, dts, pts, num_mems = vals[:6]
    if num_mems > NNS_TENSOR_SIZE_LIMIT:
        raise RefWireError(f"data info announces {num_mems} memories, "
                           f"more than the limit {NNS_TENSOR_SIZE_LIMIT}")
    return dict(
        base_time=base_time, sent_time=sent_time,
        duration=None if duration == CLOCK_NONE else duration,
        dts=None if dts == CLOCK_NONE else dts,
        pts=None if pts == CLOCK_NONE else pts,
        num_mems=num_mems, mem_sizes=list(vals[6:6 + num_mems]))


# -- socket I/O -------------------------------------------------------------

def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        part = sock.recv(min(n, 1 << 20))
        if not part:
            raise RefWireError("peer closed mid-message")
        chunks.append(part)
        n -= len(part)
    return b"".join(chunks)


def send_cmd(sock: socket.socket, cmd: int, payload: bytes = b"") -> None:
    """Send one reference-framed message (cmd decides the body form)."""
    parts = [_CMD.pack(cmd)]
    if cmd in (CMD_REQUEST_INFO, CMD_RESPOND_APPROVE, CMD_RESPOND_DENY,
               CMD_TRANSFER_DATA):
        parts.append(_SIZE.pack(len(payload)))
        parts.append(payload)
    elif cmd in (CMD_TRANSFER_START, CMD_TRANSFER_END):
        if len(payload) != DATA_INFO_SIZE:
            raise RefWireError(
                f"data_info must be {DATA_INFO_SIZE} bytes")
        parts.append(payload)
    elif cmd == CMD_CLIENT_ID:
        if len(payload) != _CLIENT_ID.size:
            raise RefWireError("client id must be 8 bytes")
        parts.append(payload)
    else:
        raise RefWireError(f"unknown command {cmd}")
    sock.sendall(b"".join(parts))


def recv_cmd(sock: socket.socket,
             max_data: int = 1 << 33) -> Tuple[int, bytes]:
    """Receive one reference-framed message → (cmd, body bytes)."""
    (cmd,) = _CMD.unpack(_recv_exact(sock, _CMD.size))
    if cmd in (CMD_REQUEST_INFO, CMD_RESPOND_APPROVE, CMD_RESPOND_DENY,
               CMD_TRANSFER_DATA):
        (size,) = _SIZE.unpack(_recv_exact(sock, _SIZE.size))
        if size > max_data:
            raise RefWireError(f"oversized payload {size}")
        return cmd, _recv_exact(sock, int(size))
    if cmd in (CMD_TRANSFER_START, CMD_TRANSFER_END):
        return cmd, _recv_exact(sock, DATA_INFO_SIZE)
    if cmd == CMD_CLIENT_ID:
        return cmd, _recv_exact(sock, _CLIENT_ID.size)
    raise RefWireError(f"unknown command {cmd} from peer")


# -- whole-buffer transfer (tensor_query_common.c:976-1100) -----------------

def pack_buffer_frames(mems: List[bytes], pts: Optional[int] = None,
                       dts: Optional[int] = None,
                       duration: Optional[int] = None) -> bytes:
    """The complete TRANSFER_START + DATA× + END byte sequence for one
    buffer, as a single blob (:func:`send_buffer` sends it verbatim)."""
    info = pack_data_info(len(mems), [len(m) for m in mems], pts=pts,
                          dts=dts, duration=duration,
                          sent_time=time.monotonic_ns() // 1000)
    parts = [_CMD.pack(CMD_TRANSFER_START), info]
    for m in mems:
        parts.append(_CMD.pack(CMD_TRANSFER_DATA))
        parts.append(_SIZE.pack(len(m)))
        parts.append(m)
    parts.append(_CMD.pack(CMD_TRANSFER_END))
    parts.append(info)
    return b"".join(parts)


def send_buffer(sock: socket.socket, mems: List[bytes],
                pts: Optional[int] = None, dts: Optional[int] = None,
                duration: Optional[int] = None) -> int:
    """Send one buffer's frames; returns the bytes written."""
    raw = pack_buffer_frames(mems, pts=pts, dts=dts, duration=duration)
    sock.sendall(raw)
    return len(raw)


def recv_buffer(sock: socket.socket) -> Tuple[dict, List[bytes]]:
    cmd, raw = recv_cmd(sock)
    if cmd != CMD_TRANSFER_START:
        raise RefWireError(f"expected TRANSFER_START, got {cmd}")
    info = unpack_data_info(raw)
    mems = []
    for i in range(info["num_mems"]):
        cmd, data = recv_cmd(sock)
        if cmd != CMD_TRANSFER_DATA:
            raise RefWireError(f"expected TRANSFER_DATA, got {cmd}")
        if len(data) != info["mem_sizes"][i]:
            raise RefWireError(
                f"mem {i}: announced {info['mem_sizes'][i]} bytes, "
                f"got {len(data)}")
        mems.append(data)
    cmd, _ = recv_cmd(sock)
    if cmd != CMD_TRANSFER_END:
        raise RefWireError(f"expected TRANSFER_END, got {cmd}")
    return info, mems


# -- caps ↔ tensor reconstruction ------------------------------------------

def _raw_bytes(t) -> bytes:
    if isinstance(t, torch.Tensor):  # a host bfloat16 tensor
        return t.detach().contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(t)).tobytes()


def buffer_to_mems(buf: TensorBuffer) -> List[bytes]:
    """Raw per-tensor bytes of a host buffer (the wire carries no meta —
    shapes/dtypes ride in the negotiated caps, reference serversrc
    semantics)."""
    return [_raw_bytes(t) for t in buf.tensors]


def mems_to_buffer(mems: List[bytes], config,
                   info: Optional[dict] = None) -> TensorBuffer:
    """Reassemble tensors from raw memory chunks using a negotiated
    :class:`~nnstreamer_tpu_torch.tensors.types.TensorsConfig`
    (shapes/dtypes per caps, like the reference's serversrc trusting its
    caps). A ``bfloat16`` tensor comes back as a CPU torch tensor."""
    tensors = []
    infos = list(config.info.infos)[:len(mems)]
    for raw, ti in zip(mems, infos):
        if ti.type is TensorType.BFLOAT16:
            if len(raw) != ti.size:
                raise ValueError(f"{len(raw)} bytes for a bfloat16 "
                                 f"tensor of shape {ti.shape}")
            arr = torch.frombuffer(bytearray(raw), dtype=torch.bfloat16)
        else:
            arr = np.frombuffer(raw, dtype=ti.type.np_dtype)
        tensors.append(arr.reshape(ti.shape))
    # extra mems beyond the caps (shouldn't happen) stay raw u8
    for raw in mems[len(infos):]:
        tensors.append(np.frombuffer(raw, dtype=np.uint8))
    pts = info.get("pts") if info else None
    dts = info.get("dts") if info else None
    dur = info.get("duration") if info else None
    return TensorBuffer(tensors, pts=pts, dts=dts, duration=dur)


def fixated_caps_string(caps) -> str:
    """The caps text a client announces in REQUEST_INFO. Only fixated
    caps are sent: a list, a range or ``ANY`` raises naming the field,
    because this package's caps text spells them in a form a reference
    server cannot parse."""
    for key, value in caps.fields.items():
        if value is ANY or isinstance(value, (list, tuple, IntRange)):
            raise RefWireError(
                f"caps field {key}={value!r} is not fixated; the reference "
                "wire sends fixated caps only")
    return caps.to_string()


# -- client (tensor_query_client.c:377-445 flow) ----------------------------

class RefWireClient:
    """Offload client speaking the reference wire: two connections
    (server src + server sink ports), caps handshake, buffers out on
    src, results in on sink."""

    def __init__(self, src_host: str, src_port: int,
                 sink_host: Optional[str] = None,
                 sink_port: Optional[int] = None,
                 in_caps: str = "", timeout: float = 10.0):
        self.timeout = timeout
        self.client_id: Optional[int] = None
        self.server_caps: Optional[str] = None
        self._src = socket.create_connection((src_host, src_port),
                                             timeout=timeout)
        self._src.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            cmd, body = recv_cmd(self._src)
            if cmd != CMD_CLIENT_ID:
                raise RefWireError(f"expected CLIENT_ID first, got {cmd}")
            (self.client_id,) = _CLIENT_ID.unpack(body)
            send_cmd(self._src, CMD_REQUEST_INFO,
                     in_caps.encode() + b"\0")
            cmd, body = recv_cmd(self._src)
            if cmd == CMD_RESPOND_DENY:
                raise RefWireError(
                    f"server denied caps: {_cstr(body)}")
            if cmd != CMD_RESPOND_APPROVE:
                raise RefWireError(f"expected APPROVE, got {cmd}")
            self.server_caps = _cstr(body)
            self._sink = socket.create_connection(
                (sink_host or src_host,
                 sink_port if sink_port is not None else src_port + 1),
                timeout=timeout)
            self._sink.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                                  1)
            send_cmd(self._sink, CMD_CLIENT_ID,
                     _CLIENT_ID.pack(self.client_id))
        except Exception:
            self.close()
            raise

    def send(self, mems: List[bytes], pts: Optional[int] = None) -> int:
        """Send one buffer; returns the bytes written."""
        return send_buffer(self._src, mems, pts=pts)

    def recv_result(self) -> Tuple[dict, List[bytes]]:
        return recv_buffer(self._sink)

    def close(self) -> None:
        for s in (getattr(self, "_src", None),
                  getattr(self, "_sink", None)):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass


# -- server (pure-Python transport) ------------------------------------------

class RefWireQueryServer:
    """Reference-wire query server: src port (handshake + inbound
    buffers) and sink port (client-id claim + result routing), the
    two-port topology of tensor_query_serversrc/serversink."""

    def __init__(self, host: str = "0.0.0.0", src_port: int = 0,
                 sink_port: int = 0, caps_str: str = "",
                 max_queue: int = 64):
        self.host = host
        self.caps_str = caps_str
        #: the server pipeline's output caps (its serversink's), which
        #: APPROVE announces once known: the caps a client types its
        #: results with (empty: announce ``caps_str``)
        self.sink_caps_str = ""
        self.incoming: queue.Queue = queue.Queue(maxsize=max_queue)
        self._sinks = {}
        #: live src-port connections by client id — stop() must shut
        #: them down (close alone does not wake a blocked recv) or each
        #: client leaks a thread + ESTABLISHED socket per server cycle
        self._srcs = {}
        self._lock = threading.Lock()
        #: signalled when a sink connection claims its id or a src
        #: connection ends (send_result waits on it)
        self._sink_claimed = threading.Condition(self._lock)
        self._next_id = 1
        self._stop = threading.Event()
        self._threads = []
        self._src_listener = self._listen(host, src_port)
        self._sink_listener = self._listen(host, sink_port)
        self.src_port = self._src_listener.getsockname()[1]
        self.sink_port = self._sink_listener.getsockname()[1]

    @staticmethod
    def _listen(host, port):
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, port))
        s.listen(16)
        s.settimeout(0.2)
        return s

    def start(self) -> "RefWireQueryServer":
        self._stop.clear()
        for name, fn in (("refwire-src-accept", self._src_accept),
                         ("refwire-sink-accept", self._sink_accept)):
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()
        for s in (self._src_listener, self._sink_listener):
            try:
                s.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self._sinks.values()) + list(self._srcs.values())
            self._sink_claimed.notify_all()
            self._sinks.clear()
            self._srcs.clear()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        try:
            self.incoming.put_nowait(None)
        except queue.Full:  # consumer is not blocked on us; nothing to do
            pass

    # -- src port ----------------------------------------------------------
    def _src_accept(self):
        while not self._stop.is_set():
            try:
                conn, addr = self._src_listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                cid = self._next_id
                self._next_id += 1
                self._srcs[cid] = conn
            threading.Thread(target=self._src_loop, args=(cid, conn),
                             name=f"refwire-src-{cid}",
                             daemon=True).start()
            log.info("refwire client %d connected from %s", cid, addr)

    def _caps_acceptable(self, client_caps: str) -> bool:
        """The reference's admission test (tensor_query_common.c:770-803):
        the client's announced caps must config-equal or caps-intersect
        the server's (framerate ignored — TensorsConfig.is_equal never
        compares rate). Permissive when either side is unparseable: our
        caps grammar must not reject a conformant reference peer over a
        spelling it doesn't know."""
        if not self.caps_str or not client_caps.strip():
            # no server caps to gate on / client hasn't negotiated its
            # own caps yet (our client announces "" pre-negotiation)
            return True
        try:
            from nnstreamer_tpu_torch.pipeline.parse import (
                parse_caps_string,
            )
            from nnstreamer_tpu_torch.tensors.types import TensorsConfig

            server = parse_caps_string(self.caps_str)
            client = parse_caps_string(client_caps)
        except Exception:  # noqa: BLE001 — be liberal in what we accept
            return True
        try:
            if TensorsConfig.from_caps(server).is_equal(
                    TensorsConfig.from_caps(client)):
                return True
        except (ValueError, KeyError, TypeError):
            pass  # not tensor caps on one side; fall back to intersect
        return server.intersect(client) is not None

    def _src_loop(self, cid: int, conn: socket.socket):
        try:
            # reference serversrc sends the client id immediately on
            # accept (tensor_query_client.c:393-401 expects it first)
            send_cmd(conn, CMD_CLIENT_ID, _CLIENT_ID.pack(cid))
            while not self._stop.is_set():
                cmd, body = recv_cmd(conn)
                if cmd == CMD_REQUEST_INFO:
                    client_caps = _cstr(body)
                    if not self._caps_acceptable(client_caps):
                        # reference replies DENY with its own caps
                        # (tensor_query_common.c:801-803)
                        log.warning(
                            "refwire client %d caps %r rejected vs "
                            "server %r", cid, client_caps, self.caps_str)
                        send_cmd(conn, CMD_RESPOND_DENY,
                                 self.caps_str.encode() + b"\0")
                        continue
                    send_cmd(conn, CMD_RESPOND_APPROVE,
                             (self.sink_caps_str or self.caps_str).encode()
                             + b"\0")
                elif cmd == CMD_TRANSFER_START:
                    info = unpack_data_info(body)
                    mems = []
                    for i in range(info["num_mems"]):
                        c2, data = recv_cmd(conn)
                        if c2 != CMD_TRANSFER_DATA:
                            raise RefWireError(
                                f"expected TRANSFER_DATA, got {c2}")
                        if len(data) != info["mem_sizes"][i]:
                            raise RefWireError(
                                f"mem {i}: announced "
                                f"{info['mem_sizes'][i]} bytes, got "
                                f"{len(data)}")
                        mems.append(data)
                    c2, _ = recv_cmd(conn)
                    if c2 != CMD_TRANSFER_END:
                        raise RefWireError(
                            f"expected TRANSFER_END, got {c2}")
                    self.incoming.put((cid, info, mems))
                else:
                    raise RefWireError(f"unexpected command {cmd}")
        except (RefWireError, OSError) as e:
            log.info("refwire client %d disconnected: %s", cid, e)
        finally:
            with self._lock:
                self._srcs.pop(cid, None)
                self._sink_claimed.notify_all()
            try:
                conn.close()
            except OSError:
                pass

    # -- sink port ---------------------------------------------------------
    def _sink_accept(self):
        while not self._stop.is_set():
            try:
                conn, _addr = self._sink_listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            try:
                conn.settimeout(10.0)
                cmd, body = recv_cmd(conn)
                if cmd != CMD_CLIENT_ID:
                    raise RefWireError(
                        f"sink connection must claim CLIENT_ID, got {cmd}")
                (cid,) = _CLIENT_ID.unpack(body)
                conn.settimeout(None)
            except (RefWireError, OSError) as e:
                log.warning("refwire sink handshake failed: %s", e)
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            with self._lock:
                old = self._sinks.pop(cid, None)
                self._sinks[cid] = conn
                self._sink_claimed.notify_all()
            if old is not None:
                try:
                    old.close()
                except OSError:
                    pass

    # -- results -----------------------------------------------------------
    def send_result(self, client_id: int, mems: List[bytes],
                    pts: Optional[int] = None) -> bool:
        with self._lock:
            # a client opens its sink connection right after APPROVE, and
            # may send its first buffer before the sink-accept thread has
            # taken that connection: wait for the claim while the client's
            # src connection lives, rather than drop the result
            self._sink_claimed.wait_for(
                lambda: client_id in self._sinks  # nns-lint: disable=NNS201 -- wait_for runs its predicate with the condition's lock, self._lock, held
                or client_id not in self._srcs or self._stop.is_set(),
                timeout=SINK_CLAIM_WAIT_S)
            conn = self._sinks.get(client_id)
        if conn is None:
            log.warning("refwire result for unknown client %d dropped",
                        client_id)
            return False
        try:
            send_buffer(conn, mems, pts=pts)
            return True
        except OSError as e:
            log.warning("refwire send to client %d failed: %s",
                        client_id, e)
            return False

    def get(self, timeout: Optional[float] = None):
        try:
            return self.incoming.get(timeout=timeout)
        except queue.Empty:
            return None
