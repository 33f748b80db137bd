"""tensor_query wire protocol — framed tensors over TCP.

Reference: ``gst/nnstreamer/tensor_query/tensor_query_common.c`` (1107 LoC):
a custom framed TCP protocol with commands REQUEST_INFO / RESPOND_APPROVE /
RESPOND_DENY / TRANSFER_START / TRANSFER_DATA / TRANSFER_END / CLIENT_ID
(tensor_query_common.h:46-56), caps-string exchange for negotiation, and
per-buffer DataInfo (pts/dts/num_mems/sizes, :57-71).

Our framing (little-endian):
  u32 magic 'NTQ1'  u32 command  u64 payload_len  payload…

Buffer payloads serialize as: i64 pts, i64 dts, i64 duration (−1 = unset),
u32 num_tensors, then per-tensor TensorMetaInfo header + raw bytes (the
flex-header framing from ``tensors.meta``). Caps exchange sends the caps
repr string; APPROVE echoes the server's src caps.

The port of the JAX package's wire, byte for byte, so clients and servers
of the two packages talk to each other: the classic commands 1-8 and the
resilient extension 9-14 (``query/resilience.py``, ``obs/distributed.py``),
which a client speaks only when asked (``reliable=true``). On a blocking
socket (``gettimeout() is None``) a frame is written with the native
library's GIL-free ``writev`` and read with its GIL-free ``recv``
(``native.py``), as in the JAX package; a socket with a timeout, or a
process without the library, takes ``sendall``/``recv_into``. The bytes
are the same on both paths.
"""

from __future__ import annotations

import enum
import socket
import struct
from typing import Tuple

from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensors.meta import pack_tensor, unpack_tensor

_MAGIC = 0x4E545131  # 'NTQ1'
_HDR = struct.Struct("<IIQ")
_BUF_HDR = struct.Struct("<qqqI")

DEFAULT_TIMEOUT = 10.0  # reference QUERY_DEFAULT_TIMEOUT (tensor_query_common.h:30)


class Cmd(enum.IntEnum):
    REQUEST_INFO = 1
    APPROVE = 2
    DENY = 3
    TRANSFER = 4   # one whole buffer (start+data+end collapsed into a frame)
    RESULT = 5
    CLIENT_ID = 6
    PING = 7
    BYE = 8
    # -- resilient extension (query/resilience.py) — a client that never
    # sets a resilience knob never emits these, so the classic wire
    # (commands 1-8) stays byte-identical to pre-extension builds
    HELLO = 9        # "<instance>:<dedup window>"; server echoes HELLO
    TRANSFER_EX = 10  # ext header (req_id, slack_s) + classic buffer
    RESULT_EX = 11    # ext header (req_id, -1) + classic buffer
    EXPIRED = 12      # ext header only: deadline missed, frame shed
    # -- distributed-trace extension (obs/distributed.py) — only spoken
    # after BOTH sides advertised the "dt1" feature in the HELLO
    # exchange, so a peer without it (or NNSTPU_DIST_TRACE=0) keeps every
    # wire byte identical to the resilient protocol above
    TRANSFER_EX2 = 13  # ext2 header + trace blob + classic buffer
    RESULT_EX2 = 14    # ext2 header + remote span blob + classic buffer


#: extended-command header: u64 request id + f64 deadline slack in
#: seconds (negative = no deadline; 0.0 = already expired at send time)
_EXT_HDR = struct.Struct("<Qd")

#: distributed-trace header: the _EXT_HDR pair plus a u64 trace/frame id
#: (the client Timeline's frame seq, globally qualified by instance) and
#: a f64 wall-clock stamp (epoch seconds: client send time on
#: TRANSFER_EX2, remote receive time on RESULT_EX2). Wall stamps are
#: *advisory* — the splice only ever uses them to split wire time inside
#: the client's observed RTT window, never as absolute anchors.
_EXT2_HDR = struct.Struct("<QdQd")

#: length prefix for the variable trace blob that follows _EXT2_HDR
_BLOB_LEN = struct.Struct("<I")


class QueryProtocolError(RuntimeError):
    pass


def pack_ext(req_id: int, slack_s: float, body: bytes = b"") -> bytes:
    return _EXT_HDR.pack(req_id, slack_s) + body


def unpack_ext(payload: bytes) -> Tuple[int, float, bytes]:
    if len(payload) < _EXT_HDR.size:
        raise QueryProtocolError("short extended header")
    req_id, slack_s = _EXT_HDR.unpack_from(payload)
    return req_id, slack_s, payload[_EXT_HDR.size:]


def pack_ext2(req_id: int, slack_s: float, trace_id: int, stamp: float,
              blob: bytes = b"", body: bytes = b"") -> bytes:
    return (_EXT2_HDR.pack(req_id, slack_s, trace_id, stamp)
            + _BLOB_LEN.pack(len(blob)) + blob + body)


def unpack_ext2(payload: bytes
                ) -> Tuple[int, float, int, float, bytes, bytes]:
    if len(payload) < _EXT2_HDR.size + _BLOB_LEN.size:
        raise QueryProtocolError("short extended-trace header")
    req_id, slack_s, trace_id, stamp = _EXT2_HDR.unpack_from(payload)
    off = _EXT2_HDR.size
    (blob_len,) = _BLOB_LEN.unpack_from(payload, off)
    off += _BLOB_LEN.size
    if len(payload) < off + blob_len:
        raise QueryProtocolError("short trace blob")
    blob = payload[off:off + blob_len]
    return req_id, slack_s, trace_id, stamp, blob, payload[off + blob_len:]


def _check_cmd(cmd: int) -> Cmd:
    try:
        return Cmd(cmd)
    except ValueError:
        raise QueryProtocolError(f"unknown query command {cmd}") from None


def send_msg(sock: socket.socket, cmd: Cmd, payload: bytes = b"") -> int:
    """Send one frame; returns the bytes written (header included)."""
    from nnstreamer_tpu_torch import native

    cmd = _check_cmd(int(cmd))
    native.send_frame(sock, _MAGIC, int(cmd), bytes(payload))
    return _HDR.size + len(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(n - got, 1 << 20))
        if not k:
            raise QueryProtocolError("connection closed mid-frame")
        got += k
    return bytes(buf)


def _recv_native(lib, sock: socket.socket) -> Tuple[int, int, bytes]:
    """One frame read by the native library (a blocking socket only:
    its C side retries EINTR alone)."""
    import ctypes

    hdr = bytearray(_HDR.size)
    if lib.nnstpu_recv_header(
            sock.fileno(), (ctypes.c_char * _HDR.size).from_buffer(hdr)):
        raise QueryProtocolError("connection closed mid-frame")
    magic, cmd, plen = _HDR.unpack(hdr)
    if magic != _MAGIC:
        raise QueryProtocolError(f"bad magic {magic:#x}")
    payload = bytearray(plen)
    if plen and lib.nnstpu_recv_payload(
            sock.fileno(), (ctypes.c_char * plen).from_buffer(payload),
            plen):
        raise QueryProtocolError("connection closed mid-frame")
    return magic, cmd, bytes(payload)


def recv_msg(sock: socket.socket) -> Tuple[Cmd, bytes]:
    from nnstreamer_tpu_torch import native

    lib = native.get_lib()
    if lib is not None and sock.gettimeout() is None:
        _, cmd, payload = _recv_native(lib, sock)
        return _check_cmd(cmd), payload
    magic, cmd, plen = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if magic != _MAGIC:
        raise QueryProtocolError(f"bad magic {magic:#x}")
    cmd = _check_cmd(cmd)
    payload = _recv_exact(sock, plen) if plen else b""
    return cmd, payload


# -- buffer (de)serialization ----------------------------------------------
def pack_buffer(buf: TensorBuffer) -> bytes:
    """Serialize a frame; device tensors are copied to the host once (and a
    deferred finalize applied) by ``to_host``."""
    host = buf.to_host()
    parts = [_BUF_HDR.pack(
        -1 if buf.pts is None else buf.pts,
        -1 if buf.dts is None else buf.dts,
        -1 if buf.duration is None else buf.duration,
        host.num_tensors,
    )]
    for t in host.tensors:
        parts.append(pack_tensor(t))
    return b"".join(parts)


def unpack_buffer(payload: bytes) -> TensorBuffer:
    pts, dts, dur, n = _BUF_HDR.unpack_from(payload)
    offset = _BUF_HDR.size
    tensors = []
    for _ in range(n):
        arr, offset = unpack_tensor(payload, offset)
        tensors.append(arr)
    return TensorBuffer(
        tensors,
        pts=None if pts < 0 else pts,
        dts=None if dts < 0 else dts,
        duration=None if dur < 0 else dur,
    )


def send_buffer(sock: socket.socket, buf: TensorBuffer,
                cmd: Cmd = Cmd.TRANSFER) -> int:
    """Send one buffer frame; returns the bytes written (header included)."""
    return send_msg(sock, cmd, pack_buffer(buf))


def connect(host: str, port: int, timeout: float = DEFAULT_TIMEOUT
            ) -> socket.socket:
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock
