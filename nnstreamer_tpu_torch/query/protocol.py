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

The port of the JAX package's classic wire (commands 1-8), byte for byte,
so clients and servers of the two packages talk to each other. Frames go
through plain ``sendall``/``recv``; the JAX package's native ``.so`` path
waits for ROADMAP item 26e. Commands 9-14 (the resilient transport and its
trace extension) are not ported: sending or receiving one raises
:class:`QueryProtocolError` naming ROADMAP item 26a.
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

#: the ROADMAP item that brings commands 9-14
RESILIENT_ITEM = "26a resilient transport"


class Cmd(enum.IntEnum):
    REQUEST_INFO = 1
    APPROVE = 2
    DENY = 3
    TRANSFER = 4   # one whole buffer (start+data+end collapsed into a frame)
    RESULT = 5
    CLIENT_ID = 6
    PING = 7
    BYE = 8
    # -- the resilient extension and its trace variant: not ported
    HELLO = 9
    TRANSFER_EX = 10
    RESULT_EX = 11
    EXPIRED = 12
    TRANSFER_EX2 = 13
    RESULT_EX2 = 14


class QueryProtocolError(RuntimeError):
    pass


def _check_classic(cmd: int) -> Cmd:
    try:
        cmd = Cmd(cmd)
    except ValueError:
        raise QueryProtocolError(f"unknown query command {cmd}") from None
    if cmd >= Cmd.HELLO:
        raise QueryProtocolError(
            f"query command {cmd.name} belongs to the resilient transport, "
            f"which is not ported to nnstreamer_tpu_torch yet (ROADMAP.md, "
            f"{RESILIENT_ITEM})")
    return cmd


def send_msg(sock: socket.socket, cmd: Cmd, payload: bytes = b"") -> None:
    cmd = _check_classic(int(cmd))
    sock.sendall(_HDR.pack(_MAGIC, int(cmd), len(payload)) + payload)


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


def recv_msg(sock: socket.socket) -> Tuple[Cmd, bytes]:
    magic, cmd, plen = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if magic != _MAGIC:
        raise QueryProtocolError(f"bad magic {magic:#x}")
    cmd = _check_classic(cmd)
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
    payload = pack_buffer(buf)
    send_msg(sock, cmd, payload)
    return _HDR.size + len(payload)


def connect(host: str, port: int, timeout: float = DEFAULT_TIMEOUT
            ) -> socket.socket:
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock
