"""MQTT 3.1.1 — real protocol framing for the pubsub elements.

Reference: ``gst/mqtt/mqttsink.c`` / ``mqttsrc.c`` speak MQTT through
paho; their payloads prepend the fixed 1024-byte ``GstMQTTMessageHdr``
(``gst/mqtt/mqttcommon.h:49-63``) so any subscriber can reconstruct the
buffer. This module provides the same capability without paho:

- **packet codec** — CONNECT/CONNACK/SUBSCRIBE/SUBACK/PUBLISH(QoS0/
  QoS1, retain)/PUBACK/PING*/DISCONNECT encode+decode per the MQTT
  3.1.1 spec (unit-tested always; any conformant broker understands
  them);
- :class:`MqttClient` — a minimal client (same surface as the in-process
  shim's ``Client``) usable against any broker reachable at
  ``mqtt://host:port``;
- :class:`MqttBroker` — an in-process broker speaking real MQTT, for
  loopback tests and brokerless deployments;
- ``pack_gst_mqtt_message`` / ``parse_gst_mqtt_message`` — the reference
  header layout, byte-exact (num_mems, size_mems[16], base/sent epochs,
  duration/dts/pts, 512-byte caps string, 1024 bytes total), so streams
  interop with reference mqttsink/mqttsrc peers.

QoS0 is the stream default (tensor streams are latest-wins, matching
the reference's default); QoS1 (packet id + PUBACK + DUP retransmit)
is available per publish/subscribe for control-plane topics, with
client auto-reconnect/resubscribe and active keepalive failure
detection mirroring the reference's paho MQTTAsync options
(gst/mqtt/mqttsink.c).

Port of ``nnstreamer_tpu/query/mqtt.py``: a copy with its imports
rewritten.
"""

from __future__ import annotations

import socket
import struct
import sys
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Tuple

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.pipeline import faults as _faults

log = get_logger("mqtt")

# MQTT 3.1.1 control packet types (spec table 2.1)
CONNECT = 1
CONNACK = 2
PUBLISH = 3
PUBACK = 4
SUBSCRIBE = 8
SUBACK = 9
UNSUBSCRIBE = 10
UNSUBACK = 11
PINGREQ = 12
PINGRESP = 13
DISCONNECT = 14

PROTOCOL_NAME = b"\x00\x04MQTT"
PROTOCOL_LEVEL = 4  # 3.1.1


# ---------------------------------------------------------------------------
# Packet codec
# ---------------------------------------------------------------------------

def encode_varlen(n: int) -> bytes:
    """Remaining-length varint (spec 2.2.3), 1-4 bytes."""
    if not 0 <= n <= 268_435_455:
        raise ValueError(f"mqtt: remaining length {n} out of range")
    out = bytearray()
    while True:
        n, digit = divmod(n, 128)
        out.append(digit | (0x80 if n else 0))
        if not n:
            return bytes(out)


def decode_varlen(data: bytes, offset: int = 0) -> Tuple[int, int]:
    """→ (value, bytes consumed); raises on malformed/truncated input."""
    value = 0
    for i in range(4):
        if offset + i >= len(data):
            raise ValueError("mqtt: truncated remaining length")
        byte = data[offset + i]
        value |= (byte & 0x7F) << (7 * i)
        if not byte & 0x80:
            return value, i + 1
    raise ValueError("mqtt: malformed remaining length")


def _utf8(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">H", len(b)) + b


def _packet(ptype: int, flags: int, body: bytes) -> bytes:
    return bytes([(ptype << 4) | flags]) + encode_varlen(len(body)) + body


def connect_packet(client_id: str, keepalive: int = 60,
                   clean_session: bool = True) -> bytes:
    flags = 0x02 if clean_session else 0x00
    body = (PROTOCOL_NAME + bytes([PROTOCOL_LEVEL, flags]) +
            struct.pack(">H", keepalive) + _utf8(client_id))
    return _packet(CONNECT, 0, body)


def connack_packet(return_code: int = 0,
                   session_present: bool = False) -> bytes:
    return _packet(CONNACK, 0,
                   bytes([1 if session_present else 0, return_code]))


def publish_packet(topic: str, payload: bytes, retain: bool = False,
                   qos: int = 0, packet_id: Optional[int] = None,
                   dup: bool = False) -> bytes:
    """PUBLISH. QoS0 carries no packet id (spec 3.3.2.2); QoS1 requires
    one and may set DUP on retransmission (3.3.1.1)."""
    flags = (0x01 if retain else 0) | ((qos & 0x03) << 1) | \
        (0x08 if dup else 0)
    body = _utf8(topic)
    if qos:
        if packet_id is None:
            raise ValueError("mqtt: QoS>0 PUBLISH needs a packet id")
        body += struct.pack(">H", packet_id)
    return _packet(PUBLISH, flags, body + payload)


def puback_packet(packet_id: int) -> bytes:
    return _packet(PUBACK, 0, struct.pack(">H", packet_id))


def subscribe_packet(packet_id: int, topic_filter: str,
                     qos: int = 0) -> bytes:
    body = struct.pack(">H", packet_id) + _utf8(topic_filter) + bytes([qos])
    return _packet(SUBSCRIBE, 0x02, body)  # reserved flags 0010 (3.8.1)


def suback_packet(packet_id: int, return_codes: List[int]) -> bytes:
    return _packet(SUBACK, 0,
                   struct.pack(">H", packet_id) + bytes(return_codes))


def unsubscribe_packet(packet_id: int, topic_filter: str) -> bytes:
    return _packet(UNSUBSCRIBE, 0x02,
                   struct.pack(">H", packet_id) + _utf8(topic_filter))


def unsuback_packet(packet_id: int) -> bytes:
    return _packet(UNSUBACK, 0, struct.pack(">H", packet_id))


def pingreq_packet() -> bytes:
    return _packet(PINGREQ, 0, b"")


def pingresp_packet() -> bytes:
    return _packet(PINGRESP, 0, b"")


def disconnect_packet() -> bytes:
    return _packet(DISCONNECT, 0, b"")


def read_packet(sock: socket.socket) -> Optional[Tuple[int, int, bytes]]:
    """Blocking read of one packet → (type, flags, body) or None on EOF."""
    first = _read_exact(sock, 1)
    if first is None:
        return None
    ptype, flags = first[0] >> 4, first[0] & 0x0F
    length = 0
    for i in range(4):
        b = _read_exact(sock, 1)
        if b is None:
            return None
        length |= (b[0] & 0x7F) << (7 * i)
        if not b[0] & 0x80:
            break
    else:
        raise ValueError("mqtt: malformed remaining length")
    body = _read_exact(sock, length) if length else b""
    if body is None:
        return None
    return ptype, flags, body


def _read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


def parse_publish(flags: int, body: bytes
                  ) -> Tuple[str, bytes, bool, int, Optional[int]]:
    """→ (topic, payload, retain, qos, packet_id)."""
    (tlen,) = struct.unpack_from(">H", body)
    topic = body[2:2 + tlen].decode()
    off = 2 + tlen
    qos = (flags >> 1) & 0x03
    pid = None
    if qos:
        (pid,) = struct.unpack_from(">H", body, off)
        off += 2
    return topic, body[off:], bool(flags & 0x01), qos, pid


def topic_matches(pattern: str, topic: str) -> bool:
    """MQTT topic-filter matching: ``+`` one level, ``#`` rest (4.7.1)."""
    p_parts = pattern.split("/")
    t_parts = topic.split("/")
    for i, p in enumerate(p_parts):
        if p == "#":
            return True
        if i >= len(t_parts):
            return False
        if p != "+" and p != t_parts[i]:
            return False
    return len(p_parts) == len(t_parts)


# ---------------------------------------------------------------------------
# GstMQTTMessageHdr — reference wire layout (mqttcommon.h:49-63)
# ---------------------------------------------------------------------------

GST_MQTT_MAX_NUM_MEMS = 16
GST_MQTT_MAX_LEN_GST_CAPS_STR = 512
GST_MQTT_LEN_MSG_HDR = 1024
GST_CLOCK_TIME_NONE = 0xFFFFFFFFFFFFFFFF

#: guint num_mems; (4-pad to align gsize); gsize size_mems[16];
#: gint64 base/sent epochs; GstClockTime duration, dts, pts;
#: gchar gst_caps_str[512] — then reserved up to 1024.
_HDR = struct.Struct("<I4x16QqqQQQ512s")


def pack_gst_mqtt_message(mems: List[bytes], caps_str: str,
                          base_time_epoch: int, sent_time_epoch: int,
                          pts: Optional[int] = None,
                          dts: Optional[int] = None,
                          duration: Optional[int] = None) -> bytes:
    """Reference-format message: 1024-byte header + raw memory blocks
    (mqttsink.c's publish payload)."""
    if len(mems) > GST_MQTT_MAX_NUM_MEMS:
        raise ValueError(
            f"mqtt: {len(mems)} memories exceed "
            f"GST_MQTT_MAX_NUM_MEMS={GST_MQTT_MAX_NUM_MEMS}")
    caps_b = caps_str.encode()
    if len(caps_b) >= GST_MQTT_MAX_LEN_GST_CAPS_STR:
        raise ValueError(
            f"mqtt: caps string {len(caps_b)}B exceeds "
            f"{GST_MQTT_MAX_LEN_GST_CAPS_STR - 1}")
    sizes = [len(m) for m in mems] + [0] * (GST_MQTT_MAX_NUM_MEMS - len(mems))

    def ct(v):
        return GST_CLOCK_TIME_NONE if v is None else int(v)

    hdr = _HDR.pack(len(mems), *sizes, int(base_time_epoch),
                    int(sent_time_epoch), ct(duration), ct(dts), ct(pts),
                    caps_b)
    hdr += b"\x00" * (GST_MQTT_LEN_MSG_HDR - len(hdr))
    return hdr + b"".join(mems)


def parse_gst_mqtt_message(data: bytes) -> dict:
    """→ dict(mems, caps_str, base_time_epoch, sent_time_epoch, pts, dts,
    duration); inverse of :func:`pack_gst_mqtt_message`."""
    if len(data) < GST_MQTT_LEN_MSG_HDR:
        raise ValueError(
            f"mqtt: message {len(data)}B shorter than the "
            f"{GST_MQTT_LEN_MSG_HDR}B GstMQTTMessageHdr")
    fields = _HDR.unpack_from(data)
    num_mems = fields[0]
    if num_mems > GST_MQTT_MAX_NUM_MEMS:
        raise ValueError(f"mqtt: num_mems {num_mems} out of range")
    sizes = fields[1:1 + GST_MQTT_MAX_NUM_MEMS][:num_mems]
    base_epoch, sent_epoch, duration, dts, pts = fields[17:22]
    caps_str = fields[22].split(b"\x00", 1)[0].decode(errors="replace")
    mems = []
    off = GST_MQTT_LEN_MSG_HDR
    for s in sizes:
        if off + s > len(data):
            raise ValueError("mqtt: memory sizes exceed message length")
        mems.append(data[off:off + s])
        off += s

    def ct(v):
        return None if v == GST_CLOCK_TIME_NONE else v

    return dict(mems=mems, caps_str=caps_str, base_time_epoch=base_epoch,
                sent_time_epoch=sent_epoch, pts=ct(pts), dts=ct(dts),
                duration=ct(duration))


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------

class MqttClient:
    """MQTT 3.1.1 client (QoS0/QoS1 pub/sub, retain, auto-reconnect)
    with the same surface as the shim's ``Client`` so the pubsub
    elements can swap transports via ``broker=mqtt://host:port``.

    QoS1 publishes keep a packet-id→message in-flight map and
    retransmit with DUP until PUBACK (spec 4.4, at-least-once — tensor
    subscribers are latest-wins, so duplicates are harmless). The
    client auto-reconnects with exponential backoff, re-issues every
    subscription, and resends unacked QoS1 messages (paho
    ``MQTTAsync``-style recovery, gst/mqtt/mqttsink.c options).
    Keepalive failure is detected actively: a PINGREQ with no PINGRESP
    within 1.5x the ping interval marks the connection dead
    [MQTT-3.1.2-24]."""

    #: QoS1 in-flight cap: past this, the oldest unacked message is
    #: abandoned (logged) rather than the map growing without bound
    MAX_UNACKED = 256
    #: keepalive-tick retransmits per message before giving up on a
    #: peer that never PUBACKs
    MAX_RETRANSMITS = 16

    def __init__(self, host: str = "127.0.0.1", port: int = 1883,
                 client_id: Optional[str] = None, keepalive: int = 60,
                 timeout: float = 10.0, reconnect: bool = True,
                 max_reconnect_attempts: int = 8):
        self.failed = threading.Event()
        self._host, self._port = host, port
        self._timeout = timeout
        self._keepalive = keepalive
        self._reconnect = reconnect
        self._max_attempts = max_reconnect_attempts
        #: (topic filter, callback, requested qos)
        self._subs: List[Tuple[str, Callable[[str, bytes], None], int]] = []
        self._lock = threading.Lock()
        self._pid = 0
        #: pid → (done-event, one-slot codes list, topic filter) per
        #: subscribe() awaiting its own SUBACK — correlated by packet id
        #: so the N resubscribe SUBACKs emitted during _recover can't
        #: satisfy a concurrent subscribe() or leak another
        #: subscription's return codes; the filter lets a successful
        #: resubscribe complete a waiter whose own SUBSCRIBE was lost to
        #: the link drop
        self._pending_subacks: Dict[int, tuple] = {}
        #: pid → topic filter for _recover resubscribes (failure logging)
        self._resub_pids: Dict[int, str] = {}
        #: QoS1 in flight: pid → [topic, payload, retain, done-event,
        #: retransmit-count, status("pending"/"acked"/"abandoned")];
        #: bounded so fire-and-forget publishes against a never-PUBACKing
        #: peer can't grow memory forever
        self._unacked: Dict[int, list] = {}
        self._cid = client_id or f"nnstpu-{uuid.uuid4().hex[:12]}"
        self._pong_at = time.monotonic()
        self._ping_at = 0.0
        self.reconnects = 0  # observable recovery count
        self._sock = self._connect()
        self._alive = True
        self._stop_evt = threading.Event()
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name="mqtt-client-read")
        self._reader.start()
        # keepalive: a conformant broker drops clients silent for
        # 1.5x the advertised interval [MQTT-3.1.2-24]; we ping at half
        # and treat a missing PINGRESP as a dead link
        self._pinger = threading.Thread(
            target=self._ping_loop, args=(max(0.5, keepalive / 2),),
            daemon=True, name="mqtt-client-ping")
        self._pinger.start()

    # -- connection management ------------------------------------------

    def _connect(self, timeout: Optional[float] = None) -> socket.socket:
        sock = socket.create_connection((self._host, self._port),
                                        timeout=timeout or self._timeout)
        sock.settimeout(self._timeout)
        sock.sendall(connect_packet(self._cid, self._keepalive))
        pkt = read_packet(sock)
        if pkt is None or pkt[0] != CONNACK or pkt[2][1] != 0:
            sock.close()
            raise ConnectionError(
                f"mqtt: CONNECT to {self._host}:{self._port} refused "
                f"(code {pkt[2][1] if pkt else 'EOF'})")
        sock.settimeout(None)
        # bounded SENDS without touching recv: a half-open peer whose
        # window closed must fail a sendall (freeing self._lock) instead
        # of wedging the pinger/publishers forever. "ll" matches struct
        # timeval only where the kernel reads two native-long-sized
        # fields (Linux; LP64 little-endian macOS reads tv_usec from the
        # low half of the second long, which also works); on platforms
        # where the layout is unknown, skip the option rather than pack
        # garbage into setsockopt
        if sys.platform.startswith(("linux", "darwin")):
            tv = struct.pack("ll", int(self._timeout),
                             int(self._timeout % 1 * 1e6))
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO, tv)
        # under the lock: a reconnect racing ping() (which stamps
        # _ping_at under the lock) could otherwise leave a stale
        # _ping_at > _pong_at pair and make the fresh link look
        # half-open on the pinger's very next staleness check
        with self._lock:
            self._pong_at = time.monotonic()
            self._ping_at = 0.0
        return sock

    def _recover(self) -> bool:
        """Reconnect with backoff; resubscribe and resend unacked QoS1
        (DUP set). Returns False when attempts are exhausted — only
        then does ``failed`` latch."""
        try:
            self._sock.close()  # reap the dead fd before replacing it
        except OSError:
            pass
        for attempt in range(self._max_attempts):
            if not self._alive:
                return False
            delay = min(2.0 ** attempt * 0.05, 2.0)
            if self._stop_evt.wait(delay):
                return False
            try:
                # bounded per-attempt connect so `failed` latches within
                # seconds, not minutes, when the broker is unreachable
                sock = self._connect(timeout=min(self._timeout, 2.0))
            except (OSError, ConnectionError) as e:  # incl. CONNACK refusal
                log.info("mqtt: reconnect attempt %d failed: %s",
                         attempt + 1, e)
                continue
            # publish the socket, resubscribe, and resend unacked while
            # holding the lock: app publishers / the pinger must not
            # interleave writes mid-recovery on the fresh socket
            with self._lock:
                self._sock = sock
                subs = list(self._subs)
                unacked = list(self._unacked.items())
                try:
                    self._resub_pids.clear()
                    for filt, _cb, qos in subs:
                        self._pid = self._pid % 0xFFFF + 1
                        self._resub_pids[self._pid] = filt
                        sock.sendall(subscribe_packet(self._pid, filt,  # nns-lint: disable=NNS102,NNS112 -- the lock serializes writes to this socket; SO_SNDTIMEO (set at connect) bounds them
                                                      qos=qos))
                    for pid, (topic, payload, retain,
                              *_rest) in unacked:
                        sock.sendall(publish_packet(topic, payload, retain,  # nns-lint: disable=NNS102,NNS112 -- the lock serializes writes to this socket; SO_SNDTIMEO (set at connect) bounds them
                                                    qos=1, packet_id=pid,
                                                    dup=True))
                except OSError:
                    try:
                        sock.close()  # don't leak the half-set-up socket
                    except OSError:
                        pass
                    continue
            self.reconnects += 1
            log.info("mqtt: reconnected to %s:%d (attempt %d, %d subs, "
                     "%d unacked resent)", self._host, self._port,
                     attempt + 1, len(subs), len(unacked))
            return True
        return False

    def _on_link_down(self) -> bool:
        """Shared failure path for reader EOF and keepalive timeout."""
        if not self._alive:
            return False
        if self._reconnect and self._recover():
            return True
        if self._alive:  # a close() mid-recovery is not a failure
            self.failed.set()
        return False

    def _ping_loop(self, interval: float):
        while not self._stop_evt.wait(interval):
            if not self._alive:
                return
            now = time.monotonic()
            if self._ping_at and self._pong_at < self._ping_at and \
                    now - self._ping_at > 1.5 * interval:
                # PINGREQ went unanswered: the link is dead even though
                # the socket may still look open (half-open TCP)
                log.warning("mqtt: keepalive timeout (no PINGRESP)")
                try:
                    # shutdown (not just close) unblocks the reader,
                    # which owns the reconnect
                    self._sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    self._sock.close()
                except OSError:
                    pass
                continue
            try:
                self.ping()
            except OSError:
                pass  # reader sees the dead socket and recovers
            # background at-least-once: resend unacked QoS1 with DUP each
            # keepalive tick (covers fire-and-forget publishes too), but
            # give up after MAX_RETRANSMITS — a peer that never PUBACKs
            # must not cost bandwidth forever
            with self._lock:
                for pid in list(self._unacked):
                    entry = self._unacked[pid]
                    if entry[4] >= self.MAX_RETRANSMITS:
                        del self._unacked[pid]
                        entry[5] = "abandoned"
                        entry[3].set()  # wake a blocked publish() waiter
                        log.warning(
                            "mqtt: abandoning QoS1 packet %d to %r after "
                            "%d retransmits without PUBACK", pid, entry[0],
                            entry[4])
                        continue
                    entry[4] += 1
                    try:
                        self._sock.sendall(publish_packet(  # nns-lint: disable=NNS102,NNS112 -- the lock serializes writes to this socket; SO_SNDTIMEO (set at connect) bounds them
                            entry[0], entry[1], entry[2], qos=1,
                            packet_id=pid, dup=True))
                    except OSError:
                        break

    # -- pub/sub ---------------------------------------------------------

    def publish(self, topic: str, payload: bytes, retain: bool = False,
                qos: int = 0, timeout: Optional[float] = None) -> None:
        """Publish. ``qos=1``: blocks until PUBACK when ``timeout`` is
        given; without one it returns immediately and the keepalive
        loop retransmits (DUP) each tick until PUBACK."""
        act = None
        fi = _faults.ACTIVE
        if fi is not None:
            act = fi.action("mqtt.publish")
            if act == "disconnect":
                # sever the broker link; the keepalive loop's reconnect
                # path owns recovery (QoS1 unacked entries retransmit,
                # QoS0 is lost — the at-most-once contract)
                try:
                    self._sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            elif act == "corrupt":
                # a reserved packet type (0xF0): any compliant broker
                # must drop the connection on it (MQTT-2.2.2-2)
                with self._lock:
                    try:
                        self._sock.sendall(b"\xf0\x00")  # nns-lint: disable=NNS102,NNS112 -- the lock serializes writes to this socket; SO_SNDTIMEO (set at connect) bounds them
                    except OSError:
                        pass
        if qos == 0:
            if act is None:
                with self._lock:
                    self._sock.sendall(publish_packet(topic, payload, retain))  # nns-lint: disable=NNS102,NNS112 -- the lock serializes writes to this socket; SO_SNDTIMEO (set at connect) bounds them
            return
        if qos != 1:
            raise ValueError("mqtt: only QoS 0/1 supported")
        evt = threading.Event()
        with self._lock:
            if len(self._unacked) >= self.MAX_UNACKED:
                old_pid = next(iter(self._unacked))
                old = self._unacked.pop(old_pid)
                old[5] = "abandoned"
                old[3].set()  # wake a blocked publish() waiter
                log.warning(
                    "mqtt: QoS1 backlog full (%d); abandoning oldest "
                    "unacked packet %d to %r", self.MAX_UNACKED, old_pid,
                    old[0])
            self._pid = self._pid % 0xFFFF + 1
            pid = self._pid
            entry = [topic, payload, retain, evt, 0, "pending"]
            self._unacked[pid] = entry
            if act is None:  # a dropped first copy recovers via DUP
                # retransmit — the entry above is already in _unacked
                self._sock.sendall(publish_packet(topic, payload, retain,  # nns-lint: disable=NNS102,NNS112 -- the lock serializes writes to this socket; SO_SNDTIMEO (set at connect) bounds them
                                                  qos=1, packet_id=pid))
        if timeout is not None:
            deadline = time.monotonic() + timeout
            while not evt.wait(0.25):
                if time.monotonic() > deadline:
                    with self._lock:
                        if evt.is_set():  # PUBACK landed in the gap
                            break
                        # the caller is told delivery failed — stop
                        # retransmitting a message they will re-send
                        self._unacked.pop(pid, None)
                    raise TimeoutError(
                        f"mqtt: no PUBACK for packet {pid} within "
                        f"{timeout}s")
                with self._lock:
                    # retransmit only while still in flight: an entry
                    # the keepalive loop abandoned must stop costing
                    # bandwidth here too
                    if pid in self._unacked:
                        try:  # retransmit with DUP while waiting
                            self._sock.sendall(publish_packet(  # nns-lint: disable=NNS102,NNS112 -- the lock serializes writes to this socket; SO_SNDTIMEO (set at connect) bounds them
                                topic, payload, retain, qos=1,
                                packet_id=pid, dup=True))
                        except OSError:
                            pass
            if entry[5] != "acked":
                raise ConnectionError(
                    f"mqtt: QoS1 packet {pid} abandoned after "
                    f"{entry[4]} retransmits without PUBACK")

    def subscribe(self, topic_filter: str,
                  cb: Callable[[str, bytes], None],
                  timeout: float = 10.0, qos: int = 0) -> None:
        """Subscribe. Tensor streams default to QoS0 (latest-wins, no
        broker-side tracking); pass ``qos=1`` for control topics."""
        evt = threading.Event()
        slot: list = [None]  # SUBACK return codes land here, by pid
        with self._lock:
            self._pid = self._pid % 0xFFFF + 1
            pid = self._pid
            self._subs.append((topic_filter, cb, qos))
            self._pending_subacks[pid] = (evt, slot, topic_filter)
            self._sock.sendall(subscribe_packet(pid, topic_filter,  # nns-lint: disable=NNS102,NNS112 -- the lock serializes writes to this socket; SO_SNDTIMEO (set at connect) bounds them
                                                qos=qos))
        try:
            if not evt.wait(timeout):
                raise ConnectionError(
                    f"mqtt: no SUBACK for {topic_filter!r}")
        finally:
            with self._lock:
                self._pending_subacks.pop(pid, None)
        codes = slot[0] or b""
        if any(c == 0x80 for c in codes):  # spec 3.9.3: 0x80 = failure
            with self._lock:
                self._subs.remove((topic_filter, cb, qos))
            raise ConnectionError(
                f"mqtt: broker rejected subscription to {topic_filter!r}")

    def _read_loop(self):
        while self._alive:
            try:
                pkt = read_packet(self._sock)
            except Exception:
                pkt = None
            if pkt is None:
                if self._on_link_down():
                    continue
                return
            ptype, flags, body = pkt
            try:
                if ptype == PUBLISH:
                    topic, payload, _retain, qos, pid = \
                        parse_publish(flags, body)
                    if qos and pid is not None:
                        with self._lock:
                            self._sock.sendall(puback_packet(pid))  # nns-lint: disable=NNS102,NNS112 -- the lock serializes writes to this socket; SO_SNDTIMEO (set at connect) bounds them
                    # copy under the lock (subscribe()/unsubscribe run on
                    # other threads), dispatch outside it
                    with self._lock:
                        subs = list(self._subs)
                    for pattern, cb, _q in subs:
                        if topic_matches(pattern, topic):
                            try:
                                cb(topic, payload)
                            except Exception as e:  # noqa: BLE001
                                log.warning("mqtt subscriber callback: %s", e)
                elif ptype == PUBACK:
                    (pid,) = struct.unpack_from(">H", body)
                    with self._lock:
                        entry = self._unacked.pop(pid, None)
                    if entry is not None:
                        entry[5] = "acked"
                        entry[3].set()
                elif ptype == SUBACK:
                    (pid,) = struct.unpack_from(">H", body)
                    codes = body[2:]
                    with self._lock:
                        waiters = []
                        w = self._pending_subacks.get(pid)
                        if w is not None:
                            waiters.append(w)
                        refilt = self._resub_pids.pop(pid, None)
                        if refilt is not None:
                            # a subscribe() whose own SUBSCRIBE was lost
                            # to the link drop is satisfied by _recover's
                            # resubscribe of the same filter
                            waiters.extend(
                                pw for pw in
                                self._pending_subacks.values()
                                if pw[2] == refilt and pw is not w)
                    for evt_, slot_, _filt in waiters:
                        slot_[0] = codes
                        evt_.set()
                    if refilt is not None and not waiters and \
                            any(c == 0x80 for c in codes):
                        log.warning("mqtt: broker rejected resubscription"
                                    " to %r", refilt)
                elif ptype == PINGRESP:
                    # under the lock: the pinger compares _pong_at
                    # against _ping_at as one pair under it
                    with self._lock:
                        self._pong_at = time.monotonic()
                elif ptype == PINGREQ:
                    with self._lock:
                        self._sock.sendall(pingresp_packet())  # nns-lint: disable=NNS102,NNS112 -- the lock serializes writes to this socket; SO_SNDTIMEO (set at connect) bounds them
            except Exception as e:  # noqa: BLE001 — malformed peer bytes
                # framing state is unreliable past a parse error: fail the
                # connection so pollers of `failed` see it, don't hang
                log.warning("mqtt: malformed packet type %d: %s", ptype, e)
                if self._on_link_down():
                    continue
                return

    def ping(self) -> None:
        with self._lock:
            self._ping_at = time.monotonic()
            self._sock.sendall(pingreq_packet())  # nns-lint: disable=NNS102,NNS112 -- the lock serializes writes to this socket; SO_SNDTIMEO (set at connect) bounds them

    def close(self) -> None:
        self._alive = False
        self._stop_evt.set()
        try:
            with self._lock:
                self._sock.sendall(disconnect_packet())  # nns-lint: disable=NNS102,NNS112 -- the lock serializes writes to this socket; SO_SNDTIMEO (set at connect) bounds them
        except OSError:
            pass
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


# ---------------------------------------------------------------------------
# Broker
# ---------------------------------------------------------------------------

class MqttBroker:
    """In-process broker speaking real MQTT 3.1.1 (QoS0/QoS1 + retain).

    Gives loopback tests and brokerless edge deployments a conformant
    peer; production fleets point ``broker=mqtt://`` at their own.
    Incoming QoS1 publishes are PUBACKed; deliveries to QoS1
    subscribers carry packet ids and are retransmitted (DUP) by a sweep
    thread until the subscriber PUBACKs."""

    _RETX_INTERVAL = 1.0  # seconds between QoS1 redelivery sweeps

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(32)
        self.port = self._srv.getsockname()[1]
        self._lock = threading.Lock()
        #: sock → list of (topic filter, granted qos)
        self._clients: Dict[socket.socket, List[Tuple[str, int]]] = {}
        self._retained: Dict[str, bytes] = {}
        #: sock → {pid: (topic, payload, retain)} awaiting PUBACK
        self._inflight: Dict[socket.socket, Dict[int, tuple]] = {}
        #: sock → write lock: handler threads, _route callers, and the
        #: retransmit sweeper all write to subscriber sockets — without
        #: per-socket serialization their frames would interleave
        self._wlocks: Dict[socket.socket, threading.Lock] = {}
        self._next_pid = 0
        self._alive = True
        self._acceptor = threading.Thread(target=self._accept_loop,
                                          daemon=True, name="mqtt-accept")
        self._acceptor.start()
        self._sweeper = threading.Thread(target=self._retx_loop,
                                         daemon=True, name="mqtt-retx")
        self._sweeper.start()

    def _send(self, sock: socket.socket, data: bytes) -> None:
        with self._lock:
            wlock = self._wlocks.get(sock)
        if wlock is None:
            sock.sendall(data)  # pre-registration (CONNACK): single-owner
            return
        with wlock:
            sock.sendall(data)  # nns-lint: disable=NNS102,NNS112 -- the lock serializes writes to this socket; SO_SNDTIMEO (set at connect) bounds them

    def _retx_loop(self):
        while self._alive:
            time.sleep(self._RETX_INTERVAL)
            with self._lock:
                work = [(s, dict(m)) for s, m in self._inflight.items() if m]
            for sock, msgs in work:
                for pid, (topic, payload, retain) in msgs.items():
                    try:
                        self._send(sock, publish_packet(
                            topic, payload, retain, qos=1, packet_id=pid,
                            dup=True))
                    except OSError:
                        break

    def _accept_loop(self):
        while self._alive:
            try:
                sock, _addr = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(sock,), daemon=True,
                             name="mqtt-serve").start()

    def _serve(self, sock: socket.socket):
        try:
            pkt = read_packet(sock)
            if pkt is None or pkt[0] != CONNECT:
                sock.close()
                return
            body = pkt[2]
            if body[:6] != PROTOCOL_NAME or body[6] != PROTOCOL_LEVEL:
                sock.sendall(connack_packet(return_code=1))  # bad version
                sock.close()
                return
            sock.sendall(connack_packet(0))
            with self._lock:
                self._clients[sock] = []
                self._inflight[sock] = {}
                self._wlocks[sock] = threading.Lock()
            while self._alive:
                pkt = read_packet(sock)
                if pkt is None:
                    break
                ptype, flags, body = pkt
                if ptype == PUBLISH:
                    topic, payload, retain, qos, pid = \
                        parse_publish(flags, body)
                    if qos and pid is not None:
                        self._send(sock, puback_packet(pid))
                    self._route(topic, payload, retain)
                elif ptype == PUBACK:
                    (pid,) = struct.unpack_from(">H", body)
                    with self._lock:
                        self._inflight.get(sock, {}).pop(pid, None)
                elif ptype == SUBSCRIBE:
                    (pid,) = struct.unpack_from(">H", body)
                    off, codes = 2, []
                    with self._lock:
                        filters = self._clients.get(sock)
                    while off < len(body):
                        (tlen,) = struct.unpack_from(">H", body, off)
                        filt = body[off + 2:off + 2 + tlen].decode()
                        req_qos = body[off + 2 + tlen] & 0x03
                        off += 2 + tlen + 1
                        granted = min(req_qos, 1)
                        codes.append(granted)
                        if filters is not None:
                            filters.append((filt, granted))
                        self._send_retained(sock, filt)
                    self._send(sock, suback_packet(pid, codes))
                elif ptype == UNSUBSCRIBE:
                    (pid,) = struct.unpack_from(">H", body)
                    (tlen,) = struct.unpack_from(">H", body, 2)
                    filt = body[4:4 + tlen].decode()
                    with self._lock:
                        subs = self._clients.get(sock, [])
                        self._clients[sock] = [
                            (f, q) for f, q in subs if f != filt]
                    self._send(sock, unsuback_packet(pid))
                elif ptype == PINGREQ:
                    self._send(sock, pingresp_packet())
                elif ptype == DISCONNECT:
                    break
        except OSError:
            pass
        finally:
            with self._lock:
                self._clients.pop(sock, None)
                self._inflight.pop(sock, None)
                self._wlocks.pop(sock, None)
            sock.close()

    def _send_retained(self, sock: socket.socket, filt: str):
        with self._lock:
            hits = [(t, p) for t, p in self._retained.items()
                    if topic_matches(filt, t)]
        for topic, payload in hits:
            try:
                self._send(sock, publish_packet(topic, payload,
                                                retain=True))
            except OSError:
                pass

    def _route(self, topic: str, payload: bytes, retain: bool):
        with self._lock:
            if retain:
                if payload:
                    self._retained[topic] = payload
                else:
                    self._retained.pop(topic, None)  # spec 3.3.1.3
            targets = []  # (sock, delivery qos)
            for s, filters in self._clients.items():
                qs = [q for f, q in filters if topic_matches(f, topic)]
                if qs:
                    targets.append((s, max(qs)))
            qos1 = []
            for s, q in targets:
                if q:
                    self._next_pid = self._next_pid % 0xFFFF + 1
                    pid = self._next_pid
                    # live deliveries carry retain=0 [MQTT-3.3.1-9];
                    # only _send_retained sets the flag
                    self._inflight.setdefault(s, {})[pid] = \
                        (topic, payload, False)
                    qos1.append((s, pid))
        pkt0 = publish_packet(topic, payload)
        for s, q in targets:
            if q:
                continue
            try:
                self._send(s, pkt0)
            except OSError:
                pass
        for s, pid in qos1:
            try:
                self._send(s, publish_packet(topic, payload, retain=False,
                                             qos=1, packet_id=pid))
            except OSError:
                pass  # the sweep retries until the reader reaps the sock

    def close(self) -> None:
        self._alive = False
        # shutdown() before close(): close() alone does not wake a
        # recv()/accept() blocked in another thread
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            socks = list(self._clients)
            self._clients.clear()
            self._inflight.clear()
            self._wlocks.clear()
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
