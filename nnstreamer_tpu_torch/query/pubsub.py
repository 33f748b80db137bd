"""Topic-based pub/sub — the MQTT capability, self-contained.

Reference: ``gst/mqtt/`` (mqttsink.c 1407, mqttsrc.c 1423 LoC) publishes
GStreamer buffers over a paho-MQTT broker with NTP-corrected cross-device
timestamps (``ntputil.c``, Documentation/synchronization-in-mqtt-elements
.md). This stack has no external broker, so the capability is provided
whole: a broker speaking a minimal topic protocol over the same framed
TCP transport as tensor_query, with RETAIN semantics (needed by
discovery) and epoch-carrying buffer frames for cross-host timestamp
rebasing (the ntputil role).

Protocol commands (framed as query.protocol):
  SUB <topic>            — subscribe (wildcard suffix '#' supported)
  PUB <topic> <payload>  — publish; RETAIN bit keeps last payload
  MSG <topic> <payload>  — broker → subscriber delivery

Port of ``nnstreamer_tpu/query/pubsub.py``: a copy with its imports
rewritten. Frames go through a plain ``sendall``, the bytes the JAX
package's native ``send_frame`` writes (its ``.so`` path waits for ROADMAP
item 26e), so a broker or client of either package serves the other.
"""

from __future__ import annotations

import json
import queue as _queue
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.query import protocol as P

log = get_logger("pubsub")

# commands layered on the framed transport (distinct magic from query)
_MAGIC = 0x4E505331  # 'NPS1'
CMD_SUB = 1
CMD_PUB = 2
CMD_PUB_RETAIN = 3
CMD_MSG = 4
CMD_BYE = 5

_TOPIC_HDR = struct.Struct("<H")


def _pack_topic(topic: str, payload: bytes) -> bytes:
    t = topic.encode()
    return _TOPIC_HDR.pack(len(t)) + t + payload


def _unpack_topic(data: bytes) -> Tuple[str, bytes]:
    (tlen,) = _TOPIC_HDR.unpack_from(data)
    topic = data[2:2 + tlen].decode()
    return topic, data[2 + tlen:]


def _send(sock, cmd: int, payload: bytes) -> None:
    sock.sendall(struct.pack("<IIQ", _MAGIC, cmd, len(payload)) + payload)


def _recv(sock) -> Tuple[int, bytes]:
    hdr = P._recv_exact(sock, 16)
    magic, cmd, plen = struct.unpack("<IIQ", hdr)
    if magic != _MAGIC:
        raise P.QueryProtocolError(f"pubsub: bad magic {magic:#x}")
    payload = P._recv_exact(sock, plen) if plen else b""
    return cmd, payload


def _topic_matches(pattern: str, topic: str) -> bool:
    if pattern.endswith("#"):
        return topic.startswith(pattern[:-1])
    return pattern == topic


class Broker:
    """In-process pub/sub broker (the paho-broker role)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host, self.port = host, port
        self._subs: List[Tuple[str, socket.socket]] = []
        self._retained: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        # per-connection write locks: concurrent publisher threads must not
        # interleave frame bytes on one subscriber socket
        self._wlocks: Dict[socket.socket, threading.Lock] = {}
        self._listener: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Broker":
        self._stop.clear()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.host, self.port))
        self.port = self._listener.getsockname()[1]
        self._listener.listen(32)
        self._listener.settimeout(0.2)
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="pubsub-broker", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None
        if self._listener:
            self._listener.close()
            self._listener = None
        with self._lock:
            for _, s in self._subs:
                try:
                    s.shutdown(socket.SHUT_RDWR)  # force FIN even with a
                    # reader blocked on the fd; close() alone may not
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass
            self._subs.clear()
            self._wlocks.clear()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket):
        try:
            while not self._stop.is_set():
                cmd, payload = _recv(conn)
                if cmd == CMD_SUB:
                    topic, _ = _unpack_topic(payload)
                    with self._lock:
                        self._subs.append((topic, conn))
                        self._wlocks.setdefault(conn, threading.Lock())
                        retained = [
                            (t, p) for t, p in self._retained.items()
                            if _topic_matches(topic, t)
                        ]
                    for t, p in retained:  # deliver retained immediately
                        self._send_locked(conn, _pack_topic(t, p))
                elif cmd in (CMD_PUB, CMD_PUB_RETAIN):
                    topic, body = _unpack_topic(payload)
                    if cmd == CMD_PUB_RETAIN:
                        with self._lock:
                            if body:
                                self._retained[topic] = body
                            else:
                                # MQTT semantics: empty retained publish
                                # deletes the retained entry
                                self._retained.pop(topic, None)
                    self._fanout(topic, body)
                elif cmd == CMD_BYE:
                    break
        except (P.QueryProtocolError, OSError):
            pass
        finally:
            with self._lock:
                self._subs = [(t, s) for t, s in self._subs if s is not conn]
                self._wlocks.pop(conn, None)
            try:
                conn.close()
            except OSError:
                pass

    def _send_locked(self, conn: socket.socket, payload: bytes) -> None:
        with self._lock:
            wlock = self._wlocks.setdefault(conn, threading.Lock())
        with wlock:
            _send(conn, CMD_MSG, payload)

    def _fanout(self, topic: str, body: bytes):
        with self._lock:
            targets = [s for t, s in self._subs if _topic_matches(t, topic)]
        dead = []
        payload = _pack_topic(topic, body)
        for s in targets:
            try:
                self._send_locked(s, payload)
            except OSError:
                dead.append(s)
        if dead:
            with self._lock:
                self._subs = [(t, s) for t, s in self._subs
                              if s not in dead]
                for s in dead:
                    self._wlocks.pop(s, None)


def parse_broker_spec(spec: Optional[str], host: str = "127.0.0.1",
                      port: int = 1883) -> Tuple[str, str, int]:
    """THE broker-spelling parser (one source of truth for the pubsub
    elements' ``broker`` property and discovery's ``broker_host``):
    ``shim``/``native``/empty → in-process shim at (host, port);
    ``mqtt`` → real MQTT at (host, port); ``mqtt://h[:p]`` → real MQTT
    with the URL overriding host/port."""
    s = (spec or "shim").strip()
    if s in ("", "shim", "native"):
        return "shim", host, port
    if s == "mqtt":
        return "mqtt", host, port
    if s.startswith("mqtt://"):
        rest = s[len("mqtt://"):]
        if rest:
            h, _, p = rest.partition(":")
            return "mqtt", h or host, int(p) if p else port
        return "mqtt", host, port
    raise ValueError(f"pubsub: unknown broker {spec!r} (shim|mqtt[://h:p])")


class Client:
    """Pub/sub client: publish + callback-based subscribe."""

    def __init__(self, host: str = "127.0.0.1", port: int = 1883,
                 timeout: float = 10.0):
        self.sock = P.connect(host, port, timeout=timeout)
        self.sock.settimeout(None)
        self._cbs: List[Tuple[str, Callable[[str, bytes], None]]] = []
        self._lock = threading.Lock()
        self._rx: Optional[threading.Thread] = None
        self._stop = threading.Event()
        #: set when the receive loop died unexpectedly (broker gone /
        #: corrupt frame) — consumers can poll this instead of hanging
        self.failed = threading.Event()

    def publish(self, topic: str, payload: bytes,
                retain: bool = False) -> None:
        with self._lock:
            _send(self.sock, CMD_PUB_RETAIN if retain else CMD_PUB,
                  _pack_topic(topic, payload))

    def subscribe(self, topic: str,
                  callback: Callable[[str, bytes], None]) -> None:
        self._cbs.append((topic, callback))
        with self._lock:
            _send(self.sock, CMD_SUB, _pack_topic(topic, b""))
        if self._rx is None:
            self._rx = threading.Thread(target=self._rx_loop,
                                        name="pubsub-rx", daemon=True)
            self._rx.start()

    def _rx_loop(self):
        try:
            while not self._stop.is_set():
                cmd, payload = _recv(self.sock)
                if cmd != CMD_MSG:
                    continue
                topic, body = _unpack_topic(payload)
                for pattern, cb in self._cbs:
                    if _topic_matches(pattern, topic):
                        try:
                            cb(topic, body)
                        except Exception as e:  # noqa: BLE001
                            log.warning("subscriber callback error: %s", e)
        except (P.QueryProtocolError, OSError) as e:
            if not self._stop.is_set():
                log.warning("pubsub receive loop lost broker: %s", e)
                self.failed.set()

    def close(self) -> None:
        self._stop.set()
        try:
            with self._lock:
                _send(self.sock, CMD_BYE, b"")
        except OSError:
            pass
        self.sock.close()


# ---------------------------------------------------------------------------
# cross-host timestamp rebasing (reference ntputil.c + mqttsink base-time
# header fields, mqttcommon.h:49-63)
# ---------------------------------------------------------------------------
def epoch_ns() -> int:
    return time.time_ns()


#: envelope magic+version: peers with a different envelope layout fail
#: loudly instead of misparsing timestamps as payload
_ENVELOPE_MAGIC = b"NPE2"


def make_buffer_envelope(buf_payload: bytes, pts: Optional[int],
                         base_epoch: Optional[int] = None,
                         sent_epoch: Optional[int] = None) -> bytes:
    """Prefix sender base-epoch + send-epoch + pts so receivers can rebase
    timestamps by base-epoch difference (the reference's
    _put_timestamp_on_gst_buf math, mqttsrc.c:1381-1404 — latency-free,
    unlike a first-message arrival delta)."""
    return _ENVELOPE_MAGIC + struct.pack(
        "<qqq",
        epoch_ns() if base_epoch is None else base_epoch,
        epoch_ns() if sent_epoch is None else sent_epoch,
        -1 if pts is None else pts,
    ) + buf_payload


def parse_buffer_envelope(data: bytes) -> Tuple[int, int, Optional[int],
                                                bytes]:
    if data[:4] != _ENVELOPE_MAGIC:
        raise ValueError(
            "pubsub: buffer envelope magic/version mismatch (peer runs an "
            "incompatible framework version)")
    base_epoch, sent_epoch, pts = struct.unpack_from("<qqq", data, 4)
    return base_epoch, sent_epoch, (None if pts < 0 else pts), data[28:]
