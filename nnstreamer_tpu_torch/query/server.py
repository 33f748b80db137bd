"""Query server core — accept loop, per-client queues, result routing.

Reference: ``tensor_query_server.c`` (262 LoC) + the server halves of
``tensor_query_common.c``: listen, handshake caps, queue received buffers
(tagged with client id), and send results back to the right client
(serversink routes by the GstMetaQuery client-id, tensor_meta.c).

The port of the JAX package's pure-Python transport: a thread per client
speaking the classic commands, or with ``wire="nnstreamer"`` the
reference's two-port raw-struct wire (``query/refwire.py``), whose
memories are rebuilt into tensors from ``caps_str``. Not ported yet: the
native epoll core (ROADMAP.md item 26e) and the resilient protocol with
its dedup windows and checkpoints (26a).
"""

from __future__ import annotations

import queue as _queue
import socket
import threading
from typing import Dict, Optional

import numpy as np

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.query import protocol as P
from nnstreamer_tpu_torch.query import refwire as R
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

log = get_logger("query.server")

#: received buffers held before a client's receive thread blocks
MAX_QUEUE = 64


class QueryServer:
    """Accepts query clients; exposes a queue of (client_id, buffer)."""

    def __init__(self, host: str = "0.0.0.0", port: int = 3000,
                 caps_str: str = "", wire: str = "nnstpu",
                 sink_port: int = 0):
        self.host = host
        self.port = port
        self.caps_str = caps_str
        #: "nnstpu" = NTQ1 framing (self-describing tensors); "nnstreamer"
        #: = the reference's raw-struct wire on TWO ports (src=port,
        #: sink=sink_port) so reference edge peers can offload to us
        self.wire = wire
        self.sink_port = sink_port
        self._refwire: Optional[R.RefWireQueryServer] = None
        #: refwire: the TensorsConfig the raw memories are rebuilt with
        self._config = None
        self.incoming: _queue.Queue = _queue.Queue(maxsize=MAX_QUEUE)
        self._clients: Dict[int, socket.socket] = {}
        self._clients_lock = threading.Lock()
        #: one frame at a time on the wire: results from several threads
        #: (lm_serve drainers) and PING replies share the sockets
        self._send_lock = threading.Lock()
        self._next_id = 1
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        reg = get_registry()
        self._m_requests = reg.counter(
            "nns_query_requests_total",
            "Buffers received from query clients", wire=self.wire)
        self._m_errors = reg.counter(
            "nns_query_errors_total",
            "Malformed / undeliverable query frames", wire=self.wire)
        if caps_str and wire == "nnstreamer":
            try:
                from nnstreamer_tpu_torch.pipeline.parse import (
                    parse_caps_string,
                )
                from nnstreamer_tpu_torch.tensors.types import TensorsConfig

                self._config = TensorsConfig.from_caps(
                    parse_caps_string(caps_str))
            except Exception as e:  # noqa: BLE001 — caps stay advisory
                log.info("refwire caps %r not parseable (%s); "
                         "mems surface as u8", caps_str, e)

    def start(self) -> "QueryServer":
        self._stop.clear()
        if self.wire == "nnstreamer":
            self._refwire = R.RefWireQueryServer(
                host=self.host, src_port=self.port, sink_port=self.sink_port,
                caps_str=self.caps_str, max_queue=MAX_QUEUE).start()
            self.port = self._refwire.src_port
            self.sink_port = self._refwire.sink_port
            return self
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.host, self.port))
        self.port = self._listener.getsockname()[1]  # resolve port 0
        self._listener.listen(16)
        self._listener.settimeout(0.2)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="query-server-accept", daemon=True
        )
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._refwire is not None:
            self._refwire.stop()
            self._refwire = None
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
            self._accept_thread = None
        if self._listener is not None:
            self._listener.close()
            self._listener = None
        with self._clients_lock:
            for sock in self._clients.values():
                try:
                    sock.close()
                except OSError:
                    pass
            self._clients.clear()
        try:  # unblock a consumer waiting in get_buffer
            self.incoming.put_nowait(None)
        except _queue.Full:
            pass  # consumer isn't blocked on an empty queue

    # -- accept/receive ------------------------------------------------------
    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(None)  # blocking, whatever the listener's
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._clients_lock:
                client_id = self._next_id
                self._next_id += 1
                self._clients[client_id] = conn
            threading.Thread(
                target=self._client_loop, args=(client_id, conn),
                name=f"query-client-{client_id}", daemon=True
            ).start()
            log.info("client %d connected from %s", client_id, addr)

    def _send(self, conn: socket.socket, cmd: P.Cmd,
              payload: bytes = b"") -> None:
        with self._send_lock:
            P.send_msg(conn, cmd, payload)

    def _client_loop(self, client_id: int, conn: socket.socket):
        try:
            while not self._stop.is_set():
                cmd, payload = P.recv_msg(conn)
                if cmd is P.Cmd.REQUEST_INFO:
                    # caps negotiation: client caps in payload; approve with
                    # flexible (empty) server caps + the assigned client id
                    self._send(conn, P.Cmd.APPROVE)
                    self._send(conn, P.Cmd.CLIENT_ID,
                               str(client_id).encode())
                elif cmd is P.Cmd.TRANSFER:
                    try:
                        buf = P.unpack_buffer(payload)
                    except Exception as e:  # noqa: BLE001 — corrupt frame:
                        # orderly disconnect, not a thread-killing traceback
                        self._m_errors.inc()
                        log.warning("bad frame from client %d (%s); "
                                    "disconnecting it", client_id, e)
                        break
                    buf.meta["query_client_id"] = client_id
                    self.incoming.put(buf)
                elif cmd is P.Cmd.PING:
                    self._send(conn, P.Cmd.PING)
                elif cmd is P.Cmd.BYE:
                    break
        except (P.QueryProtocolError, OSError) as e:
            log.info("client %d disconnected: %s", client_id, e)
        finally:
            with self._clients_lock:
                self._clients.pop(client_id, None)
            try:
                conn.close()
            except OSError:
                pass

    def set_sink_caps(self, caps) -> None:
        """The server pipeline's output caps, from its serversink: the
        reference wire's APPROVE announces them to later clients."""
        refsrv = self._refwire
        if refsrv is not None and caps is not None:
            refsrv.sink_caps_str = caps.to_string()

    # -- reference-wire reconstruction --------------------------------------
    def _refwire_buf(self, client_id: int, info: dict,
                     mems) -> Optional[TensorBuffer]:
        """None on a mem/caps mismatch: the serving loop survives one
        client's malformed buffer (the frame drops, not the pipeline)."""
        try:
            if self._config is not None:
                buf = R.mems_to_buffer(mems, self._config, info)
            else:
                buf = TensorBuffer(
                    [np.frombuffer(m, dtype=np.uint8) for m in mems],
                    pts=info.get("pts"), dts=info.get("dts"),
                    duration=info.get("duration"))
        except ValueError as e:
            self._m_errors.inc()
            log.warning("refwire buffer from client %d does not match "
                        "the configured caps (%s); dropping it",
                        client_id, e)
            return None
        buf.meta["query_client_id"] = client_id
        return buf

    # -- results -------------------------------------------------------------
    def send_result(self, client_id: int, buf: TensorBuffer) -> bool:
        refsrv = self._refwire  # capture once: stop() nulls the attribute
        if self.wire == "nnstreamer":
            if refsrv is None:
                return False
            return refsrv.send_result(
                client_id, R.buffer_to_mems(buf.to_host()), pts=buf.pts)
        with self._clients_lock:
            conn = self._clients.get(client_id)
        if conn is None:
            self._m_errors.inc()
            log.warning("result for unknown client %d dropped", client_id)
            return False
        try:
            self._send(conn, P.Cmd.RESULT, P.pack_buffer(buf))
            return True
        except OSError as e:
            self._m_errors.inc()
            log.warning("send to client %d failed: %s", client_id, e)
            return False

    def get_buffer(self, timeout: Optional[float] = None
                   ) -> Optional[TensorBuffer]:
        if self.wire == "nnstreamer":
            refsrv = self._refwire
            got = refsrv.get(timeout=timeout) if refsrv is not None \
                else None
            buf = None if got is None else self._refwire_buf(*got)
        else:
            try:
                buf = self.incoming.get(timeout=timeout)
            except _queue.Empty:
                return None
        if buf is not None:
            self._m_requests.inc()
        return buf
