"""Query server core — accept loop, per-client queues, result routing.

Reference: ``tensor_query_server.c`` (262 LoC) + the server halves of
``tensor_query_common.c``: listen, handshake caps, queue received buffers
(tagged with client id), and send results back to the right client
(serversink routes by the GstMetaQuery client-id, tensor_meta.c).

The port of the JAX package's pure-Python transport: a thread per client
speaking the classic commands. Not ported yet: the native epoll core
(ROADMAP.md item 26e), the reference's two-port wire (26d) and the
resilient protocol with its dedup windows and checkpoints (26a).
"""

from __future__ import annotations

import queue as _queue
import socket
import threading
from typing import Dict, Optional

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.query import protocol as P
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

log = get_logger("query.server")

#: received buffers held before a client's receive thread blocks
MAX_QUEUE = 64


class QueryServer:
    """Accepts query clients; exposes a queue of (client_id, buffer)."""

    def __init__(self, host: str = "0.0.0.0", port: int = 3000):
        self.host = host
        self.port = port
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
            "Buffers received from query clients", wire="nnstpu")
        self._m_errors = reg.counter(
            "nns_query_errors_total",
            "Malformed / undeliverable query frames", wire="nnstpu")

    def start(self) -> "QueryServer":
        self._stop.clear()
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

    # -- results -------------------------------------------------------------
    def send_result(self, client_id: int, buf: TensorBuffer) -> bool:
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
        try:
            buf = self.incoming.get(timeout=timeout)
        except _queue.Empty:
            return None
        if buf is not None:
            self._m_requests.inc()
        return buf
