"""Query server core — accept loop, per-client queues, result routing.

Reference: ``tensor_query_server.c`` (262 LoC) + the server halves of
``tensor_query_common.c``: listen, handshake caps, queue received buffers
(tagged with client id), and send results back to the right client
(serversink routes by the GstMetaQuery client-id, tensor_meta.c).

The port of the JAX package's server. The classic wire runs, as there,
on the C++ epoll core (``native.NativeServerCore``): one native thread
owns every socket, and Python sees only complete TRANSFER payloads
(``wait_pop``) and pushes framed results (``send``). The thread-per-client
Python transport serves instead when ``resilient=True`` (the core does
not speak commands 9-14), when ``NNSTPU_PURE_PY_SERVER`` is set, or when
the library cannot be built or loaded; ``server.native`` says which runs.
With ``resilient=True`` the Python transport also speaks the extended
protocol (``query/resilience.py``): HELLO, ``TRANSFER_EX``/``EX2``
through a dedup window per client instance, deadline admission,
``EXPIRED`` notices, ``RESULT_EX``/``EX2`` with the remote span blob
(``obs/distributed.py``), and the windows' checkpoint. A window caches
the packed reply bytes, so it never holds a device tensor.

With ``wire="nnstreamer"`` it serves the reference's two-port raw-struct
wire (``query/refwire.py``), whose memories are rebuilt into tensors from
``caps_str``. That wire stays on Python, native library or not (ROADMAP
C.50): the JAX package's native reference-wire core approves every
client with the caps it was started with, so it could neither DENY a
mismatched client nor announce the negotiated output caps.
"""

from __future__ import annotations

import os
import queue as _queue
import socket
import struct
import sys
import threading
import time
from typing import Any, Dict, Optional

import numpy as np

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.query import protocol as P
from nnstreamer_tpu_torch.query import refwire as R
from nnstreamer_tpu_torch.query import resilience as _res
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

log = get_logger("query.server")

#: received buffers held before a client's receive thread blocks
MAX_QUEUE = 64


class QueryServer:
    """Accepts query clients; exposes a queue of (client_id, buffer)."""

    def __init__(self, host: str = "0.0.0.0", port: int = 3000,
                 caps_str: str = "", wire: str = "nnstpu",
                 sink_port: int = 0, resilient: bool = False):
        self.host = host
        self.port = port
        self.caps_str = caps_str
        #: resilient mode: serve the extended protocol (HELLO /
        #: TRANSFER_EX dedup, deadline propagation, EXPIRED notices)
        self.resilient = bool(resilient)
        #: "nnstpu" = NTQ1 framing (self-describing tensors); "nnstreamer"
        #: = the reference's raw-struct wire on TWO ports (src=port,
        #: sink=sink_port) so reference edge peers can offload to us
        self.wire = wire
        self.sink_port = sink_port
        self._core = None  # NativeServerCore when the native path is live
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
        # resilient-protocol state, all keyed by the HELLO-announced
        # client *instance* (stable across that client's reconnects)
        self._dedup: Dict[str, _res.DedupWindow] = {}
        self._instances: Dict[str, int] = {}      # instance → live client id
        self._conn_instance: Dict[int, str] = {}  # client id → instance
        #: (instance, req_id) → the client id its reply is owed to: the
        #: connection the request arrived on, or the one whose resend of
        #: it found it still in flight. A reply goes only there: sent to
        #: whatever connection the instance holds now, a reply could
        #: overtake the replays that connection's resends are about to
        #: get, or go to a dead connection after the resend was dropped
        #: as a duplicate. Read and written under ``_clients_lock``
        #: together with the dedup admit and resolve.
        self._owed: Dict[tuple, int] = {}
        #: instances that negotiated the dt1 distributed-trace feature
        #: in their HELLO (obs/distributed) — only these ever see EX2
        self._dt1_instances: set = set()
        self._endpoint_name: Optional[str] = None
        #: chaos-test witnesses: duplicate requests absorbed / frames
        #: expired remotely (mirrors of the nns_net_* counters)
        self.dedup_hits = 0
        self.remote_expired = 0
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

    @property
    def native(self) -> bool:
        """True while the C++ epoll core carries this server's wire."""
        return self._core is not None

    def start(self) -> "QueryServer":
        self._stop.clear()
        if self.wire == "nnstreamer":
            self._refwire = R.RefWireQueryServer(
                host=self.host, src_port=self.port, sink_port=self.sink_port,
                caps_str=self.caps_str, max_queue=MAX_QUEUE).start()
            self.port = self._refwire.src_port
            self.sink_port = self._refwire.sink_port
            return self
        if self.resilient:
            log.info("resilient mode: using the pure-Python transport "
                     "(the native core does not speak the extended "
                     "protocol)")
        elif not os.environ.get("NNSTPU_PURE_PY_SERVER"):
            try:
                from nnstreamer_tpu_torch.native import NativeServerCore

                self._core = NativeServerCore(
                    self.host, self.port, self.caps_str, MAX_QUEUE)
                self.port = self._core.port
                return self
            except OSError as e:
                log.info("native server core unavailable (%s); "
                         "using pure-Python transport", e)
                self._core = None
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
        if self._core is not None:
            self._core.stop()
            self._core = None
            return
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
            if self.resilient and sys.platform.startswith(
                    ("linux", "darwin")):
                # bounded SENDS without touching recv: EXPIRED notices and
                # replayed results go out from scheduler/sink threads — a
                # half-open client whose window closed must fail the
                # send, not wedge them
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                                struct.pack("ll", 5, 0))
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
                    # caps negotiation: client caps in payload; approve and
                    # return our caps + assigned client id
                    self._send(conn, P.Cmd.APPROVE, self.caps_str.encode())
                    self._send(conn, P.Cmd.CLIENT_ID,
                               str(client_id).encode())
                elif cmd is P.Cmd.TRANSFER:
                    try:
                        buf = P.unpack_buffer(payload)
                    except Exception as e:  # noqa: BLE001 — corrupt frame:
                        # orderly disconnect (matches the native path's
                        # kick-on-bad-frame), not a thread-killing traceback
                        self._m_errors.inc()
                        log.warning("bad frame from client %d (%s); "
                                    "disconnecting it", client_id, e)
                        break
                    buf.meta["query_client_id"] = client_id
                    self.incoming.put(buf)
                elif cmd >= P.Cmd.HELLO and not self.resilient:
                    # a classic server drops a client that speaks the
                    # extension, as the JAX package's native core does:
                    # its reliable client then fails at connect
                    log.info("client %d sent %s to a classic server; "
                             "disconnecting it", client_id, cmd.name)
                    break
                elif cmd is P.Cmd.HELLO:
                    self._handle_hello(client_id, conn, payload)
                elif cmd in (P.Cmd.TRANSFER_EX, P.Cmd.TRANSFER_EX2):
                    if not self._handle_transfer_ex(
                            client_id, conn, payload,
                            ext2=cmd is P.Cmd.TRANSFER_EX2):
                        break
                elif cmd is P.Cmd.PING:
                    self._send(conn, P.Cmd.PING)
                elif cmd is P.Cmd.BYE:
                    break
        except (P.QueryProtocolError, OSError) as e:
            log.info("client %d disconnected: %s", client_id, e)
        finally:
            with self._clients_lock:
                self._clients.pop(client_id, None)
                instance = self._conn_instance.pop(client_id, None)
                # the instance mapping survives only until the client's
                # NEXT connection claims it (reconnect routing); clear it
                # if it still points at this dead connection
                if instance is not None and \
                        self._instances.get(instance) == client_id:
                    self._instances.pop(instance, None)
            try:
                conn.close()
            except OSError:
                pass

    # -- resilient protocol (HELLO / TRANSFER_EX / EXPIRED) ------------------
    def _handle_hello(self, client_id: int, conn: socket.socket,
                      payload: bytes) -> None:
        """HELLO announces the client's stable instance identity and its
        dedup-window size; the reply acknowledges extended-protocol
        support (a classic server drops the connection instead, so the
        client fails at connect). A trailing feature
        token list (``instance:window:dt1``) negotiates the
        distributed-trace extension: the echo grants only what this
        server also speaks."""
        from nnstreamer_tpu_torch.obs import distributed as _dist

        instance, _, rest = payload.decode().partition(":")
        win, _, feats = rest.partition(":")
        try:
            window = max(1, int(win)) if win else 64
        except ValueError:
            window = 64
        dt1 = _dist.FEATURE in _dist.parse_features(feats) \
            and _dist.enabled()
        with self._clients_lock:
            self._conn_instance[client_id] = instance
            self._instances[instance] = client_id
            if instance not in self._dedup:
                self._dedup[instance] = _res.DedupWindow(size=window)
            if dt1:
                self._dt1_instances.add(instance)
            else:
                self._dt1_instances.discard(instance)
        self._send(conn, P.Cmd.HELLO,
                   b"ok:" + _dist.FEATURE.encode() if dt1 else b"ok")
        log.info("client %d is resilient instance %s (dedup window %d%s)",
                 client_id, instance[:12], window,
                 ", dist-trace" if dt1 else "")

    def _handle_transfer_ex(self, client_id: int, conn: socket.socket,
                            payload: bytes, ext2: bool = False) -> bool:
        """One extended transfer: dedup first (a resend of a resolved
        request replays the cached reply, a still-pending one is
        dropped), then the deadline gate, then normal ingress. With
        ``ext2`` the header also carries distributed-trace context
        (trace id + client send stamp) that rides the buffer meta to
        result egress. Returns False to disconnect the client (bad
        frame)."""
        trace_id = 0
        try:
            if ext2:
                req_id, slack_s, trace_id, _sent_wall, _blob, body = \
                    P.unpack_ext2(payload)
            else:
                req_id, slack_s, body = P.unpack_ext(payload)
        except P.QueryProtocolError as e:
            self._m_errors.inc()
            log.warning("bad extended frame from client %d (%s); "
                        "disconnecting it", client_id, e)
            return False
        with self._clients_lock:
            instance = self._conn_instance.get(client_id)
            dedup = self._dedup.get(instance) if instance else None
            verdict = None if dedup is None else dedup.admit(req_id)
            # a connection the instance has left behind (its handler
            # still reading what arrived before the flap) keeps no
            # claim on a request a newer connection already resent
            if verdict is _res.NEW or (
                    verdict is _res.PENDING and
                    self._instances.get(instance) == client_id):
                self._owed[(instance, req_id)] = client_id
        if dedup is None:
            self._m_errors.inc()
            log.warning("TRANSFER_EX from client %d before HELLO; "
                        "disconnecting it", client_id)
            return False
        if verdict is _res.PENDING:
            # original invocation still in flight — its reply is now owed
            # to this connection and goes here when it lands
            self.dedup_hits += 1
            _res.metrics()["dedup_hits"].inc()
            return True
        if verdict is not _res.NEW:
            # already resolved: replay the cached reply, don't re-invoke
            self.dedup_hits += 1
            _res.metrics()["dedup_hits"].inc()
            cached_cmd, cached_payload = verdict
            self._send(conn, cached_cmd, cached_payload)
            return True
        now = time.monotonic()
        if slack_s == 0.0:
            # the sender clamps an already-blown deadline to exactly 0:
            # expired on arrival — shed before paying for unpack/invoke
            self._expire_req(instance, req_id, conn=conn)
            return True
        try:
            buf = P.unpack_buffer(body)
        except Exception as e:  # noqa: BLE001 — corrupt frame: orderly
            # disconnect, same as the classic TRANSFER path. Forget the
            # dedup admit so the client's resend of the intact frame
            # invokes instead of being dropped as a duplicate
            with self._clients_lock:
                dedup.forget(req_id)
                self._owed.pop((instance, req_id), None)
            self._m_errors.inc()
            log.warning("bad frame from client %d (%s); disconnecting it",
                        client_id, e)
            return False
        buf.meta["query_client_id"] = client_id
        buf.meta["net_req_id"] = req_id
        buf.meta["net_instance"] = instance
        if ext2:
            from nnstreamer_tpu_torch.obs import distributed as _dist

            # remote trace segment opens here: the ingress stamp is the
            # anchor result egress measures remote_total against, and
            # the wall stamp is the advisory send/recv split hint the
            # client clamps inside its own RTT window
            buf.meta["dist_trace"] = {
                "trace_id": trace_id,
                "recv_t": now,
                "recv_wall": _dist.wall_now(),
            }
        if slack_s > 0.0:
            # propagated deadline: stamp the remaining budget so the SLO
            # scheduler's admission test sees the sender's clock, and
            # leave a shed hook so note_shed can notify the origin client
            buf.meta["deadline_t"] = now + slack_s
            buf.meta["_net_expire"] = (self, instance, req_id)
        self.incoming.put(buf)
        return True

    def _expire_req(self, instance: str, req_id: int,
                    conn: Optional[socket.socket] = None) -> None:
        """Record + send an EXPIRED notice; the reply is cached in the
        dedup window so a resend of the expired request replays the
        notice instead of re-entering the pipeline."""
        reply = (P.Cmd.EXPIRED, P.pack_ext(req_id, -1.0))
        with self._clients_lock:
            dedup = self._dedup.get(instance)
            if dedup is not None:
                dedup.resolve(req_id, reply)
            cid = self._owed.pop((instance, req_id), None)
            if conn is None:
                if cid is None:
                    cid = self._instances.get(instance)
                conn = self._clients.get(cid) if cid is not None else None
        self.remote_expired += 1
        _res.metrics()["expired_remote"].inc()
        if conn is None:
            return
        try:
            self._send(conn, *reply)
        except OSError as e:
            log.info("EXPIRED notice for req %d not deliverable: %s",
                     req_id, e)

    def send_expired(self, instance: str, req_id: int) -> None:
        """Scheduler-shed hook (``resilience.note_remote_shed``): the
        remote SLO scheduler dropped this frame before dispatch."""
        self._expire_req(instance, req_id)

    # -- serving continuity --------------------------------------------------
    def checkpoint_state(self) -> Dict[str, Any]:
        """Durable resilient-protocol state for a rolling restart: the
        per-instance dedup windows (resolved replies only — plain
        command/bytes tuples) plus the chaos-test witness counters.
        Connection maps are NOT included: sockets die with the process,
        and each client's reconnect HELLO re-binds its instance to the
        new connection, landing resends in its restored window."""
        with self._clients_lock:
            windows = dict(self._dedup)
        return {
            "dedup": {inst: w.snapshot() for inst, w in windows.items()},
            "dedup_hits": self.dedup_hits,
            "remote_expired": self.remote_expired,
        }

    def restore_state(self, state: Dict[str, Any]) -> None:
        for inst, wstate in (state.get("dedup") or {}).items():
            with self._clients_lock:
                w = self._dedup.get(inst)
                if w is None:
                    # default-sized window: restore() adopts the saved size
                    w = self._dedup[inst] = _res.DedupWindow()
            w.restore(wstate)
        self.dedup_hits += int(state.get("dedup_hits", 0))
        self.remote_expired += int(state.get("remote_expired", 0))

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
        req_id = buf.meta.get("net_req_id")
        if req_id is not None:
            return self._send_result_ex(client_id, buf, int(req_id))
        core = self._core  # capture once: stop() nulls the attribute
        if core is not None:
            ok = core.send(client_id, int(P.Cmd.RESULT), P.pack_buffer(buf))
            if not ok:
                self._m_errors.inc()
                log.warning("result for client %d not deliverable",
                            client_id)
            return ok
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

    def _endpoint(self) -> str:
        """Stable human-readable name for this server in remote spans."""
        if self._endpoint_name is None:
            host = self.host if self.host not in ("", "0.0.0.0") \
                else socket.gethostname()
            self._endpoint_name = f"{host}:{self.port}"
        return self._endpoint_name

    def _send_result_ex(self, client_id: int, buf: TensorBuffer,
                        req_id: int) -> bool:
        """Resilient result: cache the reply in the instance's dedup
        window (so a post-reconnect resend replays it), then send it to
        the connection it is owed to (``_owed``) — after a flap, the one
        whose resend found the request still in flight, a different
        client id than the one the request arrived on. The
        cached reply is the packed frame (``pack_buffer`` fetches a
        device result to the host once), never the tensor."""
        instance = buf.meta.get("net_instance")
        with self._clients_lock:
            dedup = self._dedup.get(instance) if instance else None
            dt1 = instance in self._dt1_instances if instance else False
        dist = buf.meta.get("dist_trace")
        if dt1 and isinstance(dist, dict):
            # close the remote trace segment: piggyback this frame's
            # span vector (durations only — skew-safe) on the result
            from nnstreamer_tpu_torch.obs import distributed as _dist
            from nnstreamer_tpu_torch.obs import timeline as _tl

            body = P.pack_buffer(buf)  # the fetch belongs to the segment
            now = time.monotonic()
            total = max(now - float(dist.get("recv_t", now)), 0.0)
            stages = _dist.collect_frame_stages(
                buf.meta.get(_tl.TRACE_SEQ_META))
            blob = _dist.pack_span_blob(
                stages, total, float(dist.get("recv_wall", 0.0)),
                _dist.wall_now(), self._endpoint())
            reply = (P.Cmd.RESULT_EX2,
                     P.pack_ext2(req_id, -1.0,
                                 int(dist.get("trace_id", 0)),
                                 float(dist.get("recv_wall", 0.0)),
                                 blob, body))
        else:
            reply = (P.Cmd.RESULT_EX, P.pack_ext(req_id, -1.0,
                                                 P.pack_buffer(buf)))
        with self._clients_lock:
            if dedup is not None:
                dedup.resolve(req_id, reply)
            # the connection the reply is owed to (see ``_owed``); after
            # the resolve, a resend on a newer connection replays it
            cid = self._owed.pop((instance, req_id), client_id) \
                if instance else client_id
            conn = self._clients.get(cid)
        if conn is None:
            # cached for replay: the client's reconnect resend gets it
            log.info("result for instance %s req %d cached (no live "
                     "connection)", str(instance)[:12], req_id)
            return False
        try:
            self._send(conn, *reply)
            return True
        except OSError as e:
            self._m_errors.inc()
            log.warning("resilient result send to client %d failed: %s",
                        cid, e)
            return False

    def get_buffer(self, timeout: Optional[float] = None
                   ) -> Optional[TensorBuffer]:
        if self.wire == "nnstreamer":
            refsrv = self._refwire
            got = refsrv.get(timeout=timeout) if refsrv is not None \
                else None
            buf = None if got is None else self._refwire_buf(*got)
        elif self._core is not None:
            buf = self._native_get(timeout)
        else:
            try:
                buf = self.incoming.get(timeout=timeout)
            except _queue.Empty:
                return None
        if buf is not None:
            self._m_requests.inc()
        return buf

    def _native_get(self, timeout: Optional[float]
                    ) -> Optional[TensorBuffer]:
        """One buffer from the native core: a frame that does not unpack
        disconnects its sender (the Python loop's parity) and the wait
        goes on until ``timeout``."""
        core = self._core  # capture once: stop() nulls the attribute
        if core is None:
            return None
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
            got = core.wait_pop(remaining)
            if got is None:
                return None
            client_id, payload = got
            try:
                buf = P.unpack_buffer(payload)
            except Exception as e:  # noqa: BLE001 — corrupt frame
                self._m_errors.inc()
                log.warning("bad frame from client %d (%s); "
                            "disconnecting it", client_id, e)
                core.kick(client_id)
                continue
            buf.meta["query_client_id"] = client_id
            return buf
