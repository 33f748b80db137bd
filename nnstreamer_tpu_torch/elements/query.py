"""tensor_query_client / tensor_query_serversrc / tensor_query_serversink —
distributed pipeline offload elements.

Reference: ``gst/nnstreamer/tensor_query/`` — the client sends each input
buffer to a remote server pipeline and pushes the returned result
downstream (tensor_query_client.c:609); the server pipeline is bracketed by
serversrc (receives client buffers) and serversink (routes each result back
to its client by client-id meta). Client failover walks a server list
(``_client_retry_connection``:465).

The port of the JAX package's elements, each wire-compatible with the JAX
package in both directions: the classic path; the reference wire
(``wire=nnstreamer``: the reference's raw-struct query protocol on two
ports, ``query/refwire.py``); broker discovery (reference
``tensor_query_hybrid``: a serversrc with ``operation=`` advertises its
endpoint through a broker, ``query/discovery.py``, and a client with
``operation=`` walks the servers it finds there); the resilient transport
(``reliable=true``: request ids, a server dedup window, resend in order
after a reconnect, deadline propagation, circuit breakers, hedging,
``query/resilience.py``, with the distributed trace of
``obs/distributed.py``); and fleet balancing (``balance=shortest-slack``:
one channel a replica, routed by ``query/balance.py``, results released in
send order). ``reliable`` and ``balance`` need the classic wire.
"""

from __future__ import annotations

import os
import select
import socket
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

import numpy as np

from nnstreamer_tpu_torch.obs import distributed as _dist
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.obs import timeline as _timeline
from nnstreamer_tpu_torch.pipeline import faults as _faults
from nnstreamer_tpu_torch.pipeline.element import (
    CapsEvent,
    Element,
    FlowError,
    FlowReturn,
)
from nnstreamer_tpu_torch.pipeline.pipeline import SourceElement
from nnstreamer_tpu_torch.query import balance as _bal
from nnstreamer_tpu_torch.query import protocol as P
from nnstreamer_tpu_torch.query import refwire as R
from nnstreamer_tpu_torch.query import resilience as _res
from nnstreamer_tpu_torch.query.server import QueryServer
from nnstreamer_tpu_torch.registry import ELEMENT, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensors.types import TensorFormat, TensorsConfig


class _BChannel:
    """One balance-mode connection to one replica endpoint: its socket,
    its dt1 grant, and the entries currently routed to it (send order).

    Reconnects are sticky: a failed channel retries ITS endpoint with
    bounded backoff before its entries are rerouted, so resends land in
    that replica's (possibly checkpoint-restored) dedup window and stay
    exactly-once across a rolling restart; only after ``max_retry``
    consecutive failures do the survivors hedge to a sibling replica."""

    __slots__ = ("endpoint", "sock", "dt1", "pending", "failures",
                 "next_attempt_t")

    def __init__(self, endpoint: Tuple[str, int]):
        self.endpoint = endpoint
        self.sock: Optional[socket.socket] = None
        self.dt1 = False
        self.pending: List[_res.PendingEntry] = []
        self.failures = 0          # consecutive connect/stall failures
        self.next_attempt_t = 0.0  # monotonic gate on the next reconnect

    def kill(self) -> None:
        sock, self.sock = self.sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass


@subplugin(ELEMENT, "tensor_query_client")
class TensorQueryClient(Element):
    ELEMENT_NAME = "tensor_query_client"
    PROPERTIES = {
        **Element.PROPERTIES,
        "host": "127.0.0.1",
        "port": 3000,
        "dest_host": None,   # alias pair (reference uses dest-host/dest-port)
        "dest_port": None,
        "servers": None,     # failover list "host1:port1,host2:port2"
        "timeout": P.DEFAULT_TIMEOUT,
        "max_retry": 3,
        # >1 pipelines the offload: up to N requests ride the connection
        # before the first result is awaited (responses return in order).
        # Hides the network+invoke round trip behind the stream. 1 = the
        # reference's synchronous per-frame round trip (with per-frame
        # resend-on-reconnect); >1 drops in-flight frames on a connection
        # error (streaming frame-drop semantics, tensor_filter.c:699-705).
        "max_in_flight": 1,
        # broker discovery (reference query-hybrid): find servers by
        # operation name instead of static host/port
        "operation": None,
        "broker_host": "127.0.0.1",
        "broker_port": 1883,
        # read-only counter: frames lost to connection failures while in
        # flight (max_in_flight>1)
        "frames_dropped": 0,
        # "nnstpu" = NTQ1 framing; "nnstreamer" = the reference's
        # raw-struct wire (query/refwire.py) — offload to an unmodified
        # reference tensor_query_serversrc/serversink pair
        "wire": "nnstpu",
        # refwire result connection (reference server-sink port);
        # 0 → src port + 1 (the reference's usual pairing)
        "sink_port": 0,
        # -- resilient transport (query/resilience.py) -------------------
        # All off by default: with none of these set the classic wire
        # (commands 1-8) and the classic frame-drop semantics above are
        # byte-identical to a build without the extension.
        # reliable=true switches to the extended protocol: per-request
        # ids + a server dedup window make reconnect resends idempotent,
        # so in-flight frames (any max-in-flight) are resent in order
        # after a connection error instead of dropped. Requires a
        # serversrc started with reliable=true (nnstpu wire only).
        "reliable": False,
        # forward the frame's remaining SLO slack (meta deadline_t, as
        # stamped by a local slo-budget queue) in the TRANSFER_EX header
        # so the REMOTE scheduler sheds work that can no longer make its
        # budget; shed/late frames come back as EXPIRED, not results
        "propagate_deadline": False,
        # per-endpoint circuit breaker: open after N consecutive connect
        # failures, re-probe (half-open) after breaker-reset-ms
        "breaker_failures": 5,
        "breaker_reset_ms": 1000.0,
        # >0 arms hedged failover: when no result lands within
        # max(hedge-ms, p99 * 1.5) the client fails over to the next
        # replica and resends (the dedup window absorbs duplicates)
        "hedge_ms": 0.0,
        # reconnect backoff base (bounded exponential, jittered)
        "reconnect_backoff_ms": 50.0,
        # read-only counter: frames the REMOTE end expired (deadline
        # propagation) — intentional sheds, not losses
        "frames_expired": 0,
        # -- fleet balancing (query/balance.py) --------------------------
        # "shortest-slack" (requires reliable=true) keeps a channel per
        # live endpoint and routes each frame to the one with the lowest
        # expected completion time (per-endpoint RTT EWMA + local
        # in-flight + the load block of refreshed discovery ads).
        # Results deliver downstream in send order. "off" (default, also
        # forced by NNSTPU_FLEET=0) keeps the single-connection path.
        "balance": "off",
        # >0 ages discovery ads out of the balancer's candidate list
        # when a replica stops refreshing (pair with the serversrc's
        # advertise-interval-s; 0 trusts retained ads forever)
        "discovery_stale_s": 0.0,
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        #: the classic wire's socket; with wire=nnstreamer the refwire
        #: client, so "is connected" reads the same on both wires
        self._sock = None
        self._refclient: Optional[R.RefWireClient] = None
        #: refwire: the server's APPROVE caps as a TensorsConfig, which
        #: rebuilds typed results from raw memories (None: results u8)
        self._server_config = None
        self._server_idx = 0
        self._lock = threading.Lock()
        #: (pts, meta) of requests sent but not yet answered (in order)
        self._pending: List[tuple] = []
        self._m_sent = None  # created lazily: labels need the pipeline
        # -- reliable-mode state (query/resilience.py) -------------------
        #: stable identity across reconnects — the server's dedup window
        #: and result routing key on this, not on the per-connection id
        self._r_instance = uuid.uuid4().hex
        self._r_next_id = 1  # monotone per-instance request id
        self._r_pending: List[_res.PendingEntry] = []
        #: results that arrived ahead of an earlier request still in
        #: flight, by request id: a reconnect's replays and a request
        #: invoked before the flap can reach us out of order, and the
        #: transport delivers in request order
        self._r_held: Dict[int, tuple] = {}
        self._r_breakers: dict = {}  # (host, port) → CircuitBreaker
        #: (host, port) → EndpointStats — per-endpoint like the breakers,
        #: so hedge timeouts and balancer scores use the latency
        #: distribution of the replica actually being talked to
        self._r_stats: Dict[Tuple[str, int], _res.EndpointStats] = {}
        self._r_endpoint: Optional[Tuple[str, int]] = None
        #: this connection granted the dt1 distributed-trace feature in
        #: its HELLO echo — only then do we speak TRANSFER_EX2
        self._r_dt1 = False
        # -- balance-mode state (query/balance.py) -----------------------
        self._b_channels: Dict[Tuple[str, int], _BChannel] = {}
        self._b_pending: Dict[int, _res.PendingEntry] = {}  # req_id →
        self._b_results: Dict[int, tuple] = {}  # req_id → (result, entry)
        self._b_done_ids: set = set()  # completed without a result
        self._b_deliver_next: Optional[int] = None  # in-order watermark
        self._b_discovery = None  # persistent ServerDiscovery (balance)

    def set_property(self, key: str, value) -> None:
        if key.replace("-", "_") in ("frames_dropped", "frames_expired"):
            raise ValueError(f"tensor_query_client: {key} is read-only")
        super().set_property(key, value)

    def _obs_sent(self):
        """``nns_query_client_sent_bytes_total``: every byte this client
        wrote to its connections (frame headers included)."""
        if self._m_sent is None:
            self._m_sent = get_registry().counter(
                "nns_query_client_sent_bytes_total",
                "Bytes a query client wrote to its server connection",
                pipeline=getattr(self.pipeline, "name", "") or "",
                element=self.name)
        return self._m_sent

    def obs_snapshot(self):
        out = super().obs_snapshot()
        out["sent_bytes"] = int(self._obs_sent().value)
        return out

    def _drop_pending_locked(self) -> int:
        """Clear in-flight requests, bumping the frames-dropped counter."""
        n = len(self._pending) + len(self._r_pending) + len(self._b_pending)
        if n:
            self._pending.clear()
            self._r_pending.clear()
            self._b_pending.clear()
            self._props["frames_dropped"] = \
                int(self._props.get("frames_dropped", 0)) + n
        for ch in self._b_channels.values():
            ch.pending.clear()
        self._b_results.clear()
        self._b_done_ids.clear()
        self._b_deliver_next = None
        return n

    def _server_list(self) -> List[Tuple[str, int]]:
        operation = self.get_property("operation")
        if operation:
            from nnstreamer_tpu_torch.query.discovery import ServerDiscovery

            disco = ServerDiscovery(self.get_property("broker_host"),
                                    int(self.get_property("broker_port")),
                                    str(operation))
            try:
                found = disco.wait_servers(
                    timeout=float(self.get_property("timeout")))
            finally:
                disco.close()
            if not found:
                raise P.QueryProtocolError(
                    f"no servers advertise operation {operation!r}"
                )
            return found
        servers = self.get_property("servers")
        if servers:
            out = []
            for item in str(servers).split(","):
                h, p = item.rsplit(":", 1)
                out.append((h.strip(), int(p)))
            return out
        host = self.get_property("dest_host") or self.get_property("host")
        port = int(self.get_property("dest_port") or self.get_property("port"))
        return [(host, port)]

    def _refwire(self) -> bool:
        return str(self.get_property("wire")) == "nnstreamer"

    def _connect_one(self, host: str, port: int) -> None:
        """Connect + handshake on the configured wire."""
        if self._refwire():
            self._connect_refwire(host, port)
            return
        self._sock = self._open_nnstpu(host, port)

    def _open_nnstpu(self, host: str, port: int) -> socket.socket:
        """Classic-wire connect + handshake, returning the fresh socket
        (balance mode opens one of these per endpoint; the
        single-connection paths assign it to ``self._sock``). Results
        route by connection, so the server's CLIENT_ID is read and
        dropped."""
        caps_repr = repr(self.sinkpad.caps) if self.sinkpad.caps else ""
        timeout = float(self.get_property("timeout"))
        sock = P.connect(host, port, timeout=timeout)
        try:
            P.send_msg(sock, P.Cmd.REQUEST_INFO, caps_repr.encode())
            cmd, payload = P.recv_msg(sock)
            if cmd is P.Cmd.DENY:
                raise P.QueryProtocolError(f"server {host}:{port} denied")
            if cmd is not P.Cmd.APPROVE:
                raise P.QueryProtocolError(f"bad handshake reply {cmd}")
            P.recv_msg(sock)  # CLIENT_ID
        except BaseException:
            sock.close()
            raise
        return sock

    def _connect_refwire(self, host: str, port: int) -> None:
        """Reference-wire connect: the caps handshake on the server's src
        port, then the result connection on its sink port."""
        in_caps = (R.fixated_caps_string(self.sinkpad.caps)
                   if self.sinkpad.caps else "")
        sink_port = int(self.get_property("sink_port") or 0) or None
        rc = R.RefWireClient(host, port, sink_port=sink_port,
                             in_caps=in_caps,
                             timeout=float(self.get_property("timeout")))
        self._server_config = None
        if rc.server_caps:
            try:
                from nnstreamer_tpu_torch.pipeline.parse import (
                    parse_caps_string,
                )

                self._server_config = TensorsConfig.from_caps(
                    parse_caps_string(rc.server_caps))
            except Exception:  # noqa: BLE001 — results stay u8
                self.log.info("server caps %r not parseable; results "
                              "surface as u8", rc.server_caps)
        self._refclient = self._sock = rc

    def _connect(self):
        """Connect with failover across the server list (reference
        _client_retry_connection)."""
        servers = self._server_list()
        last_err = None
        for _ in range(int(self.get_property("max_retry")) * len(servers)):
            host, port = servers[self._server_idx % len(servers)]
            try:
                self._connect_one(host, port)
                return
            except (OSError, P.QueryProtocolError) as e:
                last_err = e
                self._server_idx += 1
                self.log.warning("connect to %s:%d failed (%s); trying next",
                                 host, port, e)
        raise P.QueryProtocolError(
            f"all query servers unreachable: {last_err}"
        )

    def _disconnect_locked(self):
        """Close and forget the current connection (both wires)."""
        sock, self._sock = self._sock, None
        self._refclient = None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def stop(self):
        with self._lock:
            if self._sock is not None and self._refclient is None:
                try:
                    P.send_msg(self._sock, P.Cmd.BYE)
                except OSError:
                    pass
            self._disconnect_locked()
            for ch in self._b_channels.values():
                if ch.sock is not None:
                    try:
                        P.send_msg(ch.sock, P.Cmd.BYE)
                    except OSError:
                        pass
                ch.kill()
            self._b_channels.clear()
            if self._b_discovery is not None:
                self._b_discovery.close()
                self._b_discovery = None
            # in-flight requests die with the connection — a restart must
            # not pair old (pts, meta) with new results
            self._drop_pending_locked()
            self._r_held.clear()
        super().stop()

    def transform_caps(self, pad, caps):
        return None  # output caps come from the first result buffer

    def _send_buf(self, buf):
        act = None
        fi = _faults.ACTIVE
        if fi is not None:
            act = fi.action("query.send",
                            seq=buf.meta.get(_timeline.TRACE_SEQ_META))
            if act == "drop":
                return  # the bytes vanish; recv timeout / retry recovers
            if act == "disconnect":
                self._disconnect_locked()
                raise OSError("injected fault: query.send disconnect")
        if self._refclient is not None:
            if act == "corrupt":  # refwire has no framed payload to
                # mangle in place — the nearest physical fault is a
                # connection killed mid-send
                self._disconnect_locked()
                raise OSError("injected fault: query.send corrupt")
            sent = self._refclient.send(R.buffer_to_mems(buf.to_host()),
                                        pts=buf.pts)
        else:
            payload = P.pack_buffer(buf)
            if act == "corrupt":
                # truncation is guaranteed-detectable: the server's
                # unpack runs out of bytes and kicks this connection
                payload = payload[:max(1, len(payload) // 2)]
            sent = P.send_msg(self._sock, P.Cmd.TRANSFER, payload)
        self._obs_sent().inc(sent)

    def _recv_result(self):
        fi = _faults.ACTIVE
        if fi is not None:
            act = fi.action("query.recv")
            if act == "disconnect":
                self._disconnect_locked()
                raise OSError("injected fault: query.recv disconnect")
            if act is not None:
                # drop/corrupt of an in-order result poisons the
                # response stream — surface as a protocol error so the
                # caller's reconnect logic takes over
                raise P.QueryProtocolError(
                    f"injected fault: query.recv {act}")
        if self._refclient is not None:
            info, mems = self._refclient.recv_result()
            if self._server_config is not None:
                return R.mems_to_buffer(mems, self._server_config, info)
            return TensorBuffer(
                [np.frombuffer(m, dtype=np.uint8) for m in mems],
                pts=info.get("pts"))
        cmd, payload = P.recv_msg(self._sock)
        if cmd is not P.Cmd.RESULT:
            raise P.QueryProtocolError(f"expected RESULT, got {cmd}")
        return P.unpack_buffer(payload)

    def _push_result(self, result, pts, meta):
        result = result.replace(pts=pts, meta=dict(meta))
        if self.srcpad.caps is None:
            self.srcpad.set_caps(
                TensorsConfig.from_arrays(result.tensors).to_caps()
            )
        return self.srcpad.push(result)

    # -- reliable transport (query/resilience.py) ---------------------------
    def _r_breaker(self, host: str, port: int) -> _res.CircuitBreaker:
        key = (host, port)
        br = self._r_breakers.get(key)
        if br is None:
            br = self._r_breakers[key] = _res.CircuitBreaker(
                failures=int(self.get_property("breaker_failures") or 5),
                reset_s=float(self.get_property("breaker_reset_ms")
                              or 1000.0) / 1e3,
                endpoint=f"{host}:{port}")
        return br

    def _r_stat(self, host: str, port: int) -> _res.EndpointStats:
        key = (host, port)
        st = self._r_stats.get(key)
        if st is None:
            st = self._r_stats[key] = _res.EndpointStats()
        return st

    def _r_make_entry(self, buf) -> _res.PendingEntry:
        """A new request: its body packed once (a device payload fetched
        to the host once), so every resend sends the same host bytes."""
        deadline_t = None
        if self.get_property("propagate_deadline"):
            d = buf.meta.get("deadline_t")
            if d is not None:
                deadline_t = float(d)
        req_id = self._r_next_id
        self._r_next_id += 1
        return _res.PendingEntry(req_id, buf.pts, dict(buf.meta),
                                 P.pack_buffer(buf), deadline_t=deadline_t)

    def _r_send_entry(self, entry: _res.PendingEntry,
                      ch: Optional[_BChannel] = None) -> None:
        """Send (or resend) one entry as TRANSFER_EX. The slack is
        recomputed from the entry's deadline at every send, so a resend
        carries the budget that is actually left. ``ch`` routes the send
        over a balance-mode channel; None (default) is the
        single-connection path."""
        sock = self._sock if ch is None else ch.sock
        dt1 = self._r_dt1 if ch is None else ch.dt1
        entry.endpoint = self._r_endpoint if ch is None else ch.endpoint
        now = time.monotonic()
        if dt1:
            trace_id = entry.meta.get(_timeline.TRACE_SEQ_META)
            entry.sent_wall = _dist.wall_now()
            cmd = P.Cmd.TRANSFER_EX2
            payload = P.pack_ext2(
                entry.req_id, entry.slack_s(now),
                int(trace_id) if trace_id is not None else entry.req_id,
                entry.sent_wall, b"", entry.body)
        else:
            cmd = P.Cmd.TRANSFER_EX
            payload = P.pack_ext(entry.req_id, entry.slack_s(now),
                                 entry.body)
        fi = _faults.ACTIVE
        if fi is not None:
            act = fi.action("query.send",
                            seq=entry.meta.get(_timeline.TRACE_SEQ_META))
            if act == "drop":
                entry.sent_t = now
                return  # swallowed; the recv timeout path resends it
            if act == "disconnect":
                if ch is None:
                    self._disconnect_locked()
                else:
                    ch.kill()
                raise OSError("injected fault: query.send disconnect")
            if act == "corrupt":
                # guaranteed-detectable: the server's unpack runs out of
                # bytes, forgets the dedup entry, and kicks us — the
                # resend after reconnect re-invokes exactly once
                payload = payload[:max(1, len(payload) // 2)]
        self._obs_sent().inc(P.send_msg(sock, cmd, payload))
        entry.sent_t = now

    def _hello_on(self, sock) -> bool:
        """HELLO handshake on one connection; returns the dt1 grant."""
        window = max(1, int(self.get_property("max_in_flight")))
        P.send_msg(sock, P.Cmd.HELLO,
                   f"{self._r_instance}:{max(64, window * 8)}"
                   f"{_dist.hello_offer()}".encode())
        try:
            cmd, payload = P.recv_msg(sock)
        except socket.timeout:
            raise P.QueryProtocolError(
                "server did not acknowledge HELLO — reliable mode needs "
                "a tensor_query_serversrc started with reliable=true"
            ) from None
        except P.QueryProtocolError as e:
            raise P.QueryProtocolError(
                f"server closed the connection at HELLO ({e}) — reliable "
                f"mode needs a tensor_query_serversrc started with "
                f"reliable=true") from None
        if cmd is not P.Cmd.HELLO:
            raise P.QueryProtocolError(
                f"bad HELLO reply {cmd} — reliable mode needs a "
                f"tensor_query_serversrc started with reliable=true")
        return _dist.hello_accepts(payload)

    def _r_hello(self) -> None:
        self._r_dt1 = False
        self._r_dt1 = self._hello_on(self._sock)

    def _r_resend_pending(self) -> None:
        """Resend the undelivered suffix in order after a reconnect.
        Everything still pending is resent — the server's dedup window
        replays results for frames that DID land, so over-resending is
        safe and under-resending (the real loss bug) is impossible."""
        if not self._r_pending:
            return
        m = _res.metrics()
        tl = _timeline.ACTIVE
        for entry in self._r_pending:
            self._r_send_entry(entry)
            m["retries"].inc()
            if tl is not None:
                tl.mark("net_retry",
                        entry.meta.get(_timeline.TRACE_SEQ_META),
                        track="net", req_id=entry.req_id)
        self.log.info("resent %d in-flight frame(s) after reconnect",
                      len(self._r_pending))

    def _r_ensure_connected(self) -> None:
        """Reconnect with per-endpoint circuit breaking and bounded
        jittered backoff, then handshake (classic + HELLO) and resend
        the undelivered suffix."""
        if self._sock is not None:
            return
        servers = self._server_list()
        policy = _res.RetryPolicy(
            base_ms=float(self.get_property("reconnect_backoff_ms")
                          or 50.0),
            key=self.name)
        last_err: Optional[Exception] = None
        attempts = max(1, int(self.get_property("max_retry"))) * \
            len(servers)
        for attempt in range(1, attempts + 1):
            host, port = servers[self._server_idx % len(servers)]
            breaker = self._r_breaker(host, port)
            if not breaker.allow():
                if last_err is None:
                    last_err = P.QueryProtocolError(
                        f"breaker open for {host}:{port}")
                self._server_idx += 1
                policy.sleep(attempt)
                continue
            try:
                self._connect_one(host, port)
                # stamped before the resends so every entry's RTT
                # observation credits the endpoint it was sent to
                self._r_endpoint = (host, port)
                self._r_hello()
                self._r_resend_pending()
            except (OSError, P.QueryProtocolError) as e:
                last_err = e
                breaker.record_failure()
                self._disconnect_locked()
                self._server_idx += 1
                self.log.warning("connect to %s:%d failed (%s); "
                                 "backing off", host, port, e)
                policy.sleep(attempt)
                continue
            breaker.record_success()
            return
        raise P.QueryProtocolError(
            f"all query servers unreachable: {last_err}")

    def _r_conn_failure(self, err: Exception) -> None:
        if self._r_endpoint is not None:
            self._r_breaker(*self._r_endpoint).record_failure()
        self._disconnect_locked()
        self.log.warning("reliable transport error: %s; will reconnect",
                         err)

    def _r_transmit(self, entry: _res.PendingEntry) -> None:
        """Send a new entry, reconnecting through failures. Once the
        entry is in ``_r_pending`` the resend-on-reconnect discipline
        owns it; this loop only has to get the FIRST copy out."""
        failures = 0
        while True:
            self._r_ensure_connected()
            try:
                self._r_send_entry(entry)
                self._r_pending.append(entry)
                return
            except (OSError, P.QueryProtocolError) as e:
                failures += 1
                self._r_conn_failure(e)
                if failures > max(1, int(self.get_property("max_retry"))):
                    raise

    def _r_recv(self, timeout: float):
        fi = _faults.ACTIVE
        if fi is not None:
            act = fi.action("query.recv")
            if act == "disconnect":
                self._disconnect_locked()
                raise OSError("injected fault: query.recv disconnect")
            if act is not None:
                raise P.QueryProtocolError(
                    f"injected fault: query.recv {act}")
        self._sock.settimeout(max(0.001, timeout))
        return P.recv_msg(self._sock)

    def _r_pop_pending(self, req_id: int) -> Optional[_res.PendingEntry]:
        for i, entry in enumerate(self._r_pending):
            if entry.req_id == req_id:
                return self._r_pending.pop(i)
        return None

    def _r_result(self, cmd, payload, pop):
        """A RESULT_EX/EX2 payload: ``(result, entry)`` for the pending
        entry ``pop`` claims, or None for a dedup replay of a result
        already delivered. Observes the round trip on the entry's
        endpoint and splices an EX2 span blob into this frame's
        ledger."""
        if cmd is P.Cmd.RESULT_EX:
            req_id, _slack, body = P.unpack_ext(payload)
            blob = None
        else:
            req_id, _slack, _tid, _stamp, blob, body = \
                P.unpack_ext2(payload)
        entry = pop(req_id)
        if entry is None:
            return None
        now = time.monotonic()
        if entry.sent_t:
            if entry.endpoint is not None:
                self._r_stat(*entry.endpoint).observe(now - entry.sent_t)
            if blob is not None:
                # the remote span vector, anchored inside our own RTT
                # window
                _dist.splice_remote(
                    _timeline.ACTIVE,
                    entry.meta.get(_timeline.TRACE_SEQ_META),
                    entry.sent_t, now, entry.sent_wall,
                    _dist.unpack_span_blob(blob))
        return P.unpack_buffer(body), entry

    def _note_expired(self, entry: _res.PendingEntry, req_id: int) -> None:
        self._props["frames_expired"] = \
            int(self._props.get("frames_expired", 0)) + 1
        tl = _timeline.ACTIVE
        if tl is not None:
            tl.mark("net_expired",
                    entry.meta.get(_timeline.TRACE_SEQ_META),
                    track="net", req_id=req_id)
        self.log.info("frame pts=%s expired remotely (req %d)",
                      entry.pts, req_id)

    def _r_drain_locked(self, min_pending: int):
        """Receive until fewer than ``min_pending`` entries remain in
        flight (caller holds the lock). Returns ``(done, err)`` where
        ``done`` is ``[(result, entry), ...]`` in arrival order; a recv
        timeout hedges to the next replica (when armed) or reconnects,
        and only after ``max_retry`` consecutive recoveries without
        progress does ``err`` report the failure (with the still-pending
        frames dropped and counted — the honest last resort)."""
        done: List[tuple] = []
        err: Optional[Exception] = None
        failures = 0
        limit = max(1, int(self.get_property("max_retry")))
        timeout = float(self.get_property("timeout"))
        hedge_ms = float(self.get_property("hedge_ms") or 0.0)
        tl = _timeline.ACTIVE
        while len(self._r_pending) >= min_pending:
            hedging = hedge_ms > 0.0 and failures == 0
            if hedging:
                st = self._r_stat(*self._r_endpoint) \
                    if self._r_endpoint is not None else None
                recv_t = min(timeout,
                             st.hedge_timeout(hedge_ms / 1e3)
                             if st is not None else hedge_ms / 1e3)
            else:
                recv_t = timeout
            try:
                self._r_ensure_connected()
                cmd, payload = self._r_recv(recv_t)
            except socket.timeout:
                failures += 1
                if failures > limit:
                    err = TimeoutError(
                        f"{self.name}: no result within {recv_t:.3f}s "
                        f"after {failures - 1} recovery attempt(s)")
                    break
                if hedging:
                    _res.metrics()["hedges"].inc()
                    if tl is not None:
                        tl.mark("net_hedge", None, track="net",
                                endpoint=str(self._r_endpoint))
                    self._server_idx += 1  # fail over to the next replica
                    self.log.warning("hedge timer (%.3fs) fired; failing "
                                     "over to the next replica", recv_t)
                else:
                    self.log.warning("recv timed out after %.3fs; "
                                     "reconnecting", recv_t)
                self._disconnect_locked()
                continue
            except (OSError, P.QueryProtocolError) as e:
                failures += 1
                self._r_conn_failure(e)
                if failures > limit:
                    err = e
                    break
                continue
            if cmd in (P.Cmd.RESULT_EX, P.Cmd.RESULT_EX2):
                got = self._r_result(cmd, payload, self._r_pop_pending)
                if got is None:
                    continue  # dedup replay of a delivered result
                self._r_held[got[1].req_id] = got
                self._r_release_held(done)
                failures = 0
            elif cmd is P.Cmd.EXPIRED:
                req_id, _slack, _body = P.unpack_ext(payload)
                entry = self._r_pop_pending(req_id)
                if entry is not None:
                    self._note_expired(entry, req_id)
                    self._r_release_held(done)
                failures = 0
            elif cmd is P.Cmd.PING:
                continue
            else:
                failures += 1
                self._r_conn_failure(P.QueryProtocolError(
                    f"unexpected {cmd} in reliable mode"))
                if failures > limit:
                    err = P.QueryProtocolError(
                        f"unexpected {cmd} in reliable mode")
                    break
        if err is not None:
            n = self._drop_pending_locked()
            if n:
                self.log.warning("reliable transport exhausted (%s); "
                                 "dropped %d frame(s)", err, n)
            self._r_release_held(done)
        return done, err

    def _r_release_held(self, done: List[tuple]) -> None:
        """Move the held results that no request still in flight
        precedes onto ``done``, in request order."""
        first = min((e.req_id for e in self._r_pending), default=None)
        for rid in sorted(self._r_held):
            if first is not None and rid > first:
                break
            done.append(self._r_held.pop(rid))

    def _chain_resilient(self, buf):
        if self._refwire():
            raise FlowError(
                "tensor_query_client: reliable=true requires wire=nnstpu")
        window = max(1, int(self.get_property("max_in_flight")))
        with self._lock:
            entry = self._r_make_entry(buf)
            self._r_transmit(entry)
            done, err = self._r_drain_locked(min_pending=window)
        return self._push_done(done, err)

    def _push_done(self, done, err):
        ret = FlowReturn.OK
        for result, done_entry in done:
            ret = self._push_result(result, done_entry.pts,
                                    done_entry.meta)
        if err is not None:
            raise err  # after pushing the good results collected so far
        return ret

    # -- fleet balancing (query/balance.py) ---------------------------------
    def _balance_on(self) -> bool:
        """True when the shortest-slack balancer owns this client's
        routing. ``balance=off`` (default) and the ``NNSTPU_FLEET=0``
        kill switch both leave the single-connection paths untouched —
        no balance state is ever created."""
        mode = str(self.get_property("balance") or _bal.MODE_OFF)
        if mode in ("", _bal.MODE_OFF):
            return False
        if os.environ.get("NNSTPU_FLEET", "").strip() == "0":
            return False
        if mode != _bal.MODE_SHORTEST_SLACK:
            raise FlowError(
                f"tensor_query_client: unknown balance mode {mode!r} "
                f"(off | shortest-slack)")
        return True

    def _b_server_list(self) -> List[Tuple[str, int]]:
        """Candidate endpoints, refreshed per route. With an operation,
        the discovery subscription is kept open (unlike the classic
        per-connect lookup) so refreshed ads keep delivering fresh load
        blocks and stale replicas age out mid-stream."""
        operation = self.get_property("operation")
        if not operation:
            return self._server_list()  # static servers=/host:port list
        if self._b_discovery is None:
            from nnstreamer_tpu_torch.query.discovery import ServerDiscovery

            stale = float(self.get_property("discovery_stale_s") or 0.0)
            self._b_discovery = ServerDiscovery(
                self.get_property("broker_host"),
                int(self.get_property("broker_port")),
                str(operation), stale_s=stale if stale > 0 else None)
            return self._b_discovery.wait_servers(
                timeout=float(self.get_property("timeout")))
        found = self._b_discovery.servers_now()
        if not found:
            found = self._b_discovery.wait_servers(
                timeout=float(self.get_property("timeout")))
        return found

    def _b_channel(self, endpoint: Tuple[str, int]) -> _BChannel:
        ch = self._b_channels.get(endpoint)
        if ch is None:
            ch = self._b_channels[endpoint] = _BChannel(endpoint)
        return ch

    def _b_candidates(self, exclude=()):
        """(endpoint, rtt, inflight, load) rows for the policy ranking —
        breaker-open endpoints excluded here (the policy stays pure)."""
        cands = []
        for host, port in self._b_server_list():
            ep = (host, port)
            if ep in exclude:
                continue
            if not self._r_breaker(host, port).allow():
                continue
            ch = self._b_channels.get(ep)
            raw = self._b_discovery.load(host, port) \
                if self._b_discovery is not None else None
            load = _bal.parse_ad_load({"load": raw}) if raw else None
            cands.append((ep, self._r_stat(host, port).ewma(),
                          len(ch.pending) if ch is not None else 0, load))
        return cands

    def _b_ensure_channel(self, ch: _BChannel) -> None:
        """Connect a dead channel (classic handshake + HELLO) and resend
        the entries still routed to it, in send order: the dead socket
        lost their results, and the replica's dedup window replays the
        ones it resolved. Whichever path revives the channel — the
        recovery pass or a new route — resends them (ROADMAP C.45: the
        JAX client resends only from the recovery pass, so a channel a
        new route revived first left them to its stall timer)."""
        if ch.sock is not None:
            return
        sock = self._open_nnstpu(*ch.endpoint)
        try:
            ch.dt1 = self._hello_on(sock)
        except (OSError, P.QueryProtocolError):
            try:
                sock.close()
            except OSError:
                pass
            raise
        ch.sock = sock
        m = _res.metrics()
        for e in ch.pending:
            self._r_send_entry(e, ch=ch)
            m["retries"].inc()

    def _b_channel_failure(self, ch: _BChannel, err: Exception) -> None:
        backoff_s = float(self.get_property("reconnect_backoff_ms")
                          or 50.0) / 1e3
        self._r_breaker(*ch.endpoint).record_failure()
        ch.kill()
        ch.failures += 1
        ch.next_attempt_t = time.monotonic() + min(
            2.0, backoff_s * (2 ** min(ch.failures - 1, 6)))
        self.log.warning("fleet channel %s:%d error: %s (failure %d)",
                         ch.endpoint[0], ch.endpoint[1], err, ch.failures)

    def _b_route(self, entry: _res.PendingEntry, exclude=()) -> None:
        """Send one entry to the best-scoring endpoint, walking the
        ranking (then backing off and re-resolving the server list) on
        failure. Raises only when no replica accepts the frame within
        ``max_retry`` rounds."""
        policy = _res.RetryPolicy(
            base_ms=float(self.get_property("reconnect_backoff_ms")
                          or 50.0),
            key=f"{self.name}:lb")
        limit = max(1, int(self.get_property("max_retry")))
        last_err: Optional[Exception] = None
        for attempt in range(1, limit + 1):
            ranked = _bal.rank(self._b_candidates(exclude=exclude))
            if not ranked and exclude:
                # every sibling is breaker-open or gone — the excluded
                # (draining) endpoint beats dropping the frame
                ranked = _bal.rank(self._b_candidates())
            for sc, ep in ranked:
                ch = self._b_channel(ep)
                if ch.sock is None and \
                        time.monotonic() < ch.next_attempt_t:
                    continue  # endpoint still in reconnect backoff
                try:
                    self._b_ensure_channel(ch)
                    self._r_send_entry(entry, ch=ch)
                except (OSError, P.QueryProtocolError) as e:
                    last_err = e
                    self._b_channel_failure(ch, e)
                    continue
                self._r_breaker(*ep).record_success()
                ch.pending.append(entry)
                self._b_pending[entry.req_id] = entry
                _bal.note_route(ep, sc)
                return
            policy.sleep(attempt)
        raise P.QueryProtocolError(
            f"fleet: no replica accepted req {entry.req_id}: {last_err}")

    def _b_recv(self, ch: _BChannel, timeout: float):
        fi = _faults.ACTIVE
        if fi is not None:
            act = fi.action("query.recv")
            if act == "disconnect":
                ch.kill()
                raise OSError("injected fault: query.recv disconnect")
            if act is not None:
                raise P.QueryProtocolError(
                    f"injected fault: query.recv {act}")
        ch.sock.settimeout(max(0.001, timeout))
        return P.recv_msg(ch.sock)

    def _b_pop(self, req_id: int) -> Optional[_res.PendingEntry]:
        """Claim a completed request id — None for a duplicate (the
        hedged twin already answered; ignore, exactly-once holds)."""
        entry = self._b_pending.pop(req_id, None)
        if entry is None:
            return None
        for other in self._b_channels.values():
            for i, e in enumerate(other.pending):
                if e.req_id == req_id:
                    other.pending.pop(i)
                    break
        return entry

    def _b_handle_msg(self, ch: _BChannel, cmd, payload) -> bool:
        """Apply one received message; True when it completed a frame."""
        if cmd in (P.Cmd.RESULT_EX, P.Cmd.RESULT_EX2):
            got = self._r_result(cmd, payload, self._b_pop)
            if got is None:
                return False  # dedup replay of a delivered result
            self._b_results[got[1].req_id] = got
            ch.failures = 0
            return True
        if cmd is P.Cmd.EXPIRED:
            req_id, _slack, _body = P.unpack_ext(payload)
            entry = self._b_pop(req_id)
            ch.failures = 0
            if entry is None:
                return False
            self._b_done_ids.add(req_id)
            self._note_expired(entry, req_id)
            return True
        if cmd is P.Cmd.PING:
            return False
        self._b_channel_failure(ch, P.QueryProtocolError(
            f"unexpected {cmd} in balance mode"))
        return False

    def _b_stall_timeout(self, ch: _BChannel) -> float:
        hedge_ms = float(self.get_property("hedge_ms") or 0.0)
        if hedge_ms > 0.0:
            return self._r_stat(*ch.endpoint).hedge_timeout(
                hedge_ms / 1e3)
        return float(self.get_property("timeout"))

    def _b_check_channels(self) -> None:
        """Recovery pass: stalled live channels are killed (their next
        pass reconnects), dead channels reconnect sticky and resend, and
        a channel past ``max_retry`` failures hedges its survivors to
        sibling replicas."""
        limit = max(1, int(self.get_property("max_retry")))
        m = _res.metrics()
        for ch in list(self._b_channels.values()):
            if not ch.pending:
                continue
            now = time.monotonic()
            if ch.sock is not None:
                oldest = min((e.sent_t for e in ch.pending if e.sent_t),
                             default=0.0)
                stall_t = self._b_stall_timeout(ch)
                if oldest and now - oldest > stall_t:
                    self._b_channel_failure(ch, TimeoutError(
                        f"no result within {stall_t:.3f}s"))
                continue
            if ch.failures > limit:
                entries, ch.pending = ch.pending, []
                ch.failures = 0  # fresh slate if the endpoint returns
                for e in entries:
                    m["hedges"].inc()
                    _bal.lb_metrics()["reroutes"].inc()
                    try:
                        self._b_route(e, exclude=(ch.endpoint,))
                    except P.QueryProtocolError:
                        # honest last resort: account the frame dropped
                        self._b_pending.pop(e.req_id, None)
                        self._b_done_ids.add(e.req_id)
                        self._props["frames_dropped"] = \
                            int(self._props.get("frames_dropped", 0)) + 1
                continue
            if now < ch.next_attempt_t:
                continue
            try:
                self._b_ensure_channel(ch)  # sticky: reconnect and resend
            except (OSError, P.QueryProtocolError) as e:
                self._b_channel_failure(ch, e)

    def _b_flush_ready(self) -> List[tuple]:
        """The in-order deliverable prefix: results release downstream
        strictly in send order, so balance mode keeps the
        single-connection ordering contract across N channels."""
        out: List[tuple] = []
        while self._b_deliver_next is not None:
            rid = self._b_deliver_next
            got = self._b_results.pop(rid, None)  # atomic claim
            if got is not None:
                out.append(got)
            elif rid in self._b_done_ids or (
                    rid < self._r_next_id
                    and rid not in self._b_pending):
                # expired/dropped (or gone without a trace) — skip it
                # rather than wedge the stream; discard is a no-op for
                # ids that were never in the done set
                self._b_done_ids.discard(rid)
            else:
                break
            self._b_deliver_next = rid + 1
        return out

    def _b_drain_locked(self, min_pending: int):
        """Receive across every live channel until fewer than
        ``min_pending`` frames remain in flight (caller holds the lock).
        Returns ``(done, err)`` with ``done`` the in-order deliverable
        prefix; ``err`` reports exhaustion after the whole fleet made no
        progress for ``timeout * (max_retry + 1)``, with the remaining
        frames dropped and counted (the honest last resort)."""
        err: Optional[Exception] = None
        timeout = float(self.get_property("timeout"))
        limit = max(1, int(self.get_property("max_retry")))
        deadline = time.monotonic() + timeout * (limit + 1)
        while len(self._b_pending) >= min_pending:
            socks = {ch.sock: ch for ch in self._b_channels.values()
                     if ch.sock is not None and ch.pending}
            progress = False
            if socks:
                try:
                    readable, _, _ = select.select(
                        list(socks), [], [], 0.02)
                except (OSError, ValueError):
                    readable = []  # a racing close invalidated an fd
                for s in readable:
                    ch = socks[s]
                    try:
                        cmd, payload = self._b_recv(ch, timeout)
                    except (socket.timeout, OSError,
                            P.QueryProtocolError) as e:
                        self._b_channel_failure(ch, e)
                        continue
                    if self._b_handle_msg(ch, cmd, payload):
                        progress = True
            self._b_check_channels()
            if progress:
                deadline = time.monotonic() + timeout * (limit + 1)
            else:
                if time.monotonic() > deadline:
                    err = TimeoutError(
                        f"{self.name}: fleet made no progress within "
                        f"{timeout * (limit + 1):.1f}s "
                        f"({len(self._b_pending)} frame(s) in flight)")
                    for rid in list(self._b_pending):
                        self._b_pop(rid)
                        self._b_done_ids.add(rid)
                        self._props["frames_dropped"] = \
                            int(self._props.get("frames_dropped", 0)) + 1
                    break
                if not socks:
                    time.sleep(0.01)  # whole fleet down: wait on backoff
        return self._b_flush_ready(), err

    def _chain_balanced(self, buf):
        if self._refwire():
            raise FlowError(
                "tensor_query_client: balance requires wire=nnstpu")
        window = max(1, int(self.get_property("max_in_flight")))
        with self._lock:
            entry = self._r_make_entry(buf)
            if self._b_deliver_next is None:
                self._b_deliver_next = entry.req_id
            self._b_route(entry)
            done, err = self._b_drain_locked(min_pending=window)
        return self._push_done(done, err)

    def chain(self, pad, buf):
        if self.get_property("reliable"):
            if self._balance_on():
                return self._chain_balanced(buf)
            return self._chain_resilient(buf)
        if self._balance_on():
            raise FlowError(
                "tensor_query_client: balance=shortest-slack requires "
                "reliable=true (request ids + the server dedup window "
                "are what make re-routed frames exactly-once)")
        window = max(1, int(self.get_property("max_in_flight")))
        if window == 1:
            # synchronous round trip with per-frame resend on reconnect
            with self._lock:
                for attempt in (1, 2):  # one transparent reconnect per frame
                    if self._sock is None:
                        self._connect()
                    try:
                        self._send_buf(buf)
                        result = self._recv_result()
                        break
                    except (OSError, P.QueryProtocolError) as e:
                        self.log.warning("query round-trip failed: %s", e)
                        self._disconnect_locked()
                        if attempt == 2:
                            raise
            return self._push_result(result, buf.pts, buf.meta)

        # pipelined: keep up to `window` requests in flight; responses
        # arrive in order on the same connection. A frame that cannot be
        # SENT (server unreachable) errors like the sync path; frames
        # already in flight when the connection dies are dropped (streaming
        # frame-drop semantics).
        with self._lock:
            for attempt in (1, 2):  # one transparent reconnect per frame
                if self._sock is None:
                    self._connect()
                try:
                    self._send_buf(buf)
                    self._pending.append((buf.pts, buf.meta))
                    break
                except (OSError, P.QueryProtocolError) as e:
                    n = self._drop_pending_locked()
                    self.log.warning("pipelined send failed: %s; dropped %d "
                                     "in-flight frame(s)", e, n)
                    self._disconnect_locked()
                    if attempt == 2:
                        raise
            done, err = self._drain_locked(min_pending=window)
        ret = FlowReturn.OK
        for result, pts, meta in done:
            ret = self._push_result(result, pts, meta)
        if err is not None:
            raise err  # after pushing the good results collected so far
        return ret

    def _drain_locked(self, min_pending: int):
        """Receive results until fewer than ``min_pending`` remain in
        flight (caller holds the lock). Returns ``(done, err)`` — results
        successfully received before any failure are always returned so
        the caller can push them. ``err`` is a TimeoutError when a healthy
        connection stopped answering (must surface as a pipeline error,
        not as silently vanishing frames); a broken connection just drops
        the in-flight frames (streaming semantics)."""
        done = []
        err = None
        try:
            while len(self._pending) >= min_pending and \
                    self._sock is not None:
                result = self._recv_result()
                pts, meta = self._pending.pop(0)
                done.append((result, pts, meta))
        except TimeoutError as e:
            self._drop_pending_locked()
            self._disconnect_locked()
            err = e
        except (OSError, P.QueryProtocolError) as e:
            n = self._drop_pending_locked()
            self.log.warning("pipelined receive failed (%s); dropped %d "
                             "in-flight frame(s)", e, n)
            self._disconnect_locked()
        return done, err

    def handle_eos(self):
        """Receive every outstanding pipelined result before EOS forwards.

        A drain timeout is POSTED to the bus rather than raised: the EOS
        sentinel travels paths (e.g. queue worker threads) that do not
        wrap handlers in try/except, so a raise here could kill a worker
        silently instead of failing the pipeline."""
        if self.get_property("reliable"):
            with self._lock:
                if self._balance_on():
                    done, err = self._b_drain_locked(min_pending=1)
                else:
                    done, err = self._r_drain_locked(min_pending=1)
            for result, entry in done:
                self._push_result(result, entry.pts, entry.meta)
            if err is not None:
                self.post_error(FlowError(f"{self.name}: {err}"))
            return
        with self._lock:
            done, err = self._drain_locked(min_pending=1)
        for result, pts, meta in done:
            self._push_result(result, pts, meta)
        if err is not None:
            self.post_error(FlowError(f"{self.name}: {err}"))


@subplugin(ELEMENT, "tensor_query_serversrc")
class TensorQueryServerSrc(SourceElement):
    """Server-side source: accepts client connections and yields received
    buffers (client id attached as meta for serversink routing)."""

    ELEMENT_NAME = "tensor_query_serversrc"
    PROPERTIES = {
        **SourceElement.PROPERTIES,
        "host": "0.0.0.0",
        "port": 3000,
        "id": 0,  # pairs serversrc/serversink (reference `id` property)
        "num_buffers": -1,
        # "nnstreamer" speaks the reference's raw-struct query wire on
        # TWO ports (src=port, sink=sink-port) so unmodified reference
        # clients can offload to this server (query/refwire.py)
        "wire": "nnstpu",
        "sink_port": 0,
        # refwire carries no per-tensor meta: a caps string here (e.g.
        # "other/tensors,num_tensors=1,dimensions=3:4,types=float32")
        # reconstructs typed tensors from the raw mems and is announced
        # to clients in the APPROVE reply
        "caps": None,
        # broker discovery (reference query-hybrid): publish this server's
        # endpoint under its operation name
        "operation": None,
        "broker_host": "127.0.0.1",
        "broker_port": 1883,
        "advertise_host": "127.0.0.1",
        # accept the resilient extension (HELLO/TRANSFER_EX): per-client
        # dedup windows, deadline admission, EXPIRED notices; leave false
        # for the classic wire (nnstpu wire only)
        "reliable": False,
        # where this replica's MetricsServer /metrics.json lives —
        # advertised through the broker so fleet federation
        # (obs/distributed.py) can discover its scrape targets
        "metrics_port": 0,
        # > 0: re-publish the discovery ad on this cadence, each refresh
        # carrying a live load block (ingress depth + SLO-scheduler slack)
        # for shortest-slack clients; 0 keeps the publish-once ad
        "advertise_interval_s": 0.0,
    }

    _SERVERS: Dict[int, QueryServer] = {}
    _SERVERS_LOCK = threading.Lock()

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.server: Optional[QueryServer] = None
        self.i = 0
        self._advertiser = None

    def start(self):
        super().start()
        self.server = QueryServer(
            host=self.get_property("host"),
            port=int(self.get_property("port")),
            caps_str=str(self.get_property("caps") or ""),
            wire=str(self.get_property("wire")),
            sink_port=int(self.get_property("sink_port") or 0),
            resilient=bool(self.get_property("reliable")),
        ).start()
        with self._SERVERS_LOCK:
            self._SERVERS[int(self.get_property("id"))] = self.server
        operation = self.get_property("operation")
        if operation:
            from nnstreamer_tpu_torch.query.discovery import ServerAdvertiser

            refresh_s = float(
                self.get_property("advertise_interval_s") or 0.0)
            self._advertiser = ServerAdvertiser(
                self.get_property("broker_host"),
                int(self.get_property("broker_port")),
                str(operation),
                self.get_property("advertise_host"),
                self.server.port,
                metrics_port=int(self.get_property("metrics_port") or 0),
                load_fn=self._ad_load if refresh_s > 0 else None,
                refresh_s=refresh_s,
            )
            self._advertiser.publish()

    def _ad_load(self) -> Optional[dict]:
        """Live load block for the refreshed discovery ad: ingress queue
        depth, plus the SLO scheduler's service estimate and the slack a
        newly admitted frame would have left (budget minus the expected
        wait behind the queued work). Scheduler-less replicas advertise
        depth alone — the balancer treats missing fields as unknown."""
        server = self.server
        if server is None:
            return None
        depth = int(server.incoming.qsize())
        load: dict = {"queue_depth": depth}
        sched = getattr(self.pipeline, "_slo_scheduler", None) \
            if self.pipeline is not None else None
        if sched is not None:
            snap = sched.snapshot()
            svc = float(snap.get("service_time_ms") or 0.0)
            budget = float(snap.get("budget_ms") or 0.0)
            if svc > 0.0:
                load["service_ms"] = svc
                if budget > 0.0:
                    load["slack_headroom_ms"] = \
                        budget - (depth + 1) * svc
        return load

    def stop(self):
        if self._advertiser is not None:
            try:
                self._advertiser.retract()
            except OSError:
                pass
            self._advertiser = None
        if self.server is not None:
            self.server.stop()
            with self._SERVERS_LOCK:
                self._SERVERS.pop(int(self.get_property("id")), None)
            self.server = None
        super().stop()

    @classmethod
    def get_server(cls, pair_id: int) -> Optional[QueryServer]:
        with cls._SERVERS_LOCK:
            return cls._SERVERS.get(pair_id)

    @property
    def port(self) -> int:
        """Bound port (use port=0 to pick a free one in tests)."""
        return self.server.port if self.server else \
            int(self.get_property("port"))

    @property
    def result_port(self) -> int:
        """Refwire sink (result) port once bound."""
        return self.server.sink_port if self.server else \
            int(self.get_property("sink_port"))

    def negotiate(self):
        caps_prop = self.get_property("caps")
        if caps_prop:
            from nnstreamer_tpu_torch.pipeline.parse import parse_caps_string

            self.srcpad.set_caps(parse_caps_string(str(caps_prop)))
            return
        self.srcpad.set_caps(
            TensorsConfig(format=TensorFormat.FLEXIBLE).to_caps()
        )

    def create(self):
        n = int(self.get_property("num_buffers"))
        if 0 <= n <= self.i:
            return None
        while not self._stop_evt.is_set():
            server = self.server  # stop() nulls the attribute concurrently
            if server is None:
                return None
            buf = server.get_buffer(timeout=0.1)
            if buf is not None:
                self.i += 1
                return buf
        return None


@subplugin(ELEMENT, "tensor_query_serversink")
class TensorQueryServerSink(Element):
    """Server-side sink: returns each result to the client that sent the
    corresponding input (routing by query_client_id meta — the reference's
    GstMetaQuery client-id routing)."""

    ELEMENT_NAME = "tensor_query_serversink"
    PROPERTIES = {**Element.PROPERTIES, "id": 0}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")

    def sink_event(self, pad, event):
        if isinstance(event, CapsEvent):
            # the reference wire announces the pipeline's output caps
            server = TensorQueryServerSrc.get_server(
                int(self.get_property("id")))
            if server is not None:
                server.set_sink_caps(event.caps)
        super().sink_event(pad, event)

    def chain(self, pad, buf):
        server = TensorQueryServerSrc.get_server(int(self.get_property("id")))
        if server is None:
            raise RuntimeError(
                "tensor_query_serversink: no paired serversrc (check `id`)"
            )
        client_id = buf.meta.get("query_client_id")
        if client_id is None:
            raise RuntimeError(
                "tensor_query_serversink: buffer lost its query_client_id "
                "meta (keep meta intact through the server pipeline)"
            )
        server.send_result(int(client_id), buf)
        return FlowReturn.OK
