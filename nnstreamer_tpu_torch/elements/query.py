"""tensor_query_client / tensor_query_serversrc / tensor_query_serversink —
distributed pipeline offload elements.

Reference: ``gst/nnstreamer/tensor_query/`` — the client sends each input
buffer to a remote server pipeline and pushes the returned result
downstream (tensor_query_client.c:609); the server pipeline is bracketed by
serversrc (receives client buffers) and serversink (routes each result back
to its client by client-id meta). Client failover walks a server list
(``_client_retry_connection``:465).

The port of the JAX package's classic path and of its reference wire
(``wire=nnstreamer``: the reference's raw-struct query protocol on two
ports, ``query/refwire.py``), each wire-compatible with the JAX package in
both directions. Properties of the JAX elements whose features are not
ported yet raise ``NotImplementedError`` naming their ROADMAP.md item when
set away from their defaults: the resilient transport (26a), fleet
balancing (26b) and broker discovery (26c). ``reliable`` and ``balance``
need the classic wire in the JAX package too.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.pipeline.element import (
    CapsEvent,
    Element,
    FlowError,
    FlowReturn,
    not_ported,
)
from nnstreamer_tpu_torch.pipeline.pipeline import SourceElement
from nnstreamer_tpu_torch.query import protocol as P
from nnstreamer_tpu_torch.query import refwire as R
from nnstreamer_tpu_torch.query.server import QueryServer
from nnstreamer_tpu_torch.registry import ELEMENT, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensors.types import TensorFormat, TensorsConfig

_RESILIENT = P.RESILIENT_ITEM
_FLEET = "26b fleet balancing"
_DISCOVERY = "26c broker discovery"


class _DefaultOnly:
    """Properties kept at their JAX defaults: setting one to any other value
    raises ``NotImplementedError`` naming the item that brings it."""

    #: property → (default, ROADMAP item)
    DEFAULT_ONLY: Dict[str, Tuple[object, str]] = {}

    def property_changed(self, key: str) -> None:
        rule = self.DEFAULT_ONLY.get(key)
        if rule is not None and self._props[key] != rule[0]:
            raise not_ported(
                f"{self.ELEMENT_NAME} property "
                f"{key.replace('_', '-')}={self._props[key]!r}", rule[1])


@subplugin(ELEMENT, "tensor_query_client")
class TensorQueryClient(_DefaultOnly, Element):
    ELEMENT_NAME = "tensor_query_client"
    DEFAULT_ONLY = {
        "operation": (None, _DISCOVERY),
        "broker_host": ("127.0.0.1", _DISCOVERY),
        "broker_port": (1883, _DISCOVERY),
        "reliable": (False, _RESILIENT),
        "propagate_deadline": (False, _RESILIENT),
        "breaker_failures": (5, _RESILIENT),
        "breaker_reset_ms": (1000.0, _RESILIENT),
        "hedge_ms": (0.0, _RESILIENT),
        "reconnect_backoff_ms": (50.0, _RESILIENT),
        "balance": ("off", _FLEET),
        "discovery_stale_s": (0.0, _FLEET),
    }
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
        **{k: v for k, (v, _) in DEFAULT_ONLY.items()},
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

    def set_property(self, key: str, value) -> None:
        if key.replace("-", "_") == "frames_dropped":
            raise ValueError(f"tensor_query_client: {key} is read-only")
        super().set_property(key, value)

    def _obs_sent(self):
        """``nns_query_client_sent_bytes_total``: every byte this client
        wrote to its connection (frame headers included)."""
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
        n = len(self._pending)
        if n:
            self._pending.clear()
            self._props["frames_dropped"] = \
                int(self._props.get("frames_dropped", 0)) + n
        return n

    def _server_list(self) -> List[Tuple[str, int]]:
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
            P.recv_msg(sock)  # CLIENT_ID: results route by connection
        except BaseException:
            sock.close()
            raise
        self._sock = sock

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
            # in-flight requests die with the connection — a restart must
            # not pair old (pts, meta) with new results
            self._drop_pending_locked()
        super().stop()

    def transform_caps(self, pad, caps):
        return None  # output caps come from the first result buffer

    def _send_buf(self, buf):
        if self._refclient is not None:
            sent = self._refclient.send(R.buffer_to_mems(buf.to_host()),
                                        pts=buf.pts)
        else:
            sent = P.send_buffer(self._sock, buf)
        self._obs_sent().inc(sent)

    def _recv_result(self):
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

    def chain(self, pad, buf):
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
        with self._lock:
            done, err = self._drain_locked(min_pending=1)
        for result, pts, meta in done:
            self._push_result(result, pts, meta)
        if err is not None:
            self.post_error(FlowError(f"{self.name}: {err}"))


@subplugin(ELEMENT, "tensor_query_serversrc")
class TensorQueryServerSrc(_DefaultOnly, SourceElement):
    """Server-side source: accepts client connections and yields received
    buffers (client id attached as meta for serversink routing)."""

    ELEMENT_NAME = "tensor_query_serversrc"
    DEFAULT_ONLY = {
        "operation": (None, _DISCOVERY),
        "broker_host": ("127.0.0.1", _DISCOVERY),
        "broker_port": (1883, _DISCOVERY),
        "advertise_host": ("127.0.0.1", _DISCOVERY),
        "reliable": (False, _RESILIENT),
        "metrics_port": (0, _FLEET),
        "advertise_interval_s": (0.0, _FLEET),
    }
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
        **{k: v for k, (v, _) in DEFAULT_ONLY.items()},
    }

    _SERVERS: Dict[int, QueryServer] = {}
    _SERVERS_LOCK = threading.Lock()

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.server: Optional[QueryServer] = None
        self.i = 0

    def start(self):
        super().start()
        self.server = QueryServer(
            host=self.get_property("host"),
            port=int(self.get_property("port")),
            caps_str=str(self.get_property("caps") or ""),
            wire=str(self.get_property("wire")),
            sink_port=int(self.get_property("sink_port") or 0),
        ).start()
        with self._SERVERS_LOCK:
            self._SERVERS[int(self.get_property("id"))] = self.server

    def stop(self):
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
