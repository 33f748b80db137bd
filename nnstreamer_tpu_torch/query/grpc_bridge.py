"""gRPC TensorService — the DCN-facing streaming bridge.

Reference: ``ext/nnstreamer/extra/nnstreamer_grpc_*`` (NNStreamerRPC class,
nnstreamer_grpc_common.h:32) exposing ``TensorService`` from
``ext/nnstreamer/include/nnstreamer.proto:43-49``:

    service TensorService {
      rpc SendTensors (stream Tensors) returns (Empty);   // client→server
      rpc RecvTensors (Empty) returns (stream Tensors);   // server→client
    }

Same service shape here, built on grpcio generic handlers with the
framework's own wire codecs as (de)serializers — the ``idl`` option
picks protobuf / flexbuf / flatbuf (all reference-layout, interoperable
with a reference nnstreamer peer, rank-4 normalizing, no pts on the
wire) or ``nnstpu-flex`` (framework-native framing: carries pts,
allows rank>4 and fp16/bf16, but only our peers parse it); no
generated stubs. Frames arrive over gRPC, flow through the pipeline, and
results stream back.

The port of the JAX package's bridge, with its imports rewritten to the
port's codecs (``decoders/``): the messages are the JAX package's byte for
byte, so a peer of either package serves the other. A device buffer is
fetched to the host once (``to_host()``) before it is queued or encoded.
``grpc`` is imported where the servers and clients are made, so the
package imports without grpcio.
"""

from __future__ import annotations

import queue as _queue
import threading
from concurrent import futures
from typing import Callable, Iterator, Optional

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.pipeline import faults as _faults
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

log = get_logger("grpc")

SERVICE = "nnstreamer.protobuf.TensorService"


def _codecs(idl: str):
    """(encode: TensorBuffer→bytes, decode: bytes→TensorBuffer) per IDL."""
    if idl == "protobuf":
        from nnstreamer_tpu_torch.decoders.protobuf_codec import (
            decode_protobuf,
            encode_protobuf,
        )

        return encode_protobuf, decode_protobuf
    if idl == "flexbuf":
        # reference FlexBuffers layout — interoperates with a reference
        # nnstreamer gRPC peer (tensor_decoder/tensordec-flexbuf.cc map)
        from nnstreamer_tpu_torch.decoders.flexbuf import (
            decode_flexbuf,
            encode_flexbuf,
        )

        return encode_flexbuf, decode_flexbuf
    if idl == "nnstpu-flex":
        # framework-native framing: carries pts, allows rank>4/fp16
        from nnstreamer_tpu_torch.decoders.flexbuf import decode_flex, encode_flex

        return encode_flex, decode_flex
    if idl == "flatbuf":
        from nnstreamer_tpu_torch.decoders.flatbuf_codec import (
            decode_flatbuf,
            encode_flatbuf,
        )

        return encode_flatbuf, decode_flatbuf
    raise ValueError(
        f"grpc: unknown idl {idl!r} (protobuf|flexbuf|flatbuf|nnstpu-flex)")


def _noop_serializer(_) -> bytes:  # Empty message
    return b""


def _noop_deserializer(raw: bytes) -> bytes:
    # grpcio interprets a None deserializer result as a failure, so the
    # Empty message round-trips as the empty byte string
    return raw or b""


class TensorServiceServer:
    """Hosts TensorService; hands received buffers to ``on_recv`` and
    streams buffers from an internal queue to RecvTensors callers."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 idl: str = "protobuf",
                 on_recv: Optional[Callable[[TensorBuffer], None]] = None):
        import grpc

        self._encode, self._decode = _codecs(idl)
        self.on_recv = on_recv
        # bounded with drop-oldest: a server with no (or a slow)
        # RecvTensors subscriber must not grow without bound at video rate
        self._sendq: _queue.Queue = _queue.Queue(maxsize=64)
        self._stop = threading.Event()
        from nnstreamer_tpu_torch.obs import get_registry

        reg = get_registry()
        self._m_recv = reg.counter(
            "nns_grpc_requests_total",
            "Buffers moved through TensorService",
            method="SendTensors", idl=idl)
        self._m_send = reg.counter(
            "nns_grpc_requests_total",
            "Buffers moved through TensorService",
            method="RecvTensors", idl=idl)
        self._m_errors = reg.counter(
            "nns_grpc_errors_total",
            "on_recv callback failures", idl=idl)
        self._m_send_drops = reg.counter(
            "nns_grpc_send_drops_total",
            "RecvTensors-queue buffers displaced by backpressure", idl=idl)

        def send_tensors(request_iterator, context):
            # client→server stream; requests arrive already decoded.
            # Cross-hop trace context rides the gRPC invocation metadata
            # (the codecs carry no meta dict) — stamp it onto every
            # buffer so the receiving pipeline's ledger sees the hop.
            trace_md = {k: v for k, v in (context.invocation_metadata()
                                          or ())
                        if k in ("nns-trace-id", "nns-sent-wall")}
            for buf in request_iterator:
                self._m_recv.inc()
                if trace_md:
                    from nnstreamer_tpu_torch.obs import distributed as _dist

                    try:
                        buf.meta[_dist.TRACE_ID_META] = \
                            int(trace_md.get("nns-trace-id", 0))
                        buf.meta[_dist.SENT_WALL_META] = \
                            float(trace_md.get("nns-sent-wall", 0.0))
                    except (TypeError, ValueError):
                        pass
                if self.on_recv is not None:
                    try:
                        self.on_recv(buf)
                    except Exception:  # noqa: BLE001 — one bad frame must
                        # not tear down the client's whole send stream
                        self._m_errors.inc()
                        log.exception("on_recv callback failed")
            return b""  # Empty

        def recv_tensors(request, context):
            # server→client stream from the send queue
            while not self._stop.is_set():
                try:
                    item = self._sendq.get(timeout=0.1)
                except _queue.Empty:
                    continue
                if item is None:
                    return
                yield item

        handler = grpc.method_handlers_generic_handler(SERVICE, {
            "SendTensors": grpc.stream_unary_rpc_method_handler(
                send_tensors,
                request_deserializer=self._decode,
                response_serializer=_noop_serializer,
            ),
            "RecvTensors": grpc.unary_stream_rpc_method_handler(
                recv_tensors,
                request_deserializer=_noop_deserializer,
                response_serializer=self._encode,
            ),
        })
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        self._server.add_generic_rpc_handlers((handler,))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        if self.port == 0:
            raise RuntimeError(f"grpc: cannot bind {host}:{port}")

    def start(self):
        self._server.start()
        log.info("TensorService listening on :%d", self.port)
        return self

    def send(self, buf: TensorBuffer) -> None:
        """Queue a buffer for RecvTensors streams (drops oldest on
        backpressure, like a leaky downstream queue)."""
        buf = buf.to_host()
        self._m_send.inc()
        while True:
            try:
                self._sendq.put_nowait(buf)
                return
            except _queue.Full:
                try:
                    self._sendq.get_nowait()
                    self._m_send_drops.inc()
                except _queue.Empty:
                    pass

    def stop(self, grace: float = 1.0):
        self._stop.set()
        self._sendq.put(None)
        self._server.stop(grace)


class TensorServiceClient:
    """Client side: stream buffers up (SendTensors) or down (RecvTensors)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 idl: str = "protobuf"):
        import grpc

        self._encode, self._decode = _codecs(idl)
        self.target = f"{host}:{port}"
        self._closed = False
        self._channel = grpc.insecure_channel(self.target)
        self._send_rpc = self._channel.stream_unary(
            f"/{SERVICE}/SendTensors",
            request_serializer=self._encode,
            response_deserializer=_noop_deserializer,
        )
        self._recv_rpc = self._channel.unary_stream(
            f"/{SERVICE}/RecvTensors",
            request_serializer=_noop_serializer,
            response_deserializer=self._decode,
        )

    def wait_ready(self, timeout: float = 10.0):
        import grpc

        grpc.channel_ready_future(self._channel).result(timeout=timeout)
        return self

    @staticmethod
    def _fault_hook() -> None:
        fi = _faults.ACTIVE
        if fi is not None and fi.action("grpc.call") is not None:
            # any transport verdict at this site surfaces as the same
            # error a dead channel would raise; the caller's retry path
            # (not this bridge) owns recovery
            raise ConnectionError("injected fault: grpc.call")

    def send_stream(self, buffers: Iterator[TensorBuffer],
                    timeout: Optional[float] = None) -> None:
        """Stream buffers to the server (blocks until the server acks).
        When distributed tracing is armed the stream carries trace
        context as invocation metadata (per stream — the codecs have no
        per-frame meta channel)."""
        self._fault_hook()
        metadata = None
        from nnstreamer_tpu_torch.obs import distributed as _dist

        if _dist.enabled():
            ctx = _dist.attach_trace_meta({})
            metadata = (
                ("nns-trace-id", str(ctx[_dist.TRACE_ID_META])),
                ("nns-sent-wall", repr(ctx[_dist.SENT_WALL_META])),
            )
        self._send_rpc((b.to_host() for b in buffers), timeout=timeout,
                       metadata=metadata)

    def recv_stream(self, timeout: Optional[float] = None
                    ) -> Iterator[TensorBuffer]:
        """Iterate buffers streamed by the server."""
        self._fault_hook()
        return self._recv_rpc(None, timeout=timeout)

    def close(self) -> None:
        """Idempotent channel shutdown — element ``stop()`` owns the
        call (a ``__del__`` here would race interpreter teardown and
        mask grpc's own cleanup ordering)."""
        if self._closed:
            return
        self._closed = True
        self._channel.close()

    def __enter__(self) -> "TensorServiceClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
