"""tensor_src_grpc / tensor_sink_grpc — gRPC stream endpoints as elements.

Reference: ``ext/nnstreamer/tensor_source/tensor_src_grpc.c`` (515 LoC) and
``ext/nnstreamer/tensor_sink/tensor_sink_grpc.c`` (396 LoC): each element
runs either as a gRPC *server* or *client* (``server`` property), src
yields buffers received over TensorService, sink ships buffers out;
``idl`` selects the payload encoding: protobuf | flexbuf | flatbuf
(reference-layout, interoperable with a reference nnstreamer peer;
rank-4 normalizing, no pts) or nnstpu-flex (framework-native framing —
carries pts, allows rank>4/fp16, our peers only).

Roles (mirroring the reference's mode matrix):
- src  + server=true : hosts the service; remote clients stream tensors IN
  via SendTensors and the element pushes them downstream.
- src  + server=false: connects out and consumes the remote's RecvTensors
  stream.
- sink + server=true : hosts the service; remote clients pull this
  pipeline's output via RecvTensors.
- sink + server=false: connects out and ships buffers via SendTensors.

The port of the JAX package's elements: a copy with its imports rewritten.
Both register with or without grpcio; ``start()`` imports it.
"""

from __future__ import annotations

import queue as _queue
from typing import Optional

from nnstreamer_tpu_torch.pipeline.element import Element, FlowReturn
from nnstreamer_tpu_torch.pipeline.pipeline import SourceElement
from nnstreamer_tpu_torch.registry import ELEMENT, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer


@subplugin(ELEMENT, "tensor_src_grpc")
class TensorSrcGrpc(SourceElement):
    ELEMENT_NAME = "tensor_src_grpc"
    PROPERTIES = {
        **SourceElement.PROPERTIES,
        "host": "127.0.0.1",
        "port": 0,
        "server": True,
        "idl": "protobuf",
        "num_buffers": -1,
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._q: _queue.Queue = _queue.Queue(maxsize=64)
        self._server = None
        self._client = None
        self._recv_iter = None
        self._count = 0

    @property
    def port(self) -> int:
        """Bound port (server mode; useful with port=0 auto-pick)."""
        return self._server.port if self._server else \
            int(self.get_property("port"))

    def start(self):
        super().start()
        from nnstreamer_tpu_torch.query.grpc_bridge import (
            TensorServiceClient,
            TensorServiceServer,
        )

        if self.get_property("server"):
            self._server = TensorServiceServer(
                self.get_property("host"), int(self.get_property("port")),
                idl=self.get_property("idl"), on_recv=self._q.put,
            ).start()
        else:
            self._client = TensorServiceClient(
                self.get_property("host"), int(self.get_property("port")),
                idl=self.get_property("idl"),
            ).wait_ready()
            self._recv_iter = iter(self._client.recv_stream())

    def create(self) -> Optional[TensorBuffer]:
        n = int(self.get_property("num_buffers"))
        if 0 <= n <= self._count:
            return None
        if self._recv_iter is not None:
            try:
                buf = next(self._recv_iter)
            except StopIteration:
                return None
            except Exception:  # noqa: BLE001 — channel torn down at stop
                return None
            self._count += 1
            return buf
        while not self._stop_evt.is_set():
            try:
                buf = self._q.get(timeout=0.1)
                self._count += 1
                return buf
            except _queue.Empty:
                continue
        return None

    def stop(self):
        if self._server is not None:
            self._server.stop()
            self._server = None
        if self._client is not None:
            self._client.close()
            self._client = None
        super().stop()


@subplugin(ELEMENT, "tensor_sink_grpc")
class TensorSinkGrpc(Element):
    ELEMENT_NAME = "tensor_sink_grpc"
    PROPERTIES = {
        **Element.PROPERTIES,
        "host": "127.0.0.1",
        "port": 0,
        "server": False,
        "idl": "protobuf",
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self._server = None
        self._client = None
        self._sendq: Optional[_queue.Queue] = None
        self._sender = None

    @property
    def port(self) -> int:
        return self._server.port if self._server else \
            int(self.get_property("port"))

    def start(self):
        super().start()
        from nnstreamer_tpu_torch.query.grpc_bridge import (
            TensorServiceClient,
            TensorServiceServer,
        )

        if self.get_property("server"):
            self._server = TensorServiceServer(
                self.get_property("host"), int(self.get_property("port")),
                idl=self.get_property("idl"),
            ).start()
        else:
            import threading

            self._client = TensorServiceClient(
                self.get_property("host"), int(self.get_property("port")),
                idl=self.get_property("idl"),
            ).wait_ready()
            self._sendq = _queue.Queue(maxsize=64)

            def gen():
                while True:
                    item = self._sendq.get()
                    if item is None:
                        return
                    yield item

            # one long-lived SendTensors stream fed by chain()
            self._sender = threading.Thread(
                target=lambda: self._client.send_stream(gen()),
                name=f"{self.name}-send", daemon=True)
            self._sender.start()

    def chain(self, pad, buf):
        buf = buf.to_host()
        if self._server is not None:
            self._server.send(buf)
        elif self._sendq is not None:
            self._sendq.put(buf)
        return FlowReturn.OK

    def stop(self):
        if self._sendq is not None:
            self._sendq.put(None)
            if self._sender is not None:
                self._sender.join(timeout=5)
            self._sendq = self._sender = None
        if self._client is not None:
            self._client.close()
            self._client = None
        if self._server is not None:
            self._server.stop()
            self._server = None
        super().stop()
