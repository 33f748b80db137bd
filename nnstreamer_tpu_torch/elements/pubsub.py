"""tensor_pubsub_sink / tensor_pubsub_src — buffers over pub/sub topics.

Reference: ``gst/mqtt/mqttsink.c`` / ``mqttsrc.c``: publish any stream's
buffers to a broker topic / subscribe and push them into a pipeline, with
cross-device timestamp rebasing (mqttcommon.h header + ntputil). Element
names ``mqttsink``/``mqttsrc`` are registered as aliases so reference
pipeline descriptions parse unchanged.

Two transports, selected by the ``broker`` property:

- ``shim`` (default) — the in-process framed-TCP broker
  (``query/pubsub.py``); payloads are the compact native envelope.
- ``mqtt://[host[:port]]`` — real MQTT 3.1.1 (``query/mqtt.py``);
  payloads carry the reference's 1024-byte ``GstMQTTMessageHdr``
  (caps string, num_mems/size_mems, base/sent epochs, pts/dts/duration,
  mqttcommon.h:49-63) + raw tensor memories, so streams interop with
  reference mqttsink/mqttsrc peers over any conformant broker.

Timestamp rebasing follows the reference's base-epoch math
(mqttsrc.c:1381-1404): each side stamps ``base_time_epoch`` = wall epoch
at stream start, and the receiver shifts pts by the *difference of base
epochs* — message latency never enters the offset. With ``ntp-server``
set, both sides' epochs are SNTP-corrected (``query/ntp.py``,
reference ntputil.c), so the rebasing holds across hosts whose clocks
disagree.

Port of ``nnstreamer_tpu/elements/pubsub.py``. The sink fetches a device
buffer to the host once (one counted D2H, ``TensorBuffer.to_host``), as
the JAX sink's ``to_host()`` does; the src pushes host buffers, which the
next element uploads. A ``bfloat16`` memory comes back as a CPU torch
tensor. The src surfaces the header's send stamp as distributed-trace meta
(``obs/distributed.py``), as the JAX src does.
"""

from __future__ import annotations

import queue as _queue
import struct as _struct
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from nnstreamer_tpu_torch.pipeline.element import Element, FlowReturn
from nnstreamer_tpu_torch.pipeline.pipeline import SourceElement
from nnstreamer_tpu_torch.query import protocol as P
from nnstreamer_tpu_torch.query.pubsub import (
    Client,
    make_buffer_envelope,
    parse_broker_spec as _parse_broker,
    parse_buffer_envelope,
)
from nnstreamer_tpu_torch.query.refwire import buffer_to_mems
from nnstreamer_tpu_torch.registry import ELEMENT, register_subplugin, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensors.types import (
    TensorFormat,
    TensorsConfig,
    TensorType,
)


def _ntp_servers(spec: Optional[str]):
    if not spec:
        return None
    out = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        h, _, p = part.partition(":")
        out.append((h, int(p) if p else 123))
    return out or None


def _epoch(ntp_servers) -> int:
    if ntp_servers is not None:
        from nnstreamer_tpu_torch.query.ntp import corrected_epoch_ns

        return corrected_epoch_ns(ntp_servers)
    return time.time_ns()


def _caps_to_string(caps) -> str:
    if caps is None:
        return ""
    parts = [caps.name]
    parts += [f"{k}={v}" for k, v in caps.fields.items()]
    return ",".join(parts)


def _typed_memory(mem: bytes, info):
    """One header memory as a tensor of its caps' type and shape: numpy,
    or a CPU torch tensor for ``bfloat16``."""
    if info.type is TensorType.BFLOAT16:
        return torch.frombuffer(bytearray(mem),
                                dtype=torch.bfloat16).reshape(info.shape)
    return np.frombuffer(mem, info.type.np_dtype).reshape(info.shape)


class _PubSubBase:
    """Shared transport plumbing for both elements."""

    def _connect(self):
        kind, host, port = _parse_broker(
            self.get_property("broker"),
            self.get_property("host"), int(self.get_property("port")))
        self._transport = kind
        # parsed once per start — the hot path must not re-split property
        # strings per buffer
        self._ntp_list = _ntp_servers(self.get_property("ntp_server"))
        if kind == "mqtt":
            from nnstreamer_tpu_torch.query.mqtt import MqttClient

            return MqttClient(host, port)
        return Client(host, port)

    def _epoch_now(self) -> int:
        return _epoch(self._ntp_list)


@subplugin(ELEMENT, "tensor_pubsub_sink")
class TensorPubSubSink(Element, _PubSubBase):
    ELEMENT_NAME = "tensor_pubsub_sink"
    PROPERTIES = {
        **Element.PROPERTIES,
        "host": "127.0.0.1",
        "port": 1883,
        "pub_topic": "nns/stream",
        "retain": False,
        "broker": "shim",
        "ntp_server": None,   # "host[:port][,host2...]" → SNTP-corrected
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self._client = None
        self._base_epoch: Optional[int] = None

    def start(self):
        super().start()
        self._client = self._connect()
        # stream base epoch: wall clock at start (NTP-corrected when
        # configured) — the mqttsink base_time_epoch role
        self._base_epoch = self._epoch_now()

    def stop(self):
        if self._client:
            self._client.close()
            self._client = None
        super().stop()

    def _caps_str(self, pad, tensors) -> str:
        """Header caps string, cached per negotiated caps object (built
        once, not per buffer)."""
        caps = pad.caps
        if caps is None:
            caps = TensorsConfig.from_arrays(tensors).to_caps()
            return _caps_to_string(caps)
        cached = getattr(self, "_caps_str_cache", None)
        if cached is None or cached[0] is not caps:
            cached = (caps, _caps_to_string(caps))
            self._caps_str_cache = cached
        return cached[1]

    def chain(self, pad, buf):
        if self._transport == "mqtt":
            from nnstreamer_tpu_torch.query.mqtt import pack_gst_mqtt_message

            host = buf.to_host()
            payload = pack_gst_mqtt_message(
                buffer_to_mems(host),
                self._caps_str(pad, host.tensors),
                base_time_epoch=self._base_epoch,
                sent_time_epoch=self._epoch_now(),
                pts=buf.pts, dts=buf.dts, duration=buf.duration)
        else:
            payload = make_buffer_envelope(
                P.pack_buffer(buf), buf.pts,
                base_epoch=self._base_epoch,
                sent_epoch=self._epoch_now())
        self._client.publish(self.get_property("pub_topic"), payload,
                             retain=bool(self.get_property("retain")))
        return FlowReturn.OK


@subplugin(ELEMENT, "tensor_pubsub_src")
class TensorPubSubSrc(SourceElement, _PubSubBase):
    ELEMENT_NAME = "tensor_pubsub_src"
    PROPERTIES = {
        **SourceElement.PROPERTIES,
        "host": "127.0.0.1",
        "port": 1883,
        "sub_topic": "nns/stream",
        "num_buffers": -1,
        "rebase_timestamps": True,
        "broker": "shim",
        "ntp_server": None,
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._client = None
        self._q: _queue.Queue = _queue.Queue(maxsize=256)
        self.i = 0
        self._base_epoch: Optional[int] = None

    def start(self):
        super().start()
        self._client = self._connect()
        self._base_epoch = self._epoch_now()
        self._client.subscribe(self.get_property("sub_topic"), self._on_msg)

    def stop(self):
        if self._client:
            self._client.close()
            self._client = None
        super().stop()

    def _on_msg(self, topic: str, body: bytes):
        try:
            self._q.put_nowait(body)
        except _queue.Full:
            pass  # drop under backpressure (mqttsrc leaky behavior)

    def negotiate(self):
        self.srcpad.set_caps(
            TensorsConfig(format=TensorFormat.FLEXIBLE).to_caps()
        )

    def _decode(self, body: bytes) -> Tuple[TensorBuffer, int,
                                            Optional[int]]:
        """wire payload → (buffer, sender base epoch, pts)."""
        if self._transport == "mqtt":
            from nnstreamer_tpu_torch.pipeline.parse import parse_caps_string
            from nnstreamer_tpu_torch.query.mqtt import parse_gst_mqtt_message

            msg = parse_gst_mqtt_message(body)
            tensors: List = []
            try:
                config = TensorsConfig.from_caps(
                    parse_caps_string(msg["caps_str"]))
                infos = list(config.info)
            except (ValueError, KeyError, IndexError):
                infos = []
            for i, mem in enumerate(msg["mems"]):
                if i < len(infos) and infos[i].size == len(mem):
                    tensors.append(_typed_memory(mem, infos[i]))
                else:  # unknown caps: deliver raw bytes, lossless
                    tensors.append(np.frombuffer(mem, np.uint8))
            buf = TensorBuffer(tensors, dts=msg["dts"],
                               duration=msg["duration"],
                               meta={"caps_str": msg["caps_str"]})
            self._stamp_trace(buf, msg["sent_time_epoch"])
            return buf, msg["base_time_epoch"], msg["pts"]
        base_epoch, sent, pts, payload = parse_buffer_envelope(body)
        buf = P.unpack_buffer(payload)
        self._stamp_trace(buf, sent)
        return buf, base_epoch, pts

    @staticmethod
    def _stamp_trace(buf: TensorBuffer, sent_epoch_ns) -> None:
        """Both wire headers already carry a sender send-stamp (the
        reference's ``sent_time`` field / the NPE2 envelope): surface it
        as distributed-trace meta so the receiving pipeline's ledger can
        attribute the hop — no wire change, works against reference
        mqttsink peers."""
        from nnstreamer_tpu_torch.obs import distributed as _dist

        if _dist.enabled() and sent_epoch_ns:
            buf.meta[_dist.SENT_WALL_META] = float(sent_epoch_ns) / 1e9

    def create(self):
        n = int(self.get_property("num_buffers"))
        if 0 <= n <= self.i:
            return None
        while not self._stop_evt.is_set():
            if self._client is not None and self._client.failed.is_set():
                raise RuntimeError(
                    f"{self.name}: lost broker connection "
                    f"({self.get_property('host')}:"
                    f"{self.get_property('port')})"
                )
            try:
                body = self._q.get(timeout=0.1)
            except _queue.Empty:
                continue
            try:
                buf, sender_base, pts = self._decode(body)
            except (ValueError, KeyError, _struct.error) as e:
                # foreign/malformed message on a shared topic: log and keep
                # streaming (the reference mqttsrc does not die either)
                self.log.warning("dropping undecodable message (%s)", e)
                continue
            if self.get_property("rebase_timestamps") and pts is not None:
                # reference _put_timestamp_on_gst_buf: shift pts AND dts by
                # the difference of base epochs — no message latency involved
                diff = sender_base - self._base_epoch
                buf = buf.replace(
                    pts=pts + diff,
                    dts=None if buf.dts is None else buf.dts + diff)
            else:
                buf = buf.replace(pts=pts)
            self.i += 1
            return buf
        return None


# reference-name aliases so existing pipeline strings parse unchanged
register_subplugin(ELEMENT, "mqttsink", TensorPubSubSink)
register_subplugin(ELEMENT, "mqttsrc", TensorPubSubSrc)
