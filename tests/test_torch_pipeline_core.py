"""The caps, pad, element, queue and scheduler cases of
``tests/test_pipeline_core.py`` on the port (the reference's
unittest_common caps negotiation and gst core behaviour). A device
payload is a torch tensor where the JAX package's is a ``jax.Array``; the
rest is asserted as the JAX tests assert it.
"""

import time

import numpy as np
import pytest

from nnstreamer_tpu_torch.pipeline.caps import ANY, Caps, CapsList, IntRange
from nnstreamer_tpu_torch.pipeline.element import (
    CapsEvent,
    Element,
    EosEvent,
    FlowError,
    FlowReturn,
)
from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline, Queue, SourceElement
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer


@pytest.fixture
def cpu_device():
    import nnstreamer_tpu_torch as tnt

    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


class TestCaps:
    def test_intersect_fixed(self):
        a = Caps("other/tensors", {"num_tensors": 1, "types": "uint8"})
        b = Caps("other/tensors", {"num_tensors": 1})
        c = a.intersect(b)
        assert c is not None and c["types"] == "uint8"

    def test_intersect_mismatch(self):
        a = Caps("other/tensors", {"num_tensors": 1})
        b = Caps("other/tensors", {"num_tensors": 2})
        assert a.intersect(b) is None
        assert a.intersect(Caps("video/x-raw", {})) is None

    def test_range_and_list(self):
        a = Caps("video/x-raw", {"width": IntRange(16, 4096), "format": ["RGB", "GRAY8"]})
        b = Caps("video/x-raw", {"width": 224, "format": "RGB"})
        c = a.intersect(b)
        assert c["width"] == 224 and c["format"] == "RGB"

    def test_fixate(self):
        a = Caps("video/x-raw", {"width": IntRange(16, 4096), "format": ["RGB", "GRAY8"]})
        f = a.fixate()
        assert f.is_fixed()
        assert f["width"] == 16 and f["format"] == "RGB"

    def test_capslist_any(self):
        assert CapsList.any().intersect(CapsList([Caps("x", {})])).caps

    def test_capslist_empty_is_not_any(self):
        # regression: failed negotiation (empty) must differ from ANY
        a = CapsList([Caps("other/tensors", {})])
        b = CapsList([Caps("video/x-raw", {})])
        assert a.intersect(b).is_empty()
        assert not CapsList.any().is_empty()

    def test_link_incompatible_pads_raises(self):
        e1, e2 = Element(), Element()
        s = e1.add_src_pad(caps=CapsList([Caps("other/tensors", {})]))
        k = e2.add_sink_pad(caps=CapsList([Caps("video/x-raw", {})]))
        with pytest.raises(ValueError, match="caps do not intersect"):
            s.link(k)


class _NumSrc(SourceElement):
    """Deterministic test source: counts 0..n-1 as 1-elem float32 tensors."""

    ELEMENT_NAME = "_numsrc"
    PROPERTIES = {**SourceElement.PROPERTIES, "num_buffers": 5}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.i = 0

    def negotiate(self):
        from nnstreamer_tpu_torch.tensors.types import TensorsConfig

        cfg = TensorsConfig.from_arrays([np.zeros((1,), np.float32)])
        self.srcpad.set_caps(cfg.to_caps())

    def create(self):
        if self.i >= self.get_property("num_buffers"):
            return None
        buf = TensorBuffer([np.array([float(self.i)], np.float32)],
                           pts=self.i * 1000)
        self.i += 1
        return buf


class _Collect(Element):
    ELEMENT_NAME = "_collect"

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.buffers = []
        self.caps_seen = []
        self.got_eos = False

    def chain(self, pad, buf):
        self.buffers.append(buf)
        return FlowReturn.OK

    def sink_event(self, pad, event):
        if isinstance(event, CapsEvent):
            self.caps_seen.append(event.caps)
        if isinstance(event, EosEvent):
            self.got_eos = True


class TestPipeline:
    def test_push_flow_and_eos(self):
        src, sink = _NumSrc(num_buffers=7), _Collect()
        pipe = Pipeline().add_linked(src, sink)
        msg = pipe.run(timeout=10)
        assert msg is not None and msg.kind == "eos"
        assert len(sink.buffers) == 7
        assert [float(b[0][0]) for b in sink.buffers] == list(range(7))
        assert sink.got_eos
        assert sink.caps_seen and sink.caps_seen[0].name == "other/tensors"

    def test_queue_thread_boundary(self):
        src, q, sink = _NumSrc(num_buffers=20), Queue(), _Collect()
        pipe = Pipeline().add_linked(src, q, sink)
        pipe.run(timeout=10)
        assert [float(b[0][0]) for b in sink.buffers] == list(range(20))
        assert sink.got_eos

    def test_error_propagates_to_bus(self):
        class _Boom(Element):
            ELEMENT_NAME = "_boom"

            def __init__(self):
                super().__init__()
                self.add_sink_pad()

            def chain(self, pad, buf):
                raise ValueError("boom")

        pipe = Pipeline().add_linked(_NumSrc(), _Boom())
        with pytest.raises(FlowError, match="boom"):
            pipe.run(timeout=10)

    def test_element_stats_populated(self):
        src, sink = _NumSrc(num_buffers=50), _Collect()
        Pipeline().add_linked(src, sink).run(timeout=10)
        assert sink.stats.total_invokes == 50
        assert sink.get_property("latency") >= 0

    def test_property_unknown_raises(self):
        with pytest.raises(KeyError):
            _Collect().set_property("nope", 1)

    def test_property_coercion(self):
        src = _NumSrc()
        src.set_property("num_buffers", "12")
        assert src.get_property("num_buffers") == 12


def test_queue_prefetch_device_hands_off_device_arrays(cpu_device):
    """prefetch-device starts the host-to-device copy at enqueue: the
    consumer side of the queue sees device tensors (torch tensors on the
    package device, here the CPU as asked)."""
    import torch

    from nnstreamer_tpu_torch import parse_launch

    pipe = parse_launch(
        "appsrc name=src ! queue prefetch-device=true ! tensor_sink "
        "name=out to-host=false")
    seen = []
    pipe.get("out").connect(lambda b: seen.append(b))
    pipe.start()
    pipe.get("src").push([np.arange(6, dtype=np.float32)], pts=0)
    pipe.get("src").end_of_stream()
    msg = pipe.wait(timeout=30)
    pipe.stop()
    assert msg is not None and msg.kind == "eos"
    assert isinstance(seen[0][0], torch.Tensor)
    np.testing.assert_array_equal(np.asarray(seen[0][0]),
                                  np.arange(6, dtype=np.float32))


class TestQueueGroupedDrain:
    """materialize-host queues drain in groups (one overlapped D2H flush
    per backlog) — ordering and event serialization must survive
    grouping."""

    def test_order_preserved_under_backlog(self, cpu_device):
        import threading
        import time as _t

        from nnstreamer_tpu_torch import parse_launch

        pipe = parse_launch(
            "appsrc name=a block=true ! "
            "queue max-size-buffers=64 materialize-host=true ! "
            "tensor_sink name=s to-host=true")
        got = []
        gate = threading.Event()

        def slow_cb(buf):
            gate.wait(5)  # holds the drain so a backlog builds
            got.append(int(np.asarray(buf[0])[0]))

        pipe.get("s").connect(slow_cb)
        pipe.start()
        for i in range(20):
            pipe.get("a").push([np.asarray([i], np.int32)])
        gate.set()
        pipe.get("a").end_of_stream()
        assert pipe.wait(timeout=30).kind == "eos"
        pipe.stop()
        assert got == list(range(20))

    def test_caps_event_not_overtaken(self, cpu_device):
        """an event queued mid-stream stays ordered relative to buffers
        even when the drain gathers groups."""
        from nnstreamer_tpu_torch import parse_launch
        from nnstreamer_tpu_torch.pipeline.element import CustomEvent

        pipe = parse_launch(
            "appsrc name=a ! queue max-size-buffers=64 materialize-host=true "
            "name=q ! tensor_sink name=s to-host=true")
        seen = []
        pipe.get("s").connect(lambda b: seen.append(int(np.asarray(b[0])[0])))
        orig = pipe.get("s").sink_event

        def spy(pad, ev):
            if isinstance(ev, CustomEvent):
                seen.append(ev.name)
            return orig(pad, ev)

        pipe.get("s").sink_event = spy
        pipe.start()
        pipe.get("a").push([np.asarray([0], np.int32)])
        import time as _t

        _t.sleep(0.2)  # let buffer 0 drain so the event lands mid-stream
        pipe.get("q").sinkpads[0].push_event(CustomEvent("marker"))
        pipe.get("a").push([np.asarray([1], np.int32)])
        pipe.get("a").end_of_stream()
        assert pipe.wait(timeout=30).kind == "eos"
        pipe.stop()
        assert seen.index("marker") < seen.index(1)
        assert seen.index(0) < seen.index("marker")


class TestBatchLabelDecoder:
    def test_per_row_labels(self):
        from nnstreamer_tpu_torch.decoders.image_labeling import ImageLabeling
        from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

        scores = np.zeros((3, 5), np.float32)
        scores[0, 2] = 1.0
        scores[1, 4] = 2.0
        scores[2, 0] = 3.0
        out = ImageLabeling().decode(TensorBuffer([scores]), None,
                                     {"option2": "batched"})
        assert out.meta["label_index"] == [2, 4, 0]
        assert out.meta["score"] == [1.0, 2.0, 3.0]
        assert out[0].tobytes().decode() == "2\n4\n0"
