"""Region fusion in the PyTorch port (``nnstreamer_tpu_torch/pipeline/fuse.py``),
held to the unfused port and to the JAX package's fused pipeline.

On the CPU a region calls its members' composed stages directly, so a
fused pipeline must give the unfused one's bytes exactly; on the card it
replays a CUDA graph (the ``gpu``-marked test at the end). The flagship
runs at 32×32 with 10 classes in float32, as ``tests/test_torch_pipeline.py``
runs it; against the JAX package, labels agree exactly and scores to rtol
1e-4 and atol 1e-4 × max|score|, that file's tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.filters.jax_backend import (
    register_jax_model,
    unregister_jax_model,
)
from nnstreamer_tpu.models.mobilenet_v2 import mobilenet_v2 as jax_mobilenet_v2
from nnstreamer_tpu_torch.decoders.image_labeling import ImageLabeling
from nnstreamer_tpu_torch.filters import torch_backend
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2, params_from_jax
from nnstreamer_tpu_torch.ops import _counts
from nnstreamer_tpu_torch.pipeline import fuse
from nnstreamer_tpu_torch.pipeline.element import CustomEvent, Element
from nnstreamer_tpu_torch.pipeline.fuse import (
    DeviceStage,
    FusedRegion,
    _Graph,
    fuse_pipeline,
)
from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

SIZE, CLASSES, FRAMES = 32, 10, 4


def _flagship(model: str, labels: str, extra: str = "",
              to_host: str = "true") -> str:
    return (
        f"videotestsrc num-buffers={FRAMES} width={SIZE} height={SIZE} "
        "pattern=ball ! tensor_converter ! "
        "tensor_transform name=tf mode=arithmetic "
        "option=typecast:float32,add:-127.5,div:127.5 ! "
        f"tensor_filter name=filter framework=jax model={model} {extra}! "
        f"tensor_decoder name=dec mode=image_labeling option1={labels} ! "
        "queue max-size-buffers=32 prefetch-host=true ! "
        f"tensor_sink name=out to-host={to_host}")


@pytest.fixture
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


@pytest.fixture
def labels(tmp_path):
    path = tmp_path / "labels.txt"
    path.write_text("".join(f"label_{i}\n" for i in range(CLASSES)))
    return str(path)


@pytest.fixture
def mnv2(cpu_device):
    module = MobileNetV2(num_classes=CLASSES).eval()
    register_torch_model(
        "fuse_mnv2", module,
        tnt.TensorsInfo.from_str(f"3:{SIZE}:{SIZE}:1", "float32"),
        tnt.TensorsInfo.from_str(f"{CLASSES}:1", "float32"))
    yield "fuse_mnv2"
    unregister_torch_model("fuse_mnv2")


def _run(description, fuse=True, name="pipeline"):
    pipe = tnt.parse_launch(description,
                            pipeline=Pipeline(name=name, fuse=fuse))
    bufs = []
    pipe.get("out").connect(bufs.append)
    pipe.run(timeout=120)
    return pipe, bufs


def _same_frames(a, b):
    assert len(a) == len(b) == FRAMES
    for x, y in zip(a, b):
        assert x.meta["label"] == y.meta["label"]
        assert x.meta["label_index"] == y.meta["label_index"]
        assert np.float32(x.meta["score"]).tobytes() == \
            np.float32(y.meta["score"]).tobytes()
        assert np.asarray(x[0]).tobytes() == np.asarray(y[0]).tobytes()


# -- the flagship, fused ------------------------------------------------------
def test_flagship_fuses_transform_filter_decoder_by_default(mnv2, labels):
    pipe = tnt.parse_launch(_flagship(mnv2, labels))
    assert pipe._fuse is True
    pipe, bufs = _run(_flagship(mnv2, labels))
    (region,) = pipe._regions
    assert isinstance(region, FusedRegion) and not region._dead
    assert [m.name for m in region.members] == ["tf", "filter", "dec"]
    assert len(bufs) == FRAMES
    assert all(b.meta["label"].startswith("label_") for b in bufs)


@pytest.mark.parametrize("switch", ["pipeline", "env"])
def test_fused_flagship_byte_identical_to_unfused(mnv2, labels, monkeypatch,
                                                  switch):
    fused_pipe, fused = _run(_flagship(mnv2, labels))
    if switch == "pipeline":
        plain_pipe, plain = _run(_flagship(mnv2, labels), fuse=False)
    else:
        monkeypatch.setenv("NNSTPU_FUSE", "0")
        plain_pipe, plain = _run(_flagship(mnv2, labels))
    assert fused_pipe._regions and not plain_pipe._regions
    _same_frames(fused, plain)


def test_fused_flagship_matches_jax_fused(cpu_device, labels):
    apply_fn, variables, in_info, out_info = jax_mobilenet_v2(
        num_classes=CLASSES, image_size=SIZE, dtype=jnp.float32, seed=11)
    module = MobileNetV2(num_classes=CLASSES)
    module.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                        variables)))
    register_jax_model("fuse_parity", apply_fn, variables, in_info=in_info,
                       out_info=out_info)
    register_torch_model(
        "fuse_parity", module.eval(),
        tnt.TensorsInfo.from_str(f"3:{SIZE}:{SIZE}:1", "float32"),
        tnt.TensorsInfo.from_str(f"{CLASSES}:1", "float32"))
    try:
        ref_pipe = jnt.parse_launch(_flagship("fuse_parity", labels))
        ref = []
        ref_pipe.get("out").connect(lambda buf: ref.append(buf.meta))
        ref_pipe.run(timeout=120)
        pipe, got = _run(_flagship("fuse_parity", labels))
    finally:
        unregister_jax_model("fuse_parity")
        unregister_torch_model("fuse_parity")
    assert ref_pipe._regions and pipe._regions
    assert len(got) == len(ref) == FRAMES
    assert [b.meta["label"] for b in got] == [m["label"] for m in ref]
    ref_scores = np.array([m["score"] for m in ref])
    np.testing.assert_allclose([b.meta["score"] for b in got], ref_scores,
                               rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref_scores).max()))


# -- which runs fuse ----------------------------------------------------------
def _started_regions(description):
    pipe = tnt.parse_launch(description)
    pipe.start()
    pipe.stop()
    return pipe._regions


def test_finalizing_decoder_ends_its_run(mnv2, labels):
    regions = _started_regions(
        "appsrc name=src ! tensor_transform name=a mode=typecast "
        "option=float32 ! tensor_filter name=f framework=jax "
        f"model={mnv2} ! tensor_decoder name=d mode=image_labeling "
        f"option1={labels} ! tensor_transform name=b mode=typecast "
        "option=float32 ! tensor_transform name=c mode=typecast "
        "option=float32 ! tensor_sink name=out")
    assert [[m.name for m in r.members] for r in regions] == \
        [["a", "f", "d"], ["b", "c"]]


def test_run_of_one_is_not_fused(cpu_device):
    assert _started_regions(
        "appsrc name=src ! tensor_transform mode=typecast option=float32 ! "
        "tensor_sink name=out") == []


def test_unaccelerated_transform_is_not_fused(mnv2, labels):
    (region,) = _started_regions(
        "appsrc name=src ! tensor_transform name=t mode=typecast "
        "option=float32 acceleration=false ! tensor_filter name=f "
        f"framework=jax model={mnv2} ! tensor_decoder name=d "
        f"mode=image_labeling option1={labels} ! tensor_sink name=out")
    assert [m.name for m in region.members] == ["f", "d"]


class _Stage(Element):
    """A single-in/single-out element with a stage on a chosen device."""

    ELEMENT_NAME = "test_stage"

    def __init__(self, name, device=None, fn=None, finalize=None):
        super().__init__(name)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        self.device = device
        self.fn = fn or (lambda c, ts: [t + 1 for t in ts])
        self.finalize = finalize

    def chain(self, pad, buf):
        return self.srcpad.push(buf.with_tensors(
            self.fn(None, [torch.as_tensor(t) for t in buf.tensors])))

    def device_stage(self):
        return DeviceStage(consts=None, fn=self.fn, key=("stage", self.name),
                           device=self.device, finalize=self.finalize)


def test_members_on_different_devices_are_not_fused():
    cpu, card = torch.device("cpu"), torch.device("cuda:0")
    els = [_Stage("a", cpu), _Stage("b", None), _Stage("c", cpu),
           _Stage("d", card), _Stage("e", card), _Stage("f", cpu)]
    pipe = Pipeline()
    pipe.add_linked(*els)
    regions = fuse_pipeline(pipe)
    assert [[m.name for m in r.members] for r in regions] == \
        [["a", "b", "c"], ["d", "e"]]


def test_mesh_stages_are_not_ported():
    with pytest.raises(NotImplementedError, match="A.24"):
        DeviceStage(consts=None, fn=lambda c, t: t, mesh="dp4")


def _appsrc_run(pipe, frames):
    src = pipe.get("src")
    pipe.start()
    try:
        for f in frames:
            src.push([f])
        src.end_of_stream()
        msg = pipe.wait(timeout=60)
        assert msg is not None and msg.kind == "eos", msg
    finally:
        pipe.stop()
    return pipe


TWO_TRANSFORMS = (
    "appsrc name=src ! tensor_transform name=a mode=arithmetic "
    "option=typecast:float32,mul:2.0 ! tensor_transform name=b "
    "mode=arithmetic option=typecast:float32,add:1.0 ! tensor_sink name=out")


def test_retraces_count_one_per_input_signature(cpu_device):
    shapes = [(2, 3), (2, 3), (4, 3), (2, 3), (4, 3), (5,)]
    frames = [np.arange(np.prod(s), dtype=np.uint8).reshape(s)
              for s in shapes]
    pipe = _appsrc_run(tnt.parse_launch(
        TWO_TRANSFORMS, pipeline=Pipeline(name="retraces")), frames)
    (region,) = pipe._regions
    snap = pipe.metrics_snapshot()["regions"][region.name]
    assert snap["retraces"] == 3 and snap["eager_frames"] == len(shapes)
    assert snap["captures"] == snap["replays"] == 0  # no graphs on the CPU
    outs = pipe.get("out").buffers
    for f, b in zip(frames, outs):
        np.testing.assert_array_equal(np.asarray(b[0]),
                                      f.astype(np.float32) * 2 + 1)


def test_first_frame_failure_falls_back_to_member_chain(monkeypatch):
    def broken(consts, tensors):
        raise RuntimeError("no stage today")

    els = [_Stage("a", torch.device("cpu")),
           _Stage("b", torch.device("cpu"), fn=broken)]
    # the chain of b works: only its stage fails
    els[1].chain = lambda pad, buf: els[1].srcpad.push(buf)
    pipe = Pipeline()
    pipe.add_linked(*els)
    (region,) = fuse_pipeline(pipe)
    pipe._regions = [region]
    out = []

    class Sink(Element):
        def chain(self, pad, buf):
            out.append(buf)

    sink = Sink("sink")
    sink.add_sink_pad("sink")
    pipe.add(sink)
    region.srcpad.link(sink.sinkpad)
    warned = []
    monkeypatch.setattr(fuse.log, "warning",
                        lambda msg, *args: warned.append(msg % args))
    region._chain_entry(region.sinkpad, tnt.TensorBuffer([torch.zeros(3)]))
    assert region._dead and "falling back" in warned[0]
    assert torch.equal(out[0][0], torch.ones(3))
    assert els[0].sinkpad.peer is None  # nothing upstream of the region
    assert els[1].srcpad.peer is sink.sinkpad


# -- what stays as it was ----------------------------------------------------
def test_member_stats_stay_live(mnv2, labels):
    # the retrace counter is the registry's, keyed by pipeline and region
    pipe, _ = _run(_flagship(mnv2, labels), name="stats_live")
    filt = pipe.get("filter")
    assert filt.stats.total_invokes == 0  # its chain did not run
    assert filt.get_property("throughput") > 0
    snap = pipe.metrics_snapshot()
    assert snap["elements"]["filter"]["invokes"] == FRAMES
    (region,) = snap["regions"].values()
    assert region["members"] == ["tf", "filter", "dec"]
    assert region["retraces"] == 1 and not region["unspliced"]


def test_custom_event_consume_semantics(cpu_device):
    """An event a member consumes stops there; one no member consumes
    reaches downstream once — as in the unfused pipeline."""
    pipe = tnt.parse_launch(TWO_TRANSFORMS)
    sink, first = pipe.get("out"), pipe.get("a")
    seen = []
    sink_event, first_event = sink.sink_event, first.sink_event

    def spy(pad, event):
        if isinstance(event, CustomEvent):
            seen.append(event.name)
        return sink_event(pad, event)

    def eat(pad, event):
        if isinstance(event, CustomEvent) and event.name == "eat_me":
            return None
        return first_event(pad, event)

    sink.sink_event, first.sink_event = spy, eat
    pipe.start()
    try:
        (region,) = pipe._regions
        region._event_entry(region.sinkpad, CustomEvent("app_event", {}))
        region._event_entry(region.sinkpad, CustomEvent("eat_me", {}))
        assert seen == ["app_event"]
    finally:
        pipe.stop()


def test_restart_reuses_region_safely(cpu_device):
    pipe = tnt.parse_launch(TWO_TRANSFORMS)
    frame = np.arange(6, dtype=np.uint8).reshape(2, 3)
    _appsrc_run(pipe, [frame])
    (region,) = pipe._regions
    first = np.asarray(pipe.get("out").buffers[-1][0])
    pipe.get("b").set_property("option", "typecast:float32,add:3.0")
    src = pipe.get("src")
    pipe.start()  # members re-started; the same region re-pulls stages
    try:
        src.push([frame])
        src.end_of_stream()
        assert pipe.wait(timeout=60).kind == "eos"
    finally:
        pipe.stop()
    assert pipe._regions == [region] and not region._dead
    second = np.asarray(pipe.get("out").buffers[-1][0])
    np.testing.assert_array_equal(first, frame * 2.0 + 1)
    np.testing.assert_array_equal(second, frame * 2.0 + 3)


def test_restart_keeps_graphs_unless_invalidated(cpu_device):
    """ROADMAP A.8b: a plain stop()/start() keeps the region's graphs when
    every stage key is unchanged, as the JAX region keeps its trace (here
    a stand-in dict: no graph is captured on the CPU); a property edit, or
    an explicit invalidate(), drops them, and so does a restart whose keys
    changed while the graphs were held."""
    pipe = tnt.parse_launch(TWO_TRANSFORMS,
                            pipeline=Pipeline(name="restart_keep"))
    frame = np.arange(6, dtype=np.uint8).reshape(2, 3)
    _appsrc_run(pipe, [frame])
    (region,) = pipe._regions
    retraces = region.obs_snapshot()["retraces"]
    stand_in = {"sig": object()}
    region._graphs = stand_in
    _appsrc_run(pipe, [frame])  # a plain restart
    assert region._graphs is stand_in
    assert region.obs_snapshot()["retraces"] == retraces  # _seen kept
    pipe.get("b").set_property("option", "typecast:float32,add:3.0")
    assert region._graphs == {}  # the edit invalidated
    region._graphs = stand_in
    _appsrc_run(pipe, [frame])  # the keys changed since the last build
    assert region._graphs == {}
    assert region.obs_snapshot()["retraces"] == retraces + 1
    np.testing.assert_array_equal(
        np.asarray(pipe.get("out").buffers[-1][0]), frame * 2.0 + 3)
    region._graphs = stand_in
    region.invalidate()
    assert region._graphs == {} and region._compiled is None


def _rebind_classifier(module, how):
    """Moves the classifier's weight to new storage, doubled, under the
    same module object, one of the ways a user does it."""
    head = module.classifier
    if how == "data":
        head.weight.data = head.weight.data * 2
    else:
        head.load_state_dict({"weight": head.weight.detach() * 2,
                              "bias": head.bias.detach().clone()},
                             assign=True)


@pytest.mark.parametrize("how", ["data", "assign"])
def test_restart_drops_graphs_when_a_weight_is_rebound(mnv2, labels, how):
    """A stage key names the module object, which a rebound weight leaves
    as it was; the storage pin does not, so the restart drops the graphs
    (whose replays would read the freed storage) and the output is the
    new weights'."""
    pipe = tnt.parse_launch(_flagship(mnv2, labels),
                            pipeline=Pipeline(name=f"rebind_{how}"))
    bufs = []
    pipe.get("out").connect(bufs.append)
    pipe.run(timeout=120)
    (region,) = pipe._regions
    stand_in = {"sig": object()}
    region._graphs = stand_in
    pipe.run(timeout=120)  # a plain restart: the storage is the same
    assert region._graphs is stand_in
    module = torch_backend._registered[mnv2]["module"]  # the filter's own
    ptr = module.classifier.weight.data_ptr()
    _rebind_classifier(module, how)
    assert module.classifier.weight.data_ptr() != ptr
    pipe.run(timeout=120)
    assert region._graphs == {}
    _, plain = _run(_flagship(mnv2, labels), fuse=False)
    _same_frames(bufs[-FRAMES:], plain)


@pytest.mark.parametrize("to_host", ["true", "false"])
def test_finalize_applied_once(mnv2, labels, monkeypatch, to_host):
    calls = []
    real = ImageLabeling.host_finalize

    def spy(self, host_buf, config, options):
        calls.append(1)
        return real(self, host_buf, config, options)

    monkeypatch.setattr(ImageLabeling, "host_finalize", spy)
    pipe, bufs = _run(_flagship(mnv2, labels, to_host=to_host))
    assert pipe._regions and len(bufs) == len(calls) == FRAMES
    for b in bufs:
        assert b.finalize is None and b.meta["label"].startswith("label_")
        assert bytes(np.asarray(b[0])).decode() == b.meta["label"]


# -- launch counts of captured kernels ---------------------------------------
@pytest.fixture
def fake_capturing(monkeypatch):
    state = {"on": False}
    monkeypatch.setattr(_counts, "capturing", lambda: state["on"])
    _counts.reset_launches()
    yield state
    _counts.reset_launches()


def test_capture_tally_keeps_captured_launches_out_of_the_count(
        fake_capturing):
    _counts.count_launch("normalize_chain")  # ran on the card: counted
    fake_capturing["on"] = True
    with _counts.capture_tally() as tally:
        _counts.count_launch("normalize_chain")
        _counts.count_launch("normalize_chain")
        _counts.count_launch("quantize_int8")
    _counts.count_launch("normalize_chain")  # captured with no tally open
    assert tally == {"normalize_chain": 2, "quantize_int8": 1}
    assert _counts.LAUNCHES["normalize_chain"] == 1
    assert _counts.LAUNCHES["quantize_int8"] == 0
    for _ in range(3):
        _counts.add_replay(tally)
    assert _counts.LAUNCHES["normalize_chain"] == 7
    assert _counts.LAUNCHES["quantize_int8"] == 3


def test_wrapper_captured_in_a_tally(fake_capturing, monkeypatch):
    """B1's wrapper counts through the same path: captured, its launch
    goes to the tally (the kernel itself is stubbed here)."""
    from nnstreamer_tpu_torch.ops import preprocess as pp

    fake_capturing["on"] = True
    with _counts.capture_tally() as tally:
        pp.count_launch("normalize_chain")
    assert tally == {"normalize_chain": 1}
    assert _counts.LAUNCHES["normalize_chain"] == 0


def test_graph_replay_counts_and_hands_out_copies(fake_capturing):
    class FakeGraph:
        def __init__(self, inputs, outputs):
            self.inputs, self.outputs = inputs, outputs

        def replay(self):
            self.outputs[0].copy_(self.inputs[0] * 2)

    static_in, static_out = [torch.zeros(3)], [torch.zeros(3)]
    graph = _Graph(FakeGraph(static_in, static_out), static_in, static_out,
                   {"normalize_chain": 1})
    outs = [graph.replay([np.full(3, i, np.float32)]) for i in range(5)]
    assert _counts.LAUNCHES["normalize_chain"] == 5
    for i, (o,) in enumerate(outs):
        assert o is not static_out[0]
        assert torch.equal(o, torch.full((3,), 2.0 * i))


# -- on the card ---------------------------------------------------------------
@pytest.mark.gpu
def test_region_graph_bit_identical_on_the_card(labels):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the region captures a CUDA graph")
    tnt.set_device(None)
    module = MobileNetV2(num_classes=CLASSES).eval()
    register_torch_model("fuse_gpu", module)
    n = 40  # more frames than the queue holds: several in flight
    description = _flagship("fuse_gpu", labels).replace(
        f"num-buffers={FRAMES}", f"num-buffers={n}")
    try:
        _counts.reset_launches()
        fused_pipe, fused = _run(description)
        launches = dict(_counts.LAUNCHES)
        plain_pipe, plain = _run(description, fuse=False)
    finally:
        unregister_torch_model("fuse_gpu")
    (region,) = fused_pipe._regions
    assert not region._dead and region.captures == 1
    assert region.eager_frames == 1 and region.replays == n - 1
    assert launches["normalize_chain"] == n
    assert len(fused) == len(plain) == n
    for x, y in zip(fused, plain):
        assert x.meta["label"] == y.meta["label"]
        assert np.float32(x.meta["score"]).tobytes() == \
            np.float32(y.meta["score"]).tobytes()


@pytest.mark.gpu
def test_rebound_weight_captures_again_on_the_card(labels):
    """A weight rebound between two runs moves it to new storage: the
    restart captures once more, and the output is the new weights',
    bit-identical to the unfused pipeline's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the region captures a CUDA graph")
    tnt.set_device(None)
    module = MobileNetV2(num_classes=CLASSES).eval()
    register_torch_model("fuse_rebind", module)
    description = _flagship("fuse_rebind", labels)
    try:
        pipe = tnt.parse_launch(description,
                                pipeline=Pipeline(name="rebind_gpu"))
        bufs = []
        pipe.get("out").connect(bufs.append)
        pipe.run(timeout=120)
        (region,) = pipe._regions
        assert region.captures == 1
        pipe.run(timeout=120)  # a plain restart
        assert region.captures == 1
        _rebind_classifier(module, "data")
        pipe.run(timeout=120)
        assert region.captures == 2
        assert region.obs_snapshot()["retraces"] == 2
        _, plain = _run(description, fuse=False)
    finally:
        unregister_torch_model("fuse_rebind")
    assert len(plain) == FRAMES
    for x, y in zip(bufs[-FRAMES:], plain):
        assert x.meta["label"] == y.meta["label"]
        assert np.float32(x.meta["score"]).tobytes() == \
            np.float32(y.meta["score"]).tobytes()


@pytest.mark.gpu
def test_plain_restart_replays_without_capturing_on_the_card():
    """tests/test_fuse.py:131-151's restart on the card: a plain restart
    captures nothing and leaves ``nns_fuse_retraces_total`` where it was,
    its output bit-identical to a cold run's; a property edit captures
    again."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the region captures a CUDA graph")
    tnt.set_device(None)
    frames = [np.arange(24, dtype=np.uint8).reshape(8, 3) + i
              for i in range(3)]

    def outputs(pipe):
        return [np.asarray(b[0]).tobytes() for b in pipe.get("out").buffers]

    _counts.reset_launches()
    cold = _appsrc_run(tnt.parse_launch(
        TWO_TRANSFORMS, pipeline=Pipeline(name="restart_cold")), frames)
    cold_launches = _counts.LAUNCHES["normalize_chain"]
    assert cold_launches >= len(frames)  # B1 in every frame, replayed
    pipe = tnt.parse_launch(TWO_TRANSFORMS,
                            pipeline=Pipeline(name="restart_warm"))
    _appsrc_run(pipe, frames)
    (region,) = pipe._regions
    snap = region.obs_snapshot()
    assert snap["captures"] == 1 and snap["retraces"] == 1
    pipe.get("out").buffers.clear()
    _counts.reset_launches()
    _appsrc_run(pipe, frames)  # a plain restart
    snap = region.obs_snapshot()
    assert snap["captures"] == 1 and snap["retraces"] == 1
    assert snap["replays"] == 2 * len(frames) - 1
    assert _counts.LAUNCHES["normalize_chain"] == cold_launches
    assert outputs(pipe) == outputs(cold)
    pipe.get("b").set_property("option", "typecast:float32,add:3.0")
    pipe.get("out").buffers.clear()
    _appsrc_run(pipe, frames)
    snap = region.obs_snapshot()
    assert snap["captures"] == 2 and snap["retraces"] == 2
    for f, b in zip(frames, pipe.get("out").buffers):
        np.testing.assert_array_equal(np.asarray(b[0]),
                                      f.astype(np.float32) * 2 + 3)
