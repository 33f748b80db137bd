"""The flagship classification pipeline in the PyTorch port, held to the
JAX package end to end.

Both packages run the README's launch string on the same ``videotestsrc``
frames, on the CPU, in float32, at 32×32 with 10 classes, the port on
weights converted from the JAX package's model. Labels agree exactly; scores (the
top logit) to rtol 1e-4 and atol 1e-4 * max|score|, the model tolerance of
``test_torch_mobilenet_v2.py``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.elements.source import VideoTestSrc as JaxVideoTestSrc
from nnstreamer_tpu.filters.jax_backend import (
    register_jax_model,
    unregister_jax_model,
)
from nnstreamer_tpu.models.mobilenet_v2 import mobilenet_v2 as jax_mobilenet_v2
from nnstreamer_tpu_torch.elements.source import VideoTestSrc
from nnstreamer_tpu_torch.filters.torch_backend import (
    TorchFilter,
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2, params_from_jax
from nnstreamer_tpu_torch.registry import FILTER, get_subplugin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, CLASSES, FRAMES = 32, 10, 4


def _flagship(model: str, labels: str, extra: str = "") -> str:
    return (
        f"videotestsrc num-buffers={FRAMES} width={SIZE} height={SIZE} "
        "pattern=ball ! tensor_converter ! "
        "tensor_transform mode=arithmetic "
        "option=typecast:float32,add:-127.5,div:127.5 ! "
        f"tensor_filter framework=jax model={model} {extra}! "
        f"tensor_decoder mode=image_labeling option1={labels} ! "
        "queue max-size-buffers=32 prefetch-host=true ! "
        "tensor_sink name=out to-host=true")


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


def _run(pkg, description):
    pipe = pkg.parse_launch(description)
    metas = []
    pipe.get("out").connect(lambda buf: metas.append(buf.meta))
    pipe.run(timeout=120)
    return metas


def test_flagship_pipeline_matches_jax(cpu_device, labels):
    apply_fn, variables, in_info, out_info = jax_mobilenet_v2(
        num_classes=CLASSES, image_size=SIZE, dtype=jnp.float32, seed=11)
    module = MobileNetV2(num_classes=CLASSES)
    module.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                        variables)))
    register_jax_model("parity_mnv2", apply_fn, variables, in_info=in_info,
                       out_info=out_info)
    register_torch_model(
        "parity_mnv2", module.eval(),
        tnt.TensorsInfo.from_str(f"3:{SIZE}:{SIZE}:1", "float32"),
        tnt.TensorsInfo.from_str(f"{CLASSES}:1", "float32"))
    try:
        ref = _run(jnt, _flagship("parity_mnv2", labels))
        got = _run(tnt, _flagship("parity_mnv2", labels,
                                  "accelerator=true:cpu "))
    finally:
        unregister_jax_model("parity_mnv2")
        unregister_torch_model("parity_mnv2")
    assert len(got) == len(ref) == FRAMES
    assert [m["label"] for m in got] == [m["label"] for m in ref]
    assert all(m["label"].startswith("label_") for m in got)
    ref_scores = np.array([m["score"] for m in ref])
    np.testing.assert_allclose([m["score"] for m in got], ref_scores,
                               rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref_scores).max()))


@pytest.mark.parametrize("pattern", ["smpte", "ball", "gradient", "black"])
@pytest.mark.parametrize("fmt", ["RGB", "BGRA", "GRAY8"])
def test_videotestsrc_frames_byte_identical(pattern, fmt):
    props = dict(pattern=pattern, width=19, height=11, format=fmt)
    ours, theirs = VideoTestSrc(**props), JaxVideoTestSrc(**props)
    for i in (0, 1, 5):
        a, b = ours._frame(i), np.asarray(theirs._frame(i))
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_converted_frames_byte_identical_through_both_packages():
    desc = ("videotestsrc num-buffers=3 width=16 height=8 pattern=ball ! "
            "tensor_converter ! tensor_sink name=out")

    def frames(pkg):
        pipe = pkg.parse_launch(desc)
        out = []
        pipe.get("out").connect(lambda buf: out.append(
            np.asarray(buf.to_host().tensors[0])))
        pipe.run(timeout=60)
        return out

    ours, theirs = frames(tnt), frames(jnt)
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape == (1, 8, 16, 3)
        assert a.tobytes() == b.tobytes()


def test_opening_without_cuda_or_cpu_request_raises(labels):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the package device is usable")
    tnt.set_device(None)
    register_torch_model("nocuda_mnv2", MobileNetV2(num_classes=CLASSES))
    try:
        pipe = tnt.parse_launch(_flagship("nocuda_mnv2", labels))
        with pytest.raises(RuntimeError) as err:
            pipe.start()
        pipe.stop()
    finally:
        unregister_torch_model("nocuda_mnv2")
    assert "set_device('cpu')" in str(err.value)
    assert "accelerator=true:cpu" in str(err.value)


def test_filter_accelerator_grammar(cpu_device):
    from nnstreamer_tpu_torch.device import parse_accelerator

    assert parse_accelerator("false") == torch.device("cpu")
    assert parse_accelerator("true:cpu") == torch.device("cpu")
    assert parse_accelerator("true:cuda") == torch.device("cuda:0")
    assert parse_accelerator("true:tpu") is None  # the package device
    assert parse_accelerator(None) is None
    # framework=jax launch strings reach the torch backend
    assert get_subplugin(FILTER, "jax") is TorchFilter
    assert get_subplugin(FILTER, "torch") is TorchFilter


def test_import_leaves_jax_out():
    """A fresh interpreter that imports every module of the port has
    imported neither JAX nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import nnstreamer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('serving.engine', 'elements.lm_serve', "
        "'models.transformer', 'ops.flash_attention', 'ops.quantize', "
        "'elements.quant', 'elements.query', 'query.protocol', "
        "'query.server', 'tensors.meta', 'tensors.pool', "
        "'tensors.buffer', 'pipeline.dispatch', 'elements.aggregator', "
        "'obs.timeline', 'pipeline.faults', 'pipeline.supervise', "
        "'pipeline.lanes', 'serving.scheduler', 'obs.flight', "
        "'obs.quantiles', 'obs.server', 'pipeline.dot', 'elements.rate', "
        "'cli', 'serving.kvpool', 'models.speculative', 'elements.tee', "
        "'elements.collect', 'elements.mux', 'elements.merge', "
        "'elements.repo', 'models.lstm', 'models.ssd_mobilenet', "
        "'models.yolo', 'models.posenet', 'models.segmenter', "
        "'decoders.bounding_boxes', 'decoders.overlay', "
        "'decoders.pose_estimation', 'decoders.image_segment', "
        "'utils.platform', 'utils.trace', 'tensors.memory', "
        "'filters.torch_backend', 'pipeline.pipeline', "
        "'utils.checkpoint', 'pipeline.continuity', 'filters.artifact', "
        "'elements.filter', 'ops._build', 'elements.source', "
        "'elements.converter', 'elements.sink', 'elements.cond', "
        "'elements.demux', 'elements.split', 'elements.join', "
        "'elements.crop', 'filters.custom', 'tensors.data', "
        "'decoders.octet_stream', 'decoders.direct_video', "
        "'decoders.python3', 'converters.python3', "
        "'models.audio_classifier'):\n"
        "    importlib.import_module('nnstreamer_tpu_torch.' + m)\n"
        "from nnstreamer_tpu_torch.serving import ContinuousBatchingEngine\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ml_dtypes', 'nnstreamer_tpu'))\n"
        "print(len(list(pkgutil.walk_packages(p.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("desc", [
    "appsrc ! tensor_aggregator frames-in=1 frames-out=8 frames-flush=8 "
    "frames-dim=3 concat=true latency-budget-ms=5 pad-device=true ! "
    "tensor_sink",
    "appsrc ! queue prefetch-device=true batch-h2d=false drain-batch=4 ! "
    "tensor_sink",
    "appsrc ! tensor_filter framework=jax model=m inflight=3 ! tensor_sink",
    "appsrc ! tensor_filter framework=jax model=m throttle=5 ! tensor_sink",
    "appsrc ! queue slo-budget-ms=20 stamp-admission=true ! tensor_sink",
    "appsrc ! tensor_rate framerate=10/1 throttle=true ! tensor_sink",
])
def test_staging_properties_are_ported(desc):
    tnt.parse_launch(desc)


@pytest.mark.parametrize("desc,item", [
    ("appsrc ! tensor_query_client propagate-deadline=true ! "
     "tensor_sink", "26a"),
    ("appsrc ! tensor_query_client balance=shortest-slack ! "
     "tensor_sink", "26b"),
])
def test_admission_properties_still_raise(desc, item):
    """The filter's throttle and the queue's SLO budget are ported; the
    admission pieces that ride the query wire are not: a deadline carried
    to the server (26a) and slack-aware fleet balancing (26b)."""
    with pytest.raises(NotImplementedError, match=item):
        tnt.parse_launch(desc)


def test_mesh_quantum_still_raises():
    from nnstreamer_tpu_torch.elements.aggregator import TensorAggregator

    with pytest.raises(NotImplementedError, match="A.24"):
        TensorAggregator(frames_out=8).note_mesh_quantum(2)


def test_sources_name_no_jax():
    forbidden = ("import jax", "from jax", "flax", "ml_dtypes",
                 "import nnstreamer_tpu\n", "import nnstreamer_tpu ",
                 "from nnstreamer_tpu.", "from nnstreamer_tpu import")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "nnstreamer_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            text = f.read()
        for word in forbidden:
            assert word not in text.lower(), f"{path} contains {word!r}"


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_shape_probe_leaves_a_running_module_alone():
    """The torch backend probes output shapes on a meta twin of the
    registered module: the module itself, which other threads may be
    running (a second pipeline naming it, a region's first frame), never
    has its weights swapped for meta tensors."""
    from nnstreamer_tpu_torch.filters.api import FilterProperties
    from nnstreamer_tpu_torch.tensors.types import TensorsInfo

    seen = []

    class Spy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(4, 3))

        def forward(self, x):
            # the registered module's own weight, whichever copy runs
            seen.append(spy.w.device.type)
            return x.float() @ self.w

    spy = Spy()
    tnt.set_device("cpu")
    register_torch_model("probe_race", spy)
    try:
        fw = TorchFilter()
        fw.open(FilterProperties(model="probe_race"))
        out = fw.set_input_info(TensorsInfo.from_str("4:2", "float32"))
        assert out[0].dim == (3, 2)
        assert seen == ["cpu"]
        # a second filter of the module takes the probed shapes: no
        # second forward; another input shape probes again
        fw2 = TorchFilter()
        fw2.open(FilterProperties(model="probe_race"))
        assert fw2.set_input_info(
            TensorsInfo.from_str("4:2", "float32"))[0].dim == (3, 2)
        assert seen == ["cpu"]
        assert fw2.set_input_info(
            TensorsInfo.from_str("4:5", "float32"))[0].dim == (3, 5)
        assert seen == ["cpu", "cpu"]
    finally:
        unregister_torch_model("probe_race")
        tnt.set_device(None)
