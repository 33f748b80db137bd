"""The port's TensorFlow backend (``nnstreamer_tpu_torch/filters/
tf_backend.py``) held to the JAX package's (``nnstreamer_tpu/filters/
tf_backend.py``) on the CPU, on the SavedModel and frozen ``.pb`` that
``tests/test_tf_backend.py`` writes and on its golden pipeline.

The JAX package stages the graph to StableHLO and runs it through XLA;
the port runs the same graph in TensorFlow on the host (ROADMAP C.46).
Both compute the same float32 matmul in other libraries, so outputs
agree to ``rtol=1e-6, atol=1e-6`` (a dot of 3 terms, rounded in another
order at most); the infos are equal. ``tensorflow`` runs its ops here
with one intra- and one inter-op thread, so a test worker's pool does not
oversubscribe the others.
"""

import os

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import nnstreamer_tpu as jnt  # noqa: E402
import nnstreamer_tpu_torch as tnt  # noqa: E402
from nnstreamer_tpu.filters.tf_backend import tf_model_entry as jax_entry  # noqa: E402
from nnstreamer_tpu_torch.filters import tf_backend  # noqa: E402
from nnstreamer_tpu_torch.filters.api import FilterProperties  # noqa: E402
from nnstreamer_tpu_torch.filters.torch_backend import TorchFilter  # noqa: E402
from nnstreamer_tpu_torch.tensors.types import TensorsInfo  # noqa: E402

W = np.arange(12, dtype=np.float32).reshape(3, 4)
RTOL = ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_tf_thread():
    for setter in (tf.config.threading.set_intra_op_parallelism_threads,
                   tf.config.threading.set_inter_op_parallelism_threads):
        try:
            setter(1)
        except RuntimeError:  # TF ran ops in this worker already
            pass


@pytest.fixture(autouse=True)
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


@pytest.fixture(scope="module")
def saved_model(tmp_path_factory):
    d = tmp_path_factory.mktemp("tfm") / "sm"

    class M(tf.Module):
        def __init__(self):
            self.w = tf.Variable(tf.constant(W))

        @tf.function(input_signature=[tf.TensorSpec([2, 3], tf.float32)])
        def __call__(self, x):
            return {"y": tf.matmul(x, self.w) + 1.0}

    tf.saved_model.save(M(), str(d))
    return str(d)


@pytest.fixture(scope="module")
def frozen_pb(tmp_path_factory, saved_model):
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    sm = tf.saved_model.load(saved_model)
    frozen = convert_variables_to_constants_v2(
        sm.signatures["serving_default"])
    d = tmp_path_factory.mktemp("tfpb")
    tf.io.write_graph(frozen.graph.as_graph_def(), str(d), "frozen.pb",
                      as_text=False)
    inp = frozen.inputs[0].name.split(":")[0]
    outp = frozen.outputs[0].name.split(":")[0]
    return str(d / "frozen.pb"), f"inputname:{inp},outputname:{outp}"


def _x(seed):
    return np.random.default_rng(seed).normal(size=(2, 3)).astype(
        np.float32)


def _infos(entry):
    return [[(tuple(t.dim), t.type.value) for t in entry[k]]
            for k in ("in_info", "out_info")]


@pytest.mark.parametrize("which", ["saved_model", "frozen_pb"])
def test_entry_matches_jax(which, request):
    if which == "saved_model":
        model, custom = request.getfixturevalue("saved_model"), None
    else:
        model, custom = request.getfixturevalue("frozen_pb")
    got, want = tf_backend.tf_model_entry(model, custom=custom), \
        jax_entry(model, custom=custom)
    assert _infos(got) == _infos(want) == [[((3, 2), "float32")],
                                           [((4, 2), "float32")]]
    for seed in range(3):
        x = _x(seed)
        g = got["fn"](x)[0]
        np.testing.assert_allclose(g, np.asarray(want["fn"](x)[0]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g, x @ W + 1.0, rtol=1e-5)
        assert isinstance(g, np.ndarray)


def test_missing_signature_pointed_error(saved_model):
    with pytest.raises(ValueError, match="signature"):
        tf_backend.tf_model_entry(saved_model, custom="signature:nope")


def test_names_required(frozen_pb):
    with pytest.raises(ValueError, match="inputname"):
        tf_backend.tf_model_entry(frozen_pb[0])


def test_dynamic_batch_pinned_by_input_info(tmp_path):
    class Dyn(tf.Module):
        @tf.function(input_signature=[tf.TensorSpec([None, 3],
                                                    tf.float32)])
        def __call__(self, x):
            return {"y": x * 3.0}

    sm = tmp_path / "dyn_sm"
    tf.saved_model.save(Dyn(), str(sm))
    with pytest.raises(ValueError, match="dynamic|static"):
        tf_backend.tf_model_entry(str(sm))
    pinned = TensorsInfo.from_str("3:2", "float32")
    e = tf_backend.tf_model_entry(str(sm), props_in_info=pinned)
    assert _infos(e)[1] == [((3, 2), "float32")]
    x = np.ones((2, 3), np.float32)
    np.testing.assert_allclose(e["fn"](x)[0], x * 3.0)


def _pushed(pkg, desc, frames):
    pipe = pkg.parse_launch(desc)
    src, out = pipe.get("src"), pipe.get("out")
    pipe.start()
    try:
        for f in frames:
            src.push([f])
        src.end_of_stream()
        msg = pipe.wait(timeout=120)
        assert msg is not None and msg.kind == "eos", msg
    finally:
        pipe.stop()
    return [np.asarray(b.tensors[0]) for b in out.buffers]


@pytest.mark.parametrize("framework,which", [
    ("tensorflow", "saved_model"), ("tensorflow", "frozen_pb"),
    ("jax", "saved_model"), ("jax", "frozen_pb"), ("torch", "frozen_pb"),
])
def test_in_a_pipeline_as_jax(framework, which, request):
    """``framework=tensorflow`` and, routed as the JAX backend routes
    them, ``framework=jax`` (and the port's ``torch``) with a SavedModel
    directory or a frozen ``.pb``."""
    if which == "saved_model":
        model, custom = request.getfixturevalue("saved_model"), ""
    else:
        model, custom = request.getfixturevalue("frozen_pb")
        custom = f" custom={custom}"
    frames = [_x(s) for s in range(3)]
    desc = (f"appsrc name=src ! tensor_filter framework={framework} "
            f"model={model}{custom} ! tensor_sink name=out")
    got = _pushed(tnt, desc, frames)
    want = _pushed(jnt, desc.replace("framework=torch", "framework=jax"),
                   frames)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 4) and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_golden_pipeline_as_jax(tmp_path):
    """``tests/test_tf_backend.py``'s golden string: videotestsrc gradient
    frames into a uint8 SavedModel that means each frame."""

    class Vision(tf.Module):
        @tf.function(input_signature=[
            tf.TensorSpec([1, 4, 4, 3], tf.uint8)])
        def __call__(self, x):
            xf = tf.cast(x, tf.float32)
            return {"mean": tf.reduce_mean(xf, axis=[1, 2, 3])}

    sm = tmp_path / "vision_sm"
    tf.saved_model.save(Vision(), str(sm))
    desc = ("videotestsrc num-buffers=3 width=4 height=4 pattern=gradient "
            f"! tensor_converter ! tensor_filter framework=tensorflow "
            f"model={sm} ! tensor_sink name=out")
    outs = {}
    for pkg in (jnt, tnt):
        pipe = pkg.parse_launch(desc)
        msg = pipe.run(timeout=120)
        assert msg is not None and msg.kind == "eos", msg
        outs[pkg] = [np.asarray(b.tensors[0]) for b in
                     pipe.get("out").buffers]
    assert len(outs[tnt]) == 3
    for g, w in zip(outs[tnt], outs[jnt]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_torch_backend_serves_a_saved_model_on_the_host(saved_model):
    """The torch backend hands a SavedModel to the TF backend: host
    numpy in and out, and no fused stage (ROADMAP C.46)."""
    fw = TorchFilter()
    fw.open(FilterProperties(model=saved_model))
    try:
        assert fw.KEEP_ON_DEVICE is False
        assert fw.device_stage() is None
        in_info, out_info = fw.get_model_info()
        assert str(out_info) == str(TensorsInfo.from_str("4:2", "float32"))
        (y,) = fw.invoke([_x(4)])
        assert isinstance(y, np.ndarray)
        np.testing.assert_allclose(y, _x(4) @ W + 1.0, rtol=1e-5)
    finally:
        fw.close()


def test_not_a_tf_model_raises(tmp_path):
    fw = tf_backend.TensorFlowFilter()
    with pytest.raises(ValueError, match="neither a SavedModel"):
        fw.open(FilterProperties(model=str(tmp_path)))


def test_importing_the_backend_loads_no_tensorflow():
    import subprocess
    import sys

    code = ("import sys\n"
            "import nnstreamer_tpu_torch.filters.tf_backend\n"
            "import nnstreamer_tpu_torch.filters.transformers_backend\n"
            "import nnstreamer_tpu_torch.filters.script\n"
            "sys.exit(1 if {'tensorflow', 'transformers'} & "
            "set(sys.modules) else 0)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
