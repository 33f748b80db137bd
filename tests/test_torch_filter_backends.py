"""The port's jax-free filter backends held to the JAX package's on the
CPU: ``framework=python`` (``filters/python_class.py``, a user class),
``framework=pipeline`` (``filters/pipeline_filter.py``, a nested launch
string; the cases of ``tests/test_filter_backends_extra.py``),
``framework=native`` (``filters/native_filter.py``, the C-ABI plugin of
``native/examples``, built here; the cases of
``tests/test_native_filter.py``) and
``framework=tflite`` (``filters/tflite_backend.py``, on a model converted
here with ``tf.lite.TFLiteConverter``). The same numpy inputs go through
both packages; outputs are compared byte for byte, since each backend runs
the same host code (or the same interpreter or plugin) in both.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu_torch.filters.api import FilterProperties
from nnstreamer_tpu_torch.registry import FILTER, get_subplugin
from nnstreamer_tpu_torch.tensors.types import TensorsInfo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(REPO, "native")
SCALER_SO = os.path.join(NATIVE_DIR, "libnnstpu_filter_scaler.so")


@pytest.fixture(autouse=True)
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


def _pushed(pkg, desc, frames, sink="out"):
    """``desc`` (an ``appsrc name=src``) fed ``frames``: the host bytes,
    dtype and shape of each tensor the sink received."""
    pipe = pkg.parse_launch(desc)
    src, out = pipe.get("src"), pipe.get(sink)
    pipe.start()
    try:
        for f in frames:
            src.push(f if isinstance(f, list) else [f])
        src.end_of_stream()
        msg = pipe.wait(timeout=60)
        assert msg is not None and msg.kind == "eos", msg
    finally:
        pipe.stop()
    return [[(np.asarray(t).tobytes(), np.asarray(t).dtype,
              np.asarray(t).shape) for t in b.tensors] for b in out.buffers]


def _both(desc, frames):
    got, want = _pushed(tnt, desc, frames), _pushed(jnt, desc, frames)
    assert got == want
    return got


def _run_collect(pkg, desc, sink="out"):
    pipe = pkg.parse_launch(desc)
    outs = []
    pipe.get(sink).connect(lambda b: outs.append(b))
    msg = pipe.run(timeout=120)
    assert msg is not None and msg.kind == "eos", msg
    return [[np.asarray(t).tobytes() for t in b.tensors] for b in outs]


# -- framework=python --------------------------------------------------------
PY_FILTER = '''
import numpy as np
from {pkg}.tensors.types import TensorsInfo


class Filter:
    def __init__(self, custom=None):
        self.scale = float((custom or "scale:2").split(":")[1])

    def getInputDim(self):
        return TensorsInfo.from_str("4:3", "float32")

    def getOutputDim(self):
        return TensorsInfo.from_str("4:3,1", "float32,float32")

    def invoke(self, inputs):
        x = np.asarray(inputs[0])
        return [x * self.scale, np.array([x.sum()], np.float32)]
'''


@pytest.fixture
def py_scripts(tmp_path):
    paths = {}
    for tag, pkg in (("port", "nnstreamer_tpu_torch"),
                     ("jax", "nnstreamer_tpu")):
        path = tmp_path / f"scale_{tag}.py"
        path.write_text(PY_FILTER.format(pkg=pkg))
        paths[tag] = str(path)
    return paths


def test_python_filter_matches_jax(py_scripts):
    rng = np.random.default_rng(27)
    frames = [rng.standard_normal((3, 4)).astype(np.float32)
              for _ in range(3)]
    out = {}
    for tag, pkg in (("port", tnt), ("jax", jnt)):
        out[tag] = _pushed(
            pkg, "appsrc name=src ! tensor_filter framework=python "
                 f"model={py_scripts[tag]} custom=scale:3 ! "
                 "tensor_sink name=out", frames)
    assert out["port"] == out["jax"]
    first = np.frombuffer(out["port"][0][0][0], np.float32).reshape(3, 4)
    np.testing.assert_array_equal(first, frames[0] * 3)


def test_python_filter_model_info_and_auto_detect(py_scripts):
    from nnstreamer_tpu.elements.filter import detect_framework as jdetect
    from nnstreamer_tpu_torch.elements.filter import detect_framework

    f = get_subplugin(FILTER, "python")()
    f.open(FilterProperties(model=py_scripts["port"]))
    ins, outs = f.get_model_info()
    assert str(ins) == str(TensorsInfo.from_str("4:3", "float32"))
    assert len(outs) == 2
    f.close()
    assert detect_framework(py_scripts["port"]) == "python" == \
        jdetect(py_scripts["jax"])


def test_python_filter_refuses_a_script_without_the_class(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("class NotAFilter:\n    pass\n")
    f = get_subplugin(FILTER, "python")()
    with pytest.raises(ValueError, match="class Filter"):
        f.open(FilterProperties(model=str(bad)))
    with pytest.raises(ValueError, match="no such script"):
        f.open(FilterProperties(model=str(tmp_path / "missing.py")))


# -- framework=pipeline (tests/test_filter_backends_extra.py:211-250) ---------
def test_nested_pipeline():
    inner = ("appsrc name=in ! tensor_transform mode=arithmetic "
             "option=mul:3.0 ! tensor_sink name=out")
    desc = ("videotestsrc num-buffers=3 width=4 height=4 ! "
            "tensor_converter ! tensor_transform mode=typecast "
            "option=float32 ! tensor_filter framework=pipeline "
            f'model="{inner}" ! tensor_sink name=out to-host=true')
    got = _run_collect(tnt, desc)
    assert len(got) == 3
    assert got == _run_collect(jnt, desc)


def test_pipeline_filter_values_and_order():
    from nnstreamer_tpu.filters.api import FilterProperties as JProps
    from nnstreamer_tpu.filters.pipeline_filter import (
        PipelineFilter as JPipelineFilter,
    )
    from nnstreamer_tpu_torch.filters.pipeline_filter import PipelineFilter

    model = ("appsrc name=in ! tensor_transform mode=arithmetic "
             "option=add:1.0 ! tensor_sink name=out")
    f, jf = PipelineFilter(), JPipelineFilter()
    f.open(FilterProperties(model=model))
    jf.open(JProps(model=model))
    try:
        for i in range(5):
            x = np.full((2, 2), float(i), np.float32)
            (y,) = f.invoke([x])
            (jy,) = jf.invoke([x])
            assert np.allclose(np.asarray(y), x + 1.0)
            assert np.asarray(y).tobytes() == np.asarray(jy).tobytes()
    finally:
        f.close()
        jf.close()


def test_pipeline_filter_missing_ports_rejected():
    from nnstreamer_tpu_torch.filters.pipeline_filter import PipelineFilter

    with pytest.raises(ValueError):
        PipelineFilter().open(FilterProperties(model="videotestsrc ! "
                                                     "tensor_sink"))


# -- framework=native (tests/test_native_filter.py) ---------------------------
@pytest.fixture(scope="module")
def scaler_so(tmp_path_factory):
    """The example plugin of ``native/examples``, built with the flags of
    ``native/Makefile`` into a directory of this module's own, so no other
    test's build of ``native/*.so`` can rewrite it under a loaded copy."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no native toolchain")
    out = tmp_path_factory.mktemp("native") / os.path.basename(SCALER_SO)
    subprocess.run([cxx, "-O3", "-fPIC", "-std=c++17", "-shared", "-o",
                    str(out), os.path.join(NATIVE_DIR, "examples",
                                           "filter_scaler.cc")],
                   check=True, capture_output=True)
    return str(out)


def test_native_scaler_pipeline(scaler_so):
    got = _both(
        "appsrc name=src ! tensor_transform mode=typecast option=float32 ! "
        f"tensor_filter framework=native model={scaler_so} "
        "custom=scale:3.0 ! tensor_sink name=out",
        [np.arange(12, dtype=np.uint8).reshape(3, 4),
         np.ones((3, 4), np.uint8)])
    assert len(got) == 2
    np.testing.assert_allclose(
        np.frombuffer(got[0][0][0], np.float32).reshape(3, 4),
        np.arange(12, dtype=np.float32).reshape(3, 4) * 3.0)
    np.testing.assert_allclose(
        np.frombuffer(got[1][0][0], np.float32).reshape(3, 4),
        np.full((3, 4), 3.0, np.float32))


def test_native_scaler_passthrough_ints(scaler_so):
    got = _both(
        f"appsrc name=src ! tensor_filter framework=native "
        f"model={scaler_so} custom=scale:5.0 ! tensor_sink name=out",
        [np.arange(6, dtype=np.int32)])
    np.testing.assert_array_equal(np.frombuffer(got[0][0][0], np.int32),
                                  np.arange(6, dtype=np.int32))


def test_framework_auto_detects_native(scaler_so):
    got = _both(
        "appsrc name=src ! tensor_transform mode=typecast option=float32 ! "
        f"tensor_filter framework=auto model={scaler_so} name=f "
        "custom=scale:2.0 ! tensor_sink name=out",
        [np.ones((2, 2), np.uint8)])
    np.testing.assert_allclose(
        np.frombuffer(got[0][0][0], np.float32).reshape(2, 2),
        np.full((2, 2), 2.0, np.float32))


# -- framework=tflite ---------------------------------------------------------
@pytest.fixture(scope="module")
def tflite_model(tmp_path_factory):
    tf = pytest.importorskip("tensorflow")

    class Affine(tf.Module):
        def __init__(self):
            super().__init__()
            rng = np.random.default_rng(28)
            self.w = tf.constant(rng.standard_normal((4, 3)), tf.float32)
            self.b = tf.constant(rng.standard_normal((3,)), tf.float32)

        @tf.function(input_signature=[tf.TensorSpec([1, 4], tf.float32)])
        def __call__(self, x):
            return tf.nn.relu(tf.matmul(x, self.w) + self.b)

    module = Affine()
    conv = tf.lite.TFLiteConverter.from_concrete_functions(
        [module.__call__.get_concrete_function()], module)
    path = tmp_path_factory.mktemp("tflite") / "affine.tflite"
    path.write_bytes(conv.convert())
    return str(path)


@pytest.mark.parametrize("framework", ["tflite", "tensorflow-lite", "auto"])
def test_tflite_filter_matches_jax(tflite_model, framework):
    rng = np.random.default_rng(29)
    frames = [rng.standard_normal((1, 4)).astype(np.float32)
              for _ in range(4)]
    got = _both(f"appsrc name=src ! tensor_filter framework={framework} "
                f"model={tflite_model} ! tensor_sink name=out", frames)
    assert len(got) == 4
    assert got[0][0][1] == np.float32 and got[0][0][2] == (1, 3)


def test_tflite_model_info_matches_jax(tflite_model):
    from nnstreamer_tpu.filters.api import FilterProperties as JProps
    from nnstreamer_tpu.registry import get_subplugin as jget

    f = get_subplugin(FILTER, "tflite")()
    jf = jget("filter", "tflite")()
    f.open(FilterProperties(model=tflite_model))
    jf.open(JProps(model=tflite_model))
    try:
        assert [str(i) for i in f.get_model_info()] == \
            [str(i) for i in jf.get_model_info()]
    finally:
        f.close()
        jf.close()


@pytest.mark.parametrize("ext,want", [(".tflite", "tflite"),
                                      (".so", "native"), (".py", "python")])
def test_auto_detect_picks_the_jax_packages_backend(tmp_path, ext, want):
    from nnstreamer_tpu.elements.filter import detect_framework as jdetect
    from nnstreamer_tpu_torch.elements.filter import detect_framework

    path = str(tmp_path / f"model{ext}")
    assert detect_framework(path) == want == jdetect(path)
