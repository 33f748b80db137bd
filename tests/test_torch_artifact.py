"""``torch.export`` model artifacts of the PyTorch port
(``nnstreamer_tpu_torch/filters/artifact.py``), the ``.pt2`` route of the
torch backend and the CLI's ``--export``, held to the JAX package's
``tests/test_artifact.py`` (``jax.export`` StableHLO there).

An exported MobileNetV2 loaded through ``tensor_filter model=x.pt2``
equals the live module on the same frames bit for bit (the same float32
CPU kernels run); against the JAX package's exported artifact of the
same weights it agrees to the tolerance of ``test_torch_mobilenet_v2.py``
(rtol 1e-4, atol 1e-4 * max|logit|, the same top-1).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.filters import artifact as jartifact
from nnstreamer_tpu.models.mobilenet_v2 import mobilenet_v2 as jax_mobilenet_v2
from nnstreamer_tpu_torch.filters import artifact
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2, params_from_jax
from nnstreamer_tpu_torch.ops import flash_attention as fa
from nnstreamer_tpu_torch.ops.preprocess import normalize_u8
from nnstreamer_tpu_torch.ops.quantize import quantize_int8

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, CLASSES = 32, 10


@pytest.fixture(autouse=True)
def _cpu():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


@pytest.fixture(scope="module")
def mnv2():
    apply_fn, variables, in_info, _ = jax_mobilenet_v2(
        num_classes=CLASSES, image_size=SIZE, dtype=jnp.float32, seed=41)
    module = MobileNetV2(num_classes=CLASSES)
    module.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                        variables)))
    return apply_fn, variables, in_info, module.eval()


@pytest.fixture(scope="module")
def mnv2_pt2(mnv2, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pt2") / "mnv2.pt2")
    artifact.save_artifact(
        path, mnv2[3],
        in_info=tnt.TensorsInfo.from_str(f"3:{SIZE}:{SIZE}:1", "float32"))
    return path


def _frames(n=3):
    rng = np.random.default_rng(9)
    return [rng.standard_normal((1, SIZE, SIZE, 3)).astype(np.float32)
            for _ in range(n)]


def _through_filter(model, frames, extra=""):
    pipe = tnt.parse_launch(f"appsrc name=src ! tensor_filter {extra}"
                            f"model={model} ! tensor_sink name=out")
    outs = []
    pipe.get("out").connect(lambda b: outs.append(np.asarray(b[0])))
    pipe.start()
    try:
        for f in frames:
            pipe.get("src").push([f])
        pipe.get("src").end_of_stream()
        assert pipe.wait(timeout=60).kind == "eos"
    finally:
        pipe.stop()
    return outs


# -- the artifact is self-describing ---------------------------------------------
def test_self_describing_info(mnv2_pt2):
    ep = artifact.load_artifact(mnv2_pt2)
    in_info, out_info = artifact.artifact_tensors_info(ep)
    assert str(in_info) == str(tnt.TensorsInfo.from_str(
        f"3:{SIZE}:{SIZE}:1", "float32"))
    assert str(out_info) == str(tnt.TensorsInfo.from_str(
        f"{CLASSES}:1", "float32"))


@pytest.mark.parametrize("framework", ["auto", "torch", "jax"])
def test_pt2_through_tensor_filter_equals_the_live_module(mnv2, mnv2_pt2,
                                                          framework):
    frames = _frames()
    outs = _through_filter(mnv2_pt2, frames, f"framework={framework} ")
    with torch.inference_mode():
        want = [mnv2[3](torch.from_numpy(f)).numpy() for f in frames]
    assert len(outs) == len(want)
    for a, b in zip(outs, want):
        assert a.tobytes() == b.tobytes()


def test_pt2_agrees_with_the_jax_artifact(mnv2, mnv2_pt2, tmp_path):
    apply_fn, variables, in_info, _ = mnv2
    jpath = str(tmp_path / "mnv2.jaxexp")
    exp = jartifact.save_artifact(jpath, apply_fn, variables,
                                  in_info=in_info, platforms=("cpu",))
    for f in _frames(2):
        ref = np.asarray(exp.call(jnp.asarray(f)))
        got = artifact.load_artifact(mnv2_pt2).module()(
            torch.from_numpy(f)).detach().numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(ref).max()))
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


class _Scaled(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.arange(4.0), requires_grad=False)

    def forward(self, x):
        return x * self.w


class _TwoOut(torch.nn.Module):
    def forward(self, x):
        return x + 1, (x * 2).to(torch.int32)


def test_weights_ride_inside_the_artifact(tmp_path):
    path = str(tmp_path / "scaled.pt2")
    module = _Scaled()
    artifact.save_artifact(path, module, example_inputs=[np.ones(4,
                                                                 np.float32)])
    module.w.data.fill_(0)  # the file keeps the weights it was saved with
    out = artifact.load_artifact(path).module()(torch.ones(4))
    np.testing.assert_array_equal(out.numpy(), np.arange(4.0))


def test_multi_output(tmp_path):
    path = str(tmp_path / "two.pt2")
    artifact.save_artifact(path, _TwoOut(),
                           in_info=tnt.TensorsInfo.from_str("3:2", "float32"))
    _, out_info = artifact.artifact_tensors_info(artifact.load_artifact(path))
    assert [str(t.type.value) for t in out_info] == ["float32", "int32"]
    outs = _through_filter(path, [np.ones((2, 3), np.float32)])
    np.testing.assert_array_equal(outs[0], np.full((2, 3), 2.0))


# -- the export tool ----------------------------------------------------------------
def test_export_model_from_a_pt_file(tmp_path):
    src = str(tmp_path / "scaled.pt")
    torch.save(_Scaled(), src)
    out = str(tmp_path / "scaled.pt2")
    info = artifact.export_model(src, out, input_dims="4:2",
                                 input_types="float32")
    assert str(info) == str(tnt.TensorsInfo.from_str("4:2", "float32"))
    res = artifact.load_artifact(out).module()(torch.ones(2, 4))
    np.testing.assert_array_equal(res.numpy(), np.tile(np.arange(4.0),
                                                       (2, 1)))
    with pytest.raises(ValueError, match="no input info"):
        artifact.export_model(src, out)


def test_export_a_registered_model_keeps_its_declared_types(mnv2, tmp_path):
    register_torch_model(
        "art_mnv2", mnv2[3],
        tnt.TensorsInfo.from_str(f"3:{SIZE}:{SIZE}:1", "float32"),
        tnt.TensorsInfo.from_str(f"{CLASSES}:1", "float32"))
    try:
        out = str(tmp_path / "b2.pt2")
        info = artifact.export_model("art_mnv2", out,
                                     input_dims=f"3:{SIZE}:{SIZE}:2")
    finally:
        unregister_torch_model("art_mnv2")
    assert str(info) == str(tnt.TensorsInfo.from_str(f"{CLASSES}:2",
                                                     "float32"))


def test_cli_export(tmp_path):
    src = str(tmp_path / "linear.pt")
    # a class the CLI's process can unpickle
    torch.save(torch.nn.Linear(4, 3), src)
    out = str(tmp_path / "cli.pt2")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch.cli", "--export", src,
         out, "--input", "4:1", "--inputtype", "float32"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "Exported" in proc.stdout and os.path.isfile(out)
    assert "3:1 float32" in proc.stdout
    bad = subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch.cli", "--input", "4:1",
         "videotestsrc ! tensor_sink"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert bad.returncode != 0 and "--export" in bad.stderr


# -- what the torch backend refuses ----------------------------------------------------
class _Attends(torch.nn.Module):
    def forward(self, q):
        return fa.flash_attention(q, q, q, causal=True)


class _Normalizes(torch.nn.Module):
    def forward(self, x):
        return normalize_u8(x, out_dtype=torch.float32)


class _Quantizes(torch.nn.Module):
    def forward(self, x):
        return quantize_int8(x)[0]


@pytest.mark.parametrize("module,x,kernel", [
    (_Attends(), torch.zeros(1, 8, 2, 16), "B2 flash attention"),
    (_Normalizes(), torch.zeros(2, 4, dtype=torch.uint8), "B1 normalize"),
    (_Quantizes(), torch.zeros(8), "B3 int8 quantize"),
])
def test_a_model_that_reaches_a_kernel_is_not_exported(module, x, kernel,
                                                       tmp_path):
    """The plain version is never exported in the kernel's place."""
    path = str(tmp_path / "k.pt2")
    with pytest.raises(ValueError, match=kernel):
        artifact.save_artifact(path, module, example_inputs=[x])
    assert not os.path.exists(path)
    module(x)  # outside an export the wrapper runs (its plain version)


@pytest.mark.parametrize("name", ["m.stablehlo", "m.mlir", "m.mlirbc",
                                  "m.jaxexp", "m.pb"])
def test_stablehlo_and_tf_models_raise_naming_a23(tmp_path, name):
    path = tmp_path / name
    path.write_bytes(b"module {}")
    with pytest.raises(ValueError, match="A.23"):
        tnt.parse_launch(f"appsrc ! tensor_filter model={path} ! "
                         "tensor_sink").start()


def test_savedmodel_dir_raises_naming_a23(tmp_path):
    (tmp_path / "saved_model.pb").write_bytes(b"\0")
    with pytest.raises(ValueError, match="A.23"):
        tnt.parse_launch(f"appsrc ! tensor_filter framework=torch "
                         f"model={tmp_path} ! tensor_sink").start()


def test_garbage_artifact(tmp_path):
    path = tmp_path / "junk.pt2"
    path.write_bytes(b"\x00\x01 not an archive")
    with pytest.raises(ValueError, match="cannot load model artifact"):
        artifact.load_artifact(str(path))
