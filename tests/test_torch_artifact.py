"""``torch.export`` model artifacts of the PyTorch port
(``nnstreamer_tpu_torch/filters/artifact.py``), the ``.pt2`` route of the
torch backend and the CLI's ``--export``, held to the JAX package's
``tests/test_artifact.py`` (``jax.export`` StableHLO there).

An exported MobileNetV2 loaded through ``tensor_filter model=x.pt2``
equals the live module on the same frames bit for bit (the same float32
CPU kernels run); against the JAX package's exported artifact of the
same weights it agrees to the tolerance of ``test_torch_mobilenet_v2.py``
(rtol 1e-4, atol 1e-4 * max|logit|, the same top-1). A model that
reaches a kernel wrapper exports with the wrapper's ``nnstpu`` op in its
graph (ROADMAP C.26, closed); a ``.pb`` or a SavedModel runs through the
TensorFlow backend; StableHLO stays refused (C.24).
"""

import operator
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
from nnstreamer_tpu_torch.ops.preprocess import normalize_chain, normalize_u8
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


# -- models that reach a kernel export with its op (C.26) -------------------------
class _Attends(torch.nn.Module):
    def forward(self, q):
        return fa.flash_attention(q, q, q, causal=True)


class _Normalizes(torch.nn.Module):
    def forward(self, x):
        return normalize_u8(x, out_dtype=torch.float32)


class _Quantizes(torch.nn.Module):
    def __init__(self, force=None, seed=0):
        super().__init__()
        self.force, self.seed = force, seed

    def forward(self, x):
        return quantize_int8(x, seed=self.seed, force=self.force)


def _kernel_inputs(seed=3):
    rng = np.random.default_rng(seed)
    return {
        "flash_attention": rng.normal(size=(1, 24, 2, 16)).astype(
            np.float32),
        "normalize_chain": rng.integers(0, 256, (2, 8, 8, 3),
                                        dtype=np.uint8),
        "quantize_int8": (rng.normal(size=(4099,)) * 3).astype(np.float32),
    }


_KERNEL_MODULES = {"flash_attention": _Attends, "normalize_chain":
                   _Normalizes, "quantize_int8": _Quantizes}


def _ops_in(ep):
    return [str(n.target) for n in ep.graph.nodes
            if n.op == "call_function" and n.target is not operator.getitem]


def _as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name", sorted(_KERNEL_MODULES))
def test_a_model_that_reaches_a_kernel_exports_its_op(name, tmp_path):
    """The exported graph holds the wrapper's ``nnstpu`` op alone, not the
    plain version's ATen ops; loaded, it equals the live module bit for
    bit (the op's CPU implementation is the wrapper's plain version)."""
    x = torch.from_numpy(_kernel_inputs()[name])
    module = _KERNEL_MODULES[name]()
    path = str(tmp_path / f"{name}.pt2")
    ep = artifact.save_artifact(path, module, example_inputs=[x])
    assert _ops_in(ep) == [f"nnstpu.{name}.default"]
    loaded = artifact.load_artifact(path)
    assert _ops_in(loaded) == [f"nnstpu.{name}.default"]
    got, want = _as_list(loaded.module()(x)), _as_list(module(x))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.numpy().tobytes() == b.numpy().tobytes()


def test_exported_kernels_match_the_jax_functions(tmp_path):
    """The loaded programs against the JAX package's functions: B1 and B2
    to float32 tolerance (B1 rounds once from the same fp32 value, 1e-6
    for the division's order; B2 the plain attention of both packages,
    ``tests/test_torch_flash_attention.py``'s 1e-5), B3 nearest bit for
    bit."""
    from nnstreamer_tpu.ops import flash_attention as jax_flash
    from nnstreamer_tpu.ops import normalize_u8 as jax_normalize_u8
    from nnstreamer_tpu.ops.quantize import quantize_int8 as jax_quantize

    xs = _kernel_inputs(7)
    outs = {}
    for name, cls in _KERNEL_MODULES.items():
        x = torch.from_numpy(xs[name])
        path = str(tmp_path / f"{name}.pt2")
        artifact.save_artifact(path, cls(), example_inputs=[x])
        outs[name] = _as_list(artifact.load_artifact(path).module()(x))
    q = jnp.asarray(xs["flash_attention"])
    np.testing.assert_allclose(
        outs["flash_attention"][0].numpy(),
        np.asarray(jax_flash(q, q, q, causal=True)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        outs["normalize_chain"][0].numpy(),
        np.asarray(jax_normalize_u8(jnp.asarray(xs["normalize_chain"]),
                                    out_dtype=jnp.float32)),
        rtol=1e-6, atol=1e-6)
    jq, js = jax_quantize(jnp.asarray(xs["quantize_int8"]),
                          force="reference")
    assert outs["quantize_int8"][0].numpy().tobytes() == \
        np.asarray(jq).tobytes()
    assert outs["quantize_int8"][1].numpy().tobytes() == \
        np.asarray(js).tobytes()


def test_exported_dither_keeps_its_mode_and_seed(tmp_path):
    """``force="dither"`` and the seed ride in the graph: the loaded
    program gives the live wrapper's q bit for bit, and it is unbiased as
    the JAX package's dithered quantize is (C.7: the bits differ, the
    distribution agrees; ``tests/test_torch_quantize.py``'s 0.3-step
    case)."""
    n = 65536
    x = np.full(n + 1, 0.003, np.float32)
    x[0] = 1.27  # the scale is 0.01: nearest rounds the rest to 0
    module = _Quantizes(force="dither", seed=2 ** 63 + 5)
    path = str(tmp_path / "dither.pt2")
    ep = artifact.save_artifact(path, module, example_inputs=[x])
    node = next(n for n in ep.graph.nodes
                if str(n.target) == "nnstpu.quantize_int8.default")
    assert node.args[2] == "dither"
    q, s = artifact.load_artifact(path).module()(torch.from_numpy(x))
    want_q, want_s = quantize_int8(torch.from_numpy(x), seed=2 ** 63 + 5,
                                   force="dither")
    assert q.numpy().tobytes() == want_q.numpy().tobytes()
    assert torch.equal(s, want_s)
    assert abs(float(q[1:].double().mean()) - 0.3) <= 0.01


def test_an_exported_chain_keeps_negative_zero(tmp_path):
    """The chain's values cross the file as they are: dividing by -0.0
    gives -inf, as the live call does."""

    class DivByNegZero(torch.nn.Module):
        def forward(self, x):
            return normalize_chain(x, [("add", 1.0), ("div", -0.0)])

    x = torch.arange(4, dtype=torch.uint8)
    path = str(tmp_path / "negzero.pt2")
    artifact.save_artifact(path, DivByNegZero(), example_inputs=[x])
    out = artifact.load_artifact(path).module()(x)
    assert torch.equal(out, torch.full((4,), -float("inf")))


def test_the_kernel_programs_load_in_a_fresh_process(tmp_path):
    """A new interpreter that imports only ``filters.artifact`` loads each
    program (the import registers the ``nnstpu`` ops) and reproduces the
    live module's bytes."""
    xs = _kernel_inputs(11)
    lines = []
    for name, cls in _KERNEL_MODULES.items():
        x = torch.from_numpy(xs[name])
        path = str(tmp_path / f"{name}.pt2")
        artifact.save_artifact(path, cls(), example_inputs=[x])
        np.save(str(tmp_path / f"{name}.npy"), xs[name])
        want = b"".join(o.numpy().tobytes() for o in _as_list(cls()(x)))
        lines.append((name, want.hex()))
    code = (
        "import sys, numpy as np, torch\n"
        "from nnstreamer_tpu_torch.filters import artifact\n"
        "d = sys.argv[1]\n"
        "for name in sys.argv[2:]:\n"
        "    x = torch.from_numpy(np.load(f'{d}/{name}.npy'))\n"
        "    out = artifact.load_artifact(f'{d}/{name}.pt2').module()(x)\n"
        "    out = list(out) if isinstance(out, (tuple, list)) else [out]\n"
        "    print(name, b''.join(o.numpy().tobytes() for o in out).hex())\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'nnstreamer_tpu')]\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path), *_KERNEL_MODULES],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert [tuple(ln.split()) for ln in proc.stdout.splitlines()] == lines


def test_a_kernel_program_through_tensor_filter(tmp_path):
    """``tensor_filter model=x.pt2`` on a program holding
    ``nnstpu::normalize_chain``: the frames' normalized values, as the
    live wrapper gives them; the shapes probe on the meta device through
    the op's fake implementation."""
    frames = [np.random.default_rng(i).integers(0, 256, (1, 4, 4, 3),
                                                dtype=np.uint8)
              for i in range(3)]
    path = str(tmp_path / "norm.pt2")
    artifact.save_artifact(path, _Normalizes(), in_info=tnt.TensorsInfo
                           .from_str("3:4:4:1", "uint8"))
    outs = _through_filter(path, frames, "framework=torch ")
    for got, f in zip(outs, frames):
        want = normalize_u8(torch.from_numpy(f), out_dtype=torch.float32)
        assert got.tobytes() == want.numpy().tobytes()


def test_the_cli_exports_a_model_that_reaches_a_kernel(tmp_path):
    """``--export`` of a pickled module whose forward calls
    ``normalize_u8`` (a class both processes import from ``tmp_path``)."""
    (tmp_path / "normmod.py").write_text(
        "import torch\n"
        "from nnstreamer_tpu_torch.ops.preprocess import normalize_u8\n"
        "class Norm(torch.nn.Module):\n"
        "    def forward(self, x):\n"
        "        return normalize_u8(x, out_dtype=torch.float32)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), REPO])
    src, out = str(tmp_path / "norm.pt"), str(tmp_path / "norm.pt2")
    for argv in (["-c", "import sys, torch, normmod; "
                  "torch.save(normmod.Norm(), sys.argv[1])", src],
                 ["-m", "nnstreamer_tpu_torch.cli", "--export", src, out,
                  "--input", "3:4:4:1", "--inputtype", "uint8"]):
        proc = subprocess.run([sys.executable, *argv], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
    assert _ops_in(artifact.load_artifact(out)) == \
        ["nnstpu.normalize_chain.default"]


@pytest.mark.parametrize("name", ["m.stablehlo", "m.mlir", "m.mlirbc",
                                  "m.jaxexp"])
def test_stablehlo_models_raise_naming_c24(tmp_path, name):
    path = tmp_path / name
    path.write_bytes(b"module {}")
    with pytest.raises(ValueError, match="C.24"):
        tnt.parse_launch(f"appsrc ! tensor_filter model={path} ! "
                         "tensor_sink").start()


def _tf_models(tmp_path):
    """A SavedModel and its frozen ``.pb``, as ``tests/test_tf_backend.py``
    writes them: ``y = x @ W + 1``."""
    tf = pytest.importorskip("tensorflow")
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    w = np.arange(12, dtype=np.float32).reshape(3, 4)

    class M(tf.Module):
        def __init__(self):
            self.w = tf.Variable(tf.constant(w))

        @tf.function(input_signature=[tf.TensorSpec([2, 3], tf.float32)])
        def __call__(self, x):
            return {"y": tf.matmul(x, self.w) + 1.0}

    sm = tmp_path / "sm"
    tf.saved_model.save(M(), str(sm))
    loaded = tf.saved_model.load(str(sm))  # alive while frozen reads it
    frozen = convert_variables_to_constants_v2(
        loaded.signatures["serving_default"])
    tf.io.write_graph(frozen.graph.as_graph_def(), str(tmp_path), "m.pb",
                      as_text=False)
    names = (f"inputname:{frozen.inputs[0].name.split(':')[0]},"
             f"outputname:{frozen.outputs[0].name.split(':')[0]}")
    return str(sm), str(tmp_path / "m.pb"), names, w


def test_a_frozen_pb_runs(tmp_path):
    _, pb, names, w = _tf_models(tmp_path)
    x = np.random.default_rng(0).normal(size=(2, 3)).astype(np.float32)
    (out,) = _through_filter(pb, [x], f"framework=torch custom={names} ")
    np.testing.assert_allclose(out, x @ w + 1.0, rtol=1e-5)


def test_a_savedmodel_dir_runs(tmp_path):
    sm, _, _, w = _tf_models(tmp_path)
    x = np.random.default_rng(1).normal(size=(2, 3)).astype(np.float32)
    (out,) = _through_filter(sm, [x], "framework=torch ")
    np.testing.assert_allclose(out, x @ w + 1.0, rtol=1e-5)


def test_garbage_artifact(tmp_path):
    path = tmp_path / "junk.pt2"
    path.write_bytes(b"\x00\x01 not an archive")
    with pytest.raises(ValueError, match="cannot load model artifact"):
        artifact.load_artifact(str(path))
