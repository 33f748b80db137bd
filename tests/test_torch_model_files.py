"""The model files the JAX backend loads, on the port, held to the JAX
package on the same seeded numpy inputs:

- ``utils/flax_msgpack``: the port's writer gives the bytes of
  ``flax.serialization.to_bytes`` for the same tree (MobileNetV2's
  variables, the LM's params, a bfloat16 tree, a chunked array); the JAX
  ``load_params`` reads the port's file equal, and the port reads the
  JAX package's file equal.
- ``tensor_filter model=<f>.msgpack custom=module:<factory>``: the LM
  case of ``tests/test_aux_subsystems.py`` (the file's vocab wins) within
  1e-5 of the JAX ``SingleShot`` in fp32; a narrow MobileNetV2 through the
  fused flagship string, labels equal to the JAX filter's and scores
  within the flagship's fp32 tolerance; bit-identical to the registered
  module with the same weights.
- ``<f>.py`` with ``get_model()``: the cases of ``tests/test_elements.py``
  and ``tests/test_artifact.py``, with the port's ``.pt2`` in place of
  ``.jaxexp``.
- The JAX loader's errors: no ``module:``, an unknown factory, a shape no
  factory argument fits.
- A ``.pt2`` exported at batch 8 under ``mesh=dp2``, ``dp-1`` and
  ``dp8``, equal to unmeshed and to the JAX filter serving the
  ``.jaxexp`` of the same function under ``mesh=dp2``; a static batch the
  mesh would split raises at ``start()`` (ROADMAP C.58).
"""

import functools
import importlib
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu import models as jax_models
from nnstreamer_tpu.filters.artifact import export_model as jax_export_model
from nnstreamer_tpu.models.mobilenet_v2 import mobilenet_v2 as jax_mobilenet_v2
from nnstreamer_tpu.models.transformer import TransformerConfig, init_params
from nnstreamer_tpu.single import SingleShot as JaxSingleShot
from nnstreamer_tpu.utils import checkpoint as jax_checkpoint
from nnstreamer_tpu_torch import models as tmodels
from nnstreamer_tpu_torch.elements.filter import detect_framework
from nnstreamer_tpu_torch.filters import torch_backend as tb
from nnstreamer_tpu_torch.filters.artifact import (
    export_model,
    load_artifact,
    program_batches,
    save_artifact,
)
from nnstreamer_tpu_torch.models import transformer as ttr
from nnstreamer_tpu_torch.single import SingleShot
from nnstreamer_tpu_torch.utils import checkpoint, flax_msgpack

# the module (the package re-exports its factory under the same name)
tmnv2 = importlib.import_module("nnstreamer_tpu_torch.models.mobilenet_v2")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, CLASSES, WIDTH, FRAMES = 96, 10, 0.35, 4
#: a zoo file's factory declares 224×224 frames; these are SIZE×SIZE
AT_SIZE = f"input=3:{SIZE}:{SIZE}:1 inputtype=float32 "


@pytest.fixture(autouse=True)
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)
    tnt.set_host_device_count(1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _equal_trees(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb_ = jax.tree_util.tree_flatten(b)
    assert ta == tb_
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def _narrow_mnv2(dtype=jnp.float32, seed=11):
    return jax_mobilenet_v2(num_classes=CLASSES, width=WIDTH,
                            image_size=SIZE, dtype=dtype, seed=seed)


def _lm_params():
    cfg = TransformerConfig(vocab=32, d_model=16, n_heads=2, n_layers=1,
                            d_ff=32, dtype=jnp.float32)
    return _np(init_params(cfg, seed=3))


# -- the bytes -----------------------------------------------------------------
def _trees():
    rng = np.random.default_rng(7)
    bf16 = {"w": rng.standard_normal((5, 7)).astype(ml_dtypes.bfloat16),
            "nested": {"b": np.arange(9, dtype=np.float32)
                       .astype(ml_dtypes.bfloat16), "n": np.int32(4)}}
    return {"mobilenet_v2": _np(_narrow_mnv2()[1]), "lm": _lm_params(),
            "bf16": bf16}


@pytest.mark.parametrize("name", ["mobilenet_v2", "lm", "bf16"])
def test_writer_gives_flax_bytes_and_both_readers_agree(tmp_path, name):
    tree = _trees()[name]
    want = serialization.to_bytes(tree)
    assert flax_msgpack.to_bytes(tree) == want
    # the port's file through the JAX loader, the JAX file through the port
    ours, theirs = tmp_path / "ours.msgpack", tmp_path / "theirs.msgpack"
    checkpoint.save_params(tree, str(ours))
    jax_checkpoint.save_params(tree, str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    _equal_trees(jax_checkpoint.load_params(tree, str(ours)), tree)
    got = checkpoint.load_params(None, str(theirs))
    _equal_trees(jax.tree.map(
        lambda x: x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        if isinstance(x, torch.Tensor) else x, got), tree)


def test_bf16_comes_back_as_a_torch_tensor(tmp_path):
    tree = _trees()["bf16"]
    got = flax_msgpack.from_bytes(serialization.to_bytes(tree))
    assert got["w"].dtype == torch.bfloat16 and got["w"].shape == (5, 7)
    assert torch.equal(got["w"].float(),
                       torch.from_numpy(tree["w"].astype(np.float32)))
    # a tensor leaf writes as the numpy tree does
    as_tensors = {"w": got["w"], "nested": {"b": got["nested"]["b"],
                                            "n": np.int32(4)}}
    assert flax_msgpack.to_bytes(as_tensors) == serialization.to_bytes(tree)


def test_a_chunked_array(monkeypatch):
    from flax import serialization as fs

    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(2)
    tree = {"big": rng.standard_normal((10, 7)).astype(np.float32),
            "bf": np.arange(100, dtype=np.float32).astype(ml_dtypes.bfloat16),
            "small": np.ones(3)}
    data = fs.to_bytes(tree)
    assert flax_msgpack.to_bytes(tree) == data
    got = flax_msgpack.from_bytes(data)
    assert np.array_equal(got["big"], tree["big"])
    assert got["bf"].dtype == torch.bfloat16 and got["bf"].shape == (100,)
    _equal_trees(fs.msgpack_restore(data)["small"], got["small"])


def test_load_params_restores_into_the_template_and_the_files_shapes_win(
        tmp_path):
    path = str(tmp_path / "p.msgpack")
    jax_checkpoint.save_params({"a": np.ones((2, 3), np.float32),
                                "b": [np.zeros(4, np.int8)]}, path)
    got = checkpoint.load_params({"a": np.zeros(1), "b": [None]}, path)
    assert got["a"].shape == (2, 3) and isinstance(got["b"], list)
    with pytest.raises(ValueError, match="target dict keys"):
        checkpoint.load_params({"c": 0}, path)


def test_params_to_jax_round_trips_mobilenet_and_the_lm(tmp_path):
    """The port writes checkpoints the JAX package loads: MobileNetV2's
    state through ``params_to_jax`` equals the JAX variables it came from,
    and so do the LM's params."""
    variables = _np(_narrow_mnv2()[1])
    module = tmnv2.MobileNetV2(num_classes=CLASSES, width=WIDTH)
    module.load_state_dict(tmnv2.params_from_jax(variables))
    path = str(tmp_path / "m.msgpack")
    checkpoint.save_params(tmnv2.params_to_jax(module), path)
    _equal_trees(jax_checkpoint.load_params(variables, path), variables)

    params = _lm_params()
    lm = ttr.TransformerLM(ttr.TransformerConfig(
        vocab=32, d_model=16, n_heads=2, n_layers=1, d_ff=32,
        dtype=torch.float32), ttr.params_from_jax(params))
    path = str(tmp_path / "lm.msgpack")
    checkpoint.save_params(ttr.params_to_jax(lm), path)
    _equal_trees(jax_checkpoint.load_params(params, path), params)


# -- .msgpack through the filter ---------------------------------------------
def _fp32_factories(monkeypatch, **jax_kw):
    """Both zoos' factories at fp32 (the JAX loader calls its factory with
    no arguments; ``jax_kw`` gives it the shapes it cannot read from the
    file)."""
    monkeypatch.setattr(jax_models, "transformer_lm", functools.partial(
        jax_models.transformer_lm, dtype=jnp.float32))
    monkeypatch.setattr(jax_models, "mobilenet_v2", functools.partial(
        jax_models.mobilenet_v2, dtype=jnp.float32, **jax_kw))
    for name, kw in (("transformer_lm", {}),
                     ("mobilenet_v2", {"image_size": SIZE})):
        zoo = tmodels.FACTORIES[name]
        monkeypatch.setitem(tmodels.FACTORIES, name, zoo._replace(
            factory=functools.partial(zoo.factory, dtype=torch.float32,
                                      **kw)))


def _jax_lm_file(tmp_path):
    """``tests/test_aux_subsystems.py``'s file: the JAX factory's params at
    vocab 32, written by the JAX package."""
    _, params, _, _ = jax_models.transformer_lm(
        vocab=32, d_model=16, n_heads=2, n_layers=1, d_ff=32, seq=8,
        dtype=jnp.float32)
    path = str(tmp_path / "lm.msgpack")
    jax_checkpoint.save_params(params, path)
    return path


def test_lm_msgpack_follows_the_files_vocab(tmp_path):
    """The port's counterpart of ``test_msgpack_model_via_filter``: the
    factory's default (vocab 32000, bf16) is overridden by the file's
    shapes."""
    path = _jax_lm_file(tmp_path)
    s = SingleShot(framework="jax", model=path,
                   custom="module:transformer_lm")
    out = s.invoke([np.zeros((1, 8), np.int32)])
    assert tuple(out[0].shape) == (1, 8, 32)
    s.close()


def test_lm_msgpack_equals_the_jax_singleshot_in_fp32(tmp_path,
                                                      monkeypatch):
    _fp32_factories(monkeypatch)
    path = _jax_lm_file(tmp_path)
    tokens = np.random.default_rng(4).integers(0, 32, (1, 8), np.int32)
    with JaxSingleShot(framework="jax", model=path,
                       custom="module:transformer_lm") as s:
        want = np.asarray(s.invoke([tokens])[0])
    with SingleShot(framework="jax", model=path,
                    custom="module:transformer_lm") as s:
        got = s.invoke([tokens])[0].numpy()
    assert got.shape == want.shape == (1, 8, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _flagship(model: str, labels: str, extra: str = "") -> str:
    return (f"videotestsrc num-buffers={FRAMES} width={SIZE} height={SIZE} "
            "pattern=ball ! tensor_converter ! "
            "tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! "
            f"tensor_filter framework=jax model={model} {extra}! "
            f"tensor_decoder mode=image_labeling option1={labels} ! "
            "queue max-size-buffers=32 prefetch-host=true ! "
            "tensor_sink name=out to-host=true")


def _run(pkg, desc):
    pipe = pkg.parse_launch(desc)
    metas = []
    pipe.get("out").connect(lambda buf: metas.append(buf.meta))
    msg = pipe.run(timeout=120)
    assert msg is not None and msg.kind == "eos", msg
    return pipe, metas


@pytest.fixture
def labels(tmp_path):
    path = tmp_path / "labels.txt"
    path.write_text("".join(f"label_{i}\n" for i in range(CLASSES)))
    return str(path)


def test_narrow_mobilenet_msgpack_through_the_flagship_matches_jax(
        tmp_path, labels, monkeypatch):
    """Width 0.35 at 96×96: the port reads the width and the class count
    from the file; the JAX loader, which builds its factory's defaults
    (width 1.0) and refuses the file's shapes, is given a factory with
    the narrow arguments."""
    _fp32_factories(monkeypatch, width=WIDTH, num_classes=CLASSES,
                    image_size=SIZE)
    path = str(tmp_path / "mnv2.msgpack")
    jax_checkpoint.save_params(_narrow_mnv2()[1], path)
    custom = "custom=module:mobilenet_v2 "
    _, ref = _run(jnt, _flagship(path, labels, custom))
    pipe, got = _run(tnt, _flagship(path, labels, custom))
    assert pipe._regions, "the .msgpack model did not fuse"
    assert len(got) == len(ref) == FRAMES
    assert [m["label"] for m in got] == [m["label"] for m in ref]
    assert [m["label_index"] for m in got] == [m["label_index"] for m in ref]
    ref_scores = np.array([m["score"] for m in ref])
    np.testing.assert_allclose([m["score"] for m in got], ref_scores,
                               rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref_scores).max()))


def test_msgpack_is_bit_identical_to_the_registered_module(tmp_path,
                                                           labels):
    """The port's own checkpoint (``params_to_jax``, bf16 leaves) served
    by ``custom=module:mobilenet_v2`` at the factory's default dtype
    gives the registered module's labels, indices and scores exactly."""
    module, in_info, out_info = tmodels.mobilenet_v2(
        num_classes=CLASSES, width=WIDTH, image_size=SIZE, seed=5)
    path = str(tmp_path / "mnv2_bf16.msgpack")
    checkpoint.save_params(tmnv2.params_to_jax(module), path)
    tree = flax_msgpack.from_bytes(open(path, "rb").read())
    assert tree["params"]["Conv_0"]["kernel"].dtype == torch.bfloat16
    tb.register_torch_model("files_mnv2", module, in_info, out_info)
    try:
        _, want = _run(tnt, _flagship("files_mnv2", labels))
        got_pipe, got = _run(tnt, _flagship(
            path, labels, "custom=module:mobilenet_v2 " + AT_SIZE))
    finally:
        tb.unregister_torch_model("files_mnv2")
    assert got_pipe._regions
    assert [(m["label"], m["label_index"], m["score"]) for m in got] == \
        [(m["label"], m["label_index"], m["score"]) for m in want]


def _batched(model: str, labels: str, extra: str = "") -> str:
    """Four frames in one window through an appsrc (the mesh splits the
    window's rows)."""
    return ("appsrc name=src ! tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! "
            f"tensor_filter framework=jax model={model} name=filter "
            f"{extra}! tensor_decoder mode=image_labeling "
            f"option1={labels} option2=batched ! "
            "tensor_sink name=out to-host=true")


def _windows(n):
    rng = np.random.default_rng(9)
    return [rng.integers(0, 256, (FRAMES, SIZE, SIZE, 3), np.uint8)
            for _ in range(n)]


def _pushed_windows(desc, windows, swap=None, acct=None):
    """The windows through ``desc``; ``swap`` (a state dict) swapped in
    with ``swap_model`` after the first. Returns the pipeline, the
    ``(label index, score)`` rows and, with an accountant, its units at
    EOS (before ``stop()`` retires them)."""
    pipe = tnt.parse_launch(desc)
    metas = []
    pipe.get("out").connect(lambda buf: metas.append(buf.meta))
    pipe.start()
    try:
        pipe.get("src").push([windows[0]])
        if swap is not None:
            while not metas:
                pipe.wait(timeout=0.01)
            pipe.swap_model("filter", weights=swap)
        for w in windows[1:]:
            pipe.get("src").push([w])
        pipe.get("src").end_of_stream()
        msg = pipe.wait(timeout=120)
        units = acct.snapshot()["units"] if acct is not None else None
    finally:
        pipe.stop()
    assert msg is not None and msg.kind == "eos", msg
    return pipe, [(m["label_index"], m["score"]) for m in metas], units


def test_msgpack_model_under_a_budget_a_mesh_and_a_swap(tmp_path, labels):
    """A ``.msgpack`` model is served as a registered one: under the HBM
    accountant (one residency unit a shard under ``mesh=dp2``), over the
    mesh, and through ``swap_model``, each equal to the registered
    modules with the same weights."""
    from nnstreamer_tpu_torch.tensors import memory

    first, _, _ = tmodels.mobilenet_v2(num_classes=CLASSES, width=WIDTH,
                                       image_size=SIZE, seed=5)
    second, _, _ = tmodels.mobilenet_v2(num_classes=CLASSES, width=WIDTH,
                                        image_size=SIZE, seed=6)
    path = str(tmp_path / "first.msgpack")
    checkpoint.save_params(tmnv2.params_to_jax(first), path)
    windows = _windows(2)
    tb.register_torch_model("files_first", first)
    tb.register_torch_model("files_second", second)
    try:
        _, want_first, _ = _pushed_windows(_batched("files_first", labels),
                                        windows)
        _, want_second, _ = _pushed_windows(_batched("files_second", labels),
                                         windows)
    finally:
        tb.unregister_torch_model("files_first")
        tb.unregister_torch_model("files_second")
    file_model = _batched(path, labels, "custom=module:mobilenet_v2 "
                          f"input=3:{SIZE}:{SIZE}:{FRAMES} "
                          "inputtype=float32 ")
    tnt.set_host_device_count(2)
    acct = memory.activate(1 << 30)
    try:
        pipe, got, units = _pushed_windows(file_model.replace(
            "name=filter ", "name=filter mesh=dp2 "), windows, acct=acct)
    finally:
        memory.deactivate()
    assert got == want_first
    assert sorted(u["label"] for u in units) == [f"{path}#shard0",
                                                 f"{path}#shard1"]
    assert pipe._regions
    _, got, _ = _pushed_windows(file_model, windows,
                                swap=second.state_dict())
    # a row a window: the first before the swap, the second after
    assert got[0] == want_first[0] and got[1] == want_second[1]
    assert want_first[1] != want_second[1]


@pytest.mark.parametrize("name,kwargs", [
    ("ssd_mobilenet", dict(num_classes=7, image_size=64)),
    ("posenet", dict(image_size=33)),
    ("lstm_cell", dict(input_dim=6, hidden=5)),
    ("yolo_detector", dict(num_classes=4, image_size=64)),
    ("segmenter", dict(num_classes=5, base=8, image_size=32)),
])
def test_every_zoo_factory_loads_the_jax_file(tmp_path, name, kwargs):
    """Each factory of the table loads a JAX-written file of its model at
    the file's shapes; its outputs equal the same weights through
    ``params_from_jax`` into a module built with those shapes."""
    _, variables, _, _ = getattr(jax_models, name)(dtype=jnp.float32,
                                                   **kwargs)
    path = str(tmp_path / f"{name}.msgpack")
    jax_checkpoint.save_params(variables, path)
    entry = tb.resolve_python_model(path, f"module:{name}")
    zoo = tmodels.FACTORIES[name]
    state = zoo.params_from_jax(_np(variables))
    args = zoo.args_from_state(state)
    for k in ("num_classes", "input_dim", "hidden", "base"):
        if k in kwargs:
            assert args[k] == kwargs[k]
    want = zoo.factory(**args)[0]
    want.load_state_dict(state)
    got = entry["module"]
    for k, v in want.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k


# -- .py models ------------------------------------------------------------------
def test_py_file_model(tmp_path):
    """``tests/test_elements.py::test_py_file_model`` on the port."""
    model = tmp_path / "addone.py"
    model.write_text("import torch\n"
                     "def get_model():\n"
                     "    return lambda x: x + 1\n")
    s = SingleShot(framework="jax", model=str(model))
    out = s.invoke([np.zeros((2, 2), np.float32)])
    np.testing.assert_array_equal(np.asarray(out[0]), np.ones((2, 2)))
    s.close()


def test_py_file_model_with_params_and_a_module(tmp_path):
    model = tmp_path / "affine.py"
    model.write_text(
        "import numpy as np, torch\n"
        "from nnstreamer_tpu_torch.tensors.types import TensorsInfo\n"
        "IN_INFO = TensorsInfo.from_str('3:2', 'float32')\n"
        "def get_model():\n"
        "    p = {'w': np.full((3, 4), 0.5, np.float32), 'b': [1.0]}\n"
        "    return (lambda p, x: x @ p['w'] + p['b'][0]), p\n")
    entry = tb.resolve_python_model(str(model), None)
    assert isinstance(entry["module"], tb.PythonModel)
    assert entry["in_info"].dims_str() == "3:2"
    assert sorted(dict(entry["module"].named_buffers())) == ["p0"]
    with SingleShot(framework="torch", model=str(model)) as s:
        (y,) = s.invoke([np.ones((2, 3), np.float32)])
    np.testing.assert_allclose(y.numpy(), 2.5)


def test_framework_auto_detect(tmp_path):
    """``.py`` resolves as the JAX package's ``detect_framework`` resolves
    it; ``.msgpack`` goes to the torch backend (which answers to
    ``framework=jax``)."""
    from nnstreamer_tpu.elements.filter import (
        detect_framework as jax_detect_framework,
    )

    model = tmp_path / "ident.py"
    model.write_text("def get_model():\n    return lambda x: x\n")
    assert detect_framework(str(model)) in ("python", "jax")
    assert detect_framework(str(model)) == jax_detect_framework(str(model))
    assert detect_framework(str(tmp_path / "w.msgpack")) == "torch"


def test_export_model_from_py(tmp_path):
    """``tests/test_artifact.py::test_export_model_from_py`` with a
    ``.pt2``."""
    src = tmp_path / "double.py"
    src.write_text(
        "from nnstreamer_tpu_torch.tensors.types import TensorsInfo\n"
        "IN_INFO = TensorsInfo.from_str('4:2', 'float32')\n"
        "def get_model():\n"
        "    return lambda x: x * 2.0\n")
    out = tmp_path / "double.pt2"
    out_info = export_model(str(src), str(out))
    assert out_info[0].shape == (2, 4)
    with SingleShot(model=str(out)) as s:
        (y,) = s.invoke([np.ones((2, 4), np.float32)])
    np.testing.assert_allclose(np.asarray(y), 2.0)


def test_cli_export(tmp_path):
    """``tests/test_artifact.py::test_cli_export`` with a ``.pt2``."""
    from nnstreamer_tpu_torch.cli import main

    src = tmp_path / "half.py"
    src.write_text("def get_model():\n"
                   "    return lambda x: x * 0.5\n")
    out = tmp_path / "half.pt2"
    rc = main(["--export", str(src), str(out), "--platforms", "cpu",
               "--input", "3:2", "--inputtype", "float32"])
    assert rc == 0
    with SingleShot(model=str(out)) as s:
        (y,) = s.invoke([np.full((2, 3), 4.0, np.float32)])
    np.testing.assert_allclose(np.asarray(y), 2.0)


def test_cli_export_of_a_msgpack(tmp_path, labels):
    """``--export`` of a JAX-written ``.msgpack`` with ``--custom
    module:mobilenet_v2``: the ``.pt2`` gives the ``.msgpack`` model's
    labels and scores exactly."""
    from nnstreamer_tpu_torch.cli import main

    src = str(tmp_path / "mnv2.msgpack")
    jax_checkpoint.save_params(_narrow_mnv2()[1], src)
    out = str(tmp_path / "mnv2.pt2")
    rc = main(["--export", src, out, "--platforms", "cpu", "--custom",
               "module:mobilenet_v2", "--input", f"3:{SIZE}:{SIZE}:1"])
    assert rc == 0
    _, want = _run(tnt, _flagship(src, labels,
                                  "custom=module:mobilenet_v2 " + AT_SIZE))
    _, got = _run(tnt, _flagship(out, labels))
    assert [(m["label_index"], m["score"]) for m in got] == \
        [(m["label_index"], m["score"]) for m in want]


# -- the loader's errors -----------------------------------------------------------
def test_msgpack_without_module_or_with_an_unknown_factory(tmp_path):
    path = _jax_lm_file(tmp_path)
    for custom, match in ((None, "needs custom=module:<models factory>"),
                          ("sharding:batch", "needs custom=module:"),
                          ("module:no_such_model",
                           "unknown model factory 'no_such_model'")):
        with pytest.raises(ValueError, match=match):
            SingleShot(framework="jax", model=path, custom=custom)
        # the JAX loader words them the same
        with pytest.raises(ValueError, match=match):
            JaxSingleShot(framework="jax", model=path, custom=custom)


def test_msgpack_with_a_shape_no_argument_fits(tmp_path):
    params = dict(_lm_params())
    params["ln2"] = np.ones((1, 15), np.float32)  # d_model is 16
    path = str(tmp_path / "bad.msgpack")
    jax_checkpoint.save_params(params, path)
    with pytest.raises(ValueError, match="'ln2'.*no argument of the "
                                         "factory fits it"):
        SingleShot(framework="jax", model=path,
                   custom="module:transformer_lm")
    path = str(tmp_path / "lm_as_mnv2.msgpack")
    jax_checkpoint.save_params(_lm_params(), path)
    with pytest.raises(ValueError, match="not a mobilenet_v2 checkpoint"):
        SingleShot(framework="jax", model=path,
                   custom="module:mobilenet_v2")


# -- a .pt2 under mesh= ------------------------------------------------------------
DOUBLE_PY = ("from nnstreamer_tpu_torch.tensors.types import TensorsInfo\n"
             "IN_INFO = TensorsInfo.from_str('4:8', 'float32')\n"
             "def get_model():\n"
             "    return lambda x: x * 2.0\n")
JAX_DOUBLE_PY = ("from nnstreamer_tpu.tensors.types import TensorsInfo\n"
                 "IN_INFO = TensorsInfo.from_str('4:8', 'float32')\n"
                 "def get_model():\n"
                 "    return lambda x: x * 2.0\n")


def _pushed(pkg, model, mesh, frame):
    pipe = pkg.parse_launch(
        f"appsrc name=src ! tensor_filter framework=jax model={model} "
        f"{mesh} ! tensor_sink name=out to-host=true")
    pipe.start()
    try:
        pipe.get("src").push([frame])
        pipe.get("src").end_of_stream()
        msg = pipe.wait(timeout=60)
    finally:
        pipe.stop()
    assert msg is not None and msg.kind == "eos", msg
    return [np.asarray(b[0]) for b in pipe.get("out").buffers]


@pytest.fixture
def double_pt2(tmp_path):
    src = tmp_path / "double.py"
    src.write_text(DOUBLE_PY)
    out = str(tmp_path / "double.pt2")
    export_model(str(src), out)
    return out


def test_export_marks_the_batch_dynamic(double_pt2):
    assert program_batches(load_artifact(double_pt2)) == \
        [(8, 1, sys.maxsize)]


def test_pt2_under_a_mesh_equals_unmeshed_and_the_jax_filter(double_pt2,
                                                             tmp_path):
    """The issue's run: the JAX package serves the ``.jaxexp`` of ``x *
    2.0`` under ``mesh=dp2`` on its 8-device CPU mesh, a frame of ones
    summing to 64.0; the port serves the ``.pt2`` under ``dp2``, ``dp8``
    and ``dp-1`` (8 logical host devices) as unmeshed."""
    src = tmp_path / "jax_double.py"
    src.write_text(JAX_DOUBLE_PY)
    jaxexp = str(tmp_path / "double.jaxexp")
    jax_export_model(str(src), jaxexp, platforms=("cpu",))
    ones = np.ones((8, 4), np.float32)
    (want,) = _pushed(jnt, jaxexp, "mesh=dp2", ones)
    assert float(want.sum()) == 64.0
    tnt.set_host_device_count(8)
    frame = np.random.default_rng(1).standard_normal((8, 4)).astype(
        np.float32)
    (plain,) = _pushed(tnt, double_pt2, "", frame)
    for mesh in ("mesh=dp2", "mesh=dp8", "mesh=dp-1", "mesh=dp4xtp2"):
        (got,) = _pushed(tnt, double_pt2, mesh, frame)
        assert np.array_equal(got, plain), mesh
        (got,) = _pushed(tnt, double_pt2, mesh, ones)
        assert np.array_equal(got, want), mesh


AFFINE_PY = ("import torch\n"
             "from nnstreamer_tpu_torch.tensors.types import TensorsInfo\n"
             "IN_INFO = TensorsInfo.from_str('4:8', 'uint8')\n"
             "class Affine(torch.nn.Module):\n"
             "    def __init__(self):\n"
             "        super().__init__()\n"
             "        self.w = torch.nn.Parameter(torch.linspace(0.5, 2.0, 4))\n"
             "    def forward(self, x):\n"
             "        ramp = torch.arange(4, dtype=torch.float32,\n"
             "                            device=x.device)\n"
             "        return (x.to(torch.float32) + ramp) * self.w\n"
             "def get_model():\n"
             "    return Affine()\n")


@pytest.mark.parametrize("budget", [False, True], ids=["unbudgeted",
                                                       "budgeted"])
def test_c58_each_mesh_device_serves_the_program_moved_there(
        tmp_path, monkeypatch, budget):
    """A ``.pt2`` burns the device it was moved to into its graph (the
    ``arange``'s ``device=``, the ``.to(dtype)``'s device assert), so
    every mesh device's copy, and under the HBM accountant every
    device's residency twin, comes from the program moved to that
    device, not from a copy of the first device's: one move for the
    loaded program and one for each further device. The stream equals
    unmeshed."""
    from torch.export import passes

    from nnstreamer_tpu_torch.tensors import memory

    src = tmp_path / "affine.py"
    src.write_text(AFFINE_PY)
    path = str(tmp_path / "affine.pt2")
    export_model(str(src), path)
    moved = []
    real = passes.move_to_device_pass

    def spy(ep, location):
        moved.append(str(location))
        return real(ep, location)

    monkeypatch.setattr(passes, "move_to_device_pass", spy)
    tnt.set_host_device_count(8)
    frame = np.random.default_rng(4).integers(0, 255, (8, 4), np.uint8)
    (plain,) = _pushed(tnt, path, "", frame)
    for mesh, devices in (("mesh=dp2", 2), ("mesh=dp8", 8)):
        moved.clear()
        acct = memory.activate(1 << 20) if budget else None
        try:
            (got,) = _pushed(tnt, path, mesh, frame)
        finally:
            memory.deactivate()
        assert np.array_equal(got, plain), mesh
        assert len(moved) == devices, (mesh, moved)
        if budget:
            assert acct.snapshot()["high_water_bytes"] == devices * 4 * 4


def test_c58_a_static_batch_the_mesh_splits_raises_at_start(tmp_path):
    """ROADMAP C.58: a program traced at a static batch of 8 serves under
    a mesh only where each device gets the whole batch (a plan that does
    not split it runs replicated); a split raises ``ValueError`` naming
    the shard and the program's batch at ``start()``, before any frame."""
    class Double(torch.nn.Module):
        def forward(self, x):
            return x * 2.0

    path = str(tmp_path / "static.pt2")
    torch.export.save(torch.export.export(Double(), (torch.ones(8, 4),)),
                      path)
    assert program_batches(load_artifact(path)) == [(8, 8, 8)]
    tnt.set_host_device_count(8)
    for mesh, shard in (("mesh=dp2", 4), ("mesh=dp8", 1),
                        ("mesh=dp-1", 1)):
        with pytest.raises(ValueError, match=f"static batch of 8.*shard "
                                             f"of {shard} rows"):
            _pushed(tnt, path, mesh, np.ones((8, 4), np.float32))
    frame = np.ones((8, 4), np.float32)
    (got,) = _pushed(tnt, path, "mesh=dp3", frame)  # 8 rows do not split
    assert np.array_equal(got, frame * 2.0)


def test_a_model_that_fixes_its_batch_exports_static(tmp_path, caplog):
    class Fixed(torch.nn.Module):
        def forward(self, x):
            return x.reshape(8, 2, 2).sum(-1)

    path = str(tmp_path / "fixed.pt2")
    logger = logging.getLogger("nnstreamer_tpu_torch.artifact")
    logger.addHandler(caplog.handler)
    try:
        save_artifact(path, Fixed(), example_inputs=[torch.ones(8, 4)])
    finally:
        logger.removeHandler(caplog.handler)
    assert program_batches(load_artifact(path)) == [(8, 8, 8)]
    assert "exported static" in caplog.text


# -- the import gate ---------------------------------------------------------------
def test_model_files_import_no_jax_flax_or_msgpack(tmp_path):
    """Reading and serving a JAX-written ``.msgpack`` and a ``.py`` model
    on the port leaves ``jax``, ``flax``, ``msgpack``, ``ml_dtypes`` and
    ``nnstreamer_tpu`` out of ``sys.modules``."""
    lm = _jax_lm_file(tmp_path)
    py = tmp_path / "double.py"
    py.write_text(DOUBLE_PY)
    code = (
        "import sys, numpy as np\n"
        "import nnstreamer_tpu_torch as tnt\n"
        "from nnstreamer_tpu_torch.single import SingleShot\n"
        "from nnstreamer_tpu_torch.filters.artifact import export_model\n"
        "from nnstreamer_tpu_torch.utils import checkpoint\n"
        "tnt.set_device('cpu')\n"
        f"s = SingleShot(framework='jax', model={lm!r}, "
        "custom='module:transformer_lm')\n"
        "assert tuple(s.invoke([np.zeros((1, 8), np.int32)])[0].shape) == "
        "(1, 8, 32)\n"
        f"checkpoint.save_params(checkpoint.load_params(None, {lm!r}), "
        f"{str(tmp_path / 'copy.msgpack')!r})\n"
        f"export_model({str(py)!r}, {str(tmp_path / 'd.pt2')!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'msgpack', 'ml_dtypes', "
        "'nnstreamer_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    assert (tmp_path / "copy.msgpack").read_bytes() == \
        open(lm, "rb").read()
