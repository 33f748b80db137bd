"""The port's script filter (``nnstreamer_tpu_torch/filters/script.py``)
held to the JAX package's (``nnstreamer_tpu/filters/script.py``) on the
CPU: every script of ``tests/test_filter_backends_extra.py::
TestScriptFilter`` runs through both packages, in device mode and in
``custom=mode:host``, on the same numpy inputs made from a seed.

The negotiated (shape, dtype) pairs are equal, and so are the outputs,
to ``rtol=1e-6, atol=1e-7``, the JAX test's own tolerance between its two
modes: each package computes the same float32 ops, but a reduction may
sum in another order (and the port's device-mode mean of an integer input
is numpy's float64 mean narrowed to float32, where JAX means in float32).
Host mode is a copy of the JAX package's host mode, so there the outputs
are compared bit for bit. The same bad scripts raise in both.

What differs is pinned here (ROADMAP C.47): device mode runs eagerly over
``torch._numpy``, so a script JAX cannot trace under ``jit`` runs on the
port; a ``jax.*`` name outside the bound surface raises ``NameError``.
"""

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.filters.api import FilterProperties as JaxProps
from nnstreamer_tpu.registry import FILTER as JAX_FILTER
from nnstreamer_tpu.registry import get_subplugin as jax_get_subplugin
from nnstreamer_tpu.tensors.types import TensorsInfo as JaxInfo
from nnstreamer_tpu_torch.filters.api import FilterProperties
from nnstreamer_tpu_torch.registry import FILTER, get_subplugin
from nnstreamer_tpu_torch.tensors.types import TensorsInfo

RTOL, ATOL = 1e-6, 1e-7
MODES = (None, "mode:host")

#: the scripts of TestScriptFilter that trace under jit, each with its
#: input info (caps dims, type)
BRANCH_SCRIPT = (
    "m = jnp.mean(x)\n"
    "y = cond(m > 0.5, lambda a: a * 2.0, lambda a: a * 0.5, x)\n"
)
STRUCTURED_SCRIPT = (
    "v = while_loop(lambda v: jnp.sum(v) < 10.0,"
    " lambda v: v + 1.0, x)\n"
    "y0 = v\n"
    "y1 = switch(2, [lambda a: a, lambda a: a * 2,"
    " lambda a: a * 3], x)\n"
    "y2 = select(x > 1.0, x, -x)\n"
)
SCRIPTS = {
    "inline_expression": ("y = jnp.tanh(x) * 2.0", "3:8:8:1", "float32"),
    "multi_output": ("y0 = x * 2.0\n"
                     "y1 = jnp.sum(x, axis=(1, 2, 3), keepdims=False)\n",
                     "3:8:8:1", "float32"),
    "shape_inference": ("y = jnp.mean(x, axis=-1)", "4:8:8:1", "float32"),
    "branch": (BRANCH_SCRIPT, "3:8:8:1", "float32"),
    "structured_ops": (STRUCTURED_SCRIPT, "2", "float32"),
    "mean_of_uint8": ("y = jnp.mean(x)", "4:4", "uint8"),
    "lax_spelling": ("y = lax.cond(np.mean(x) > 0.5,"
                     " lambda a: a * 2.0, lambda a: a * 0.5, x)",
                     "4", "float32"),
}
#: TestScriptFilter's imperative script, which only mode:host runs there
IMPERATIVE_SCRIPT = (
    "total = float(np.sum(x))\n"
    "scale = 1.0\n"
    "while total * scale > 100.0:\n"
    "    scale *= 0.5\n"
    "if total < 0:\n"
    "    y = x * 0.0\n"
    "else:\n"
    "    y = x * scale\n"
)


@pytest.fixture(autouse=True)
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


def _inputs(dims, dtype, seed, n=3):
    """``n`` frames for caps ``dims`` (innermost first) from a seed: some
    means above and some below the branch scripts' 0.5."""
    shape = tuple(int(d) for d in reversed(dims.split(":")))
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return [rng.integers(0, 256, shape, dtype=np.uint8)
                for _ in range(n)]
    return [(rng.random(shape) * (0.4 + 0.8 * i)).astype(np.float32)
            for i in range(n)]


def _open(pkg, model, custom):
    if pkg is jnt:
        f = jax_get_subplugin(JAX_FILTER, "script")()
        f.open(JaxProps(model=model, custom=custom))
    else:
        f = get_subplugin(FILTER, "script")()
        f.open(FilterProperties(model=model, custom=custom))
    return f


def _through(pkg, model, dims, dtype, frames, custom):
    """(negotiated (dims, type) pairs, outputs a frame) of ``model`` in
    one package."""
    info_cls = JaxInfo if pkg is jnt else TensorsInfo
    f = _open(pkg, model, custom)
    try:
        negotiated = [(tuple(i.dim), i.type.value) for i in
                      f.set_input_info(info_cls.from_str(dims, dtype))]
        outs = [[np.asarray(o) for o in f.invoke([x])] for x in frames]
    finally:
        f.close()
    return negotiated, outs


@pytest.mark.parametrize("custom", MODES, ids=["device", "host"])
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_matches_jax(name, custom):
    model, dims, dtype = SCRIPTS[name]
    frames = _inputs(dims, dtype, seed=sorted(SCRIPTS).index(name))
    want_info, want = _through(jnt, model, dims, dtype, frames, custom)
    got_info, got = _through(tnt, model, dims, dtype, frames, custom)
    assert got_info == want_info
    for g, w in zip(got, want):
        assert [(a.shape, a.dtype) for a in g] == \
            [(a.shape, a.dtype) for a in w]
        for a, b in zip(g, w):
            if custom:
                assert a.tobytes() == b.tobytes()
            else:
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_device_mode_outputs_are_torch_tensors_on_the_filter_device(name):
    model, dims, dtype = SCRIPTS[name]
    f = _open(tnt, model, None)
    f.set_input_info(TensorsInfo.from_str(dims, dtype))
    outs = f.invoke([_inputs(dims, dtype, seed=5, n=1)[0]])
    f.close()
    assert all(isinstance(o, torch.Tensor) and o.device.type == "cpu"
               for o in outs)
    assert not any(o.dtype in (torch.float64, torch.int64) for o in outs)


def test_both_modes_agree_on_the_port():
    """TestScriptFilter's done criterion, on the port: the branch script
    gives the same outputs in both modes."""
    frames = _inputs("3:8:8:1", "float32", seed=7, n=4)
    _, dev = _through(tnt, BRANCH_SCRIPT, "3:8:8:1", "float32", frames,
                      None)
    _, host = _through(tnt, BRANCH_SCRIPT, "3:8:8:1", "float32", frames,
                       "mode:host")
    for d, h in zip(dev, host):
        np.testing.assert_allclose(d[0], h[0], rtol=RTOL, atol=ATOL)


def test_imperative_script_in_host_mode_matches_jax():
    frames = [np.full((4,), 100.0, np.float32), np.ones((4,), np.float32),
              np.full((4,), -3.0, np.float32)]
    want = _through(jnt, IMPERATIVE_SCRIPT, "4", "float32", frames,
                    "mode:host")
    got = _through(tnt, IMPERATIVE_SCRIPT, "4", "float32", frames,
                   "mode:host")
    assert got[0] == want[0]
    for g, w in zip(got[1], want[1]):
        assert g[0].tobytes() == w[0].tobytes()


def test_device_mode_runs_an_imperative_script_jax_cannot_trace():
    """ROADMAP C.47: the JAX package traces device mode under jit, where
    ``float(np.sum(x))`` raises; the port runs the script eagerly (its
    negotiation falls back from the meta device to a ones probe) and
    gives host mode's outputs."""
    frames = [np.full((4,), 100.0, np.float32), np.ones((4,), np.float32)]
    f = _open(jnt, IMPERATIVE_SCRIPT, None)
    with pytest.raises(Exception):
        f.set_input_info(JaxInfo.from_str("4", "float32"))
    f.close()
    _, dev = _through(tnt, IMPERATIVE_SCRIPT, "4", "float32", frames, None)
    _, host = _through(tnt, IMPERATIVE_SCRIPT, "4", "float32", frames,
                       "mode:host")
    for d, h in zip(dev, host):
        assert d[0].tobytes() == h[0].tobytes()


def test_cond_with_a_device_predicate_selects_without_a_host_read(
        monkeypatch):
    """``cond`` on an array predicate evaluates both branches and selects
    on the device: no ``bool()`` of a tensor in the frame's run."""
    f = _open(tnt, BRANCH_SCRIPT, None)
    f.set_input_info(TensorsInfo.from_str("4", "float32"))
    reads = []
    real = torch.Tensor.__bool__
    monkeypatch.setattr(torch.Tensor, "__bool__",
                        lambda t: reads.append(1) or real(t))
    (out,) = f.invoke([np.full((4,), 0.75, np.float32)])
    monkeypatch.undo()
    f.close()
    assert reads == []
    np.testing.assert_array_equal(out.numpy(), np.full((4,), 1.5))


def test_cond_branches_that_disagree_raise_as_lax_cond():
    model = "y = cond(jnp.mean(x) > 0.5, lambda a: a, lambda a: a[:1], x)"
    for pkg, info_cls in ((jnt, JaxInfo), (tnt, TensorsInfo)):
        f = _open(pkg, model, None)
        with pytest.raises(TypeError):
            f.set_input_info(info_cls.from_str("4", "float32"))
        f.close()


@pytest.mark.parametrize("name", ["random.normal", "lax.dynamic_slice",
                                  "vmap"])
def test_jax_names_beyond_the_surface_raise_naming_c47(name):
    f = _open(tnt, f"y = jax.{name}(x)", None)
    with pytest.raises(NameError, match="C.47"):
        f.set_input_info(TensorsInfo.from_str("4", "float32"))
    f.close()


def test_bfloat16_input_raises_naming_c47():
    f = _open(tnt, "y = x * 2.0", None)
    with pytest.raises(TypeError, match="C.47"):
        f.invoke([torch.ones(4, dtype=torch.bfloat16)])
    f.close()


def test_host_mode_rejects_shape_drift_as_jax():
    for pkg, info_cls in ((jnt, JaxInfo), (tnt, TensorsInfo)):
        f = _open(pkg, "y = x[x > 0.0]", "mode:host")
        f.set_input_info(info_cls.from_str("4", "float32"))  # ones probe
        with pytest.raises(ValueError, match="negotiated"):
            f.invoke([np.asarray([1.0, 0.0, 2.0, 0.0], np.float32)])
        f.close()


@pytest.mark.parametrize("model,custom,when", [
    ("y = x", "mode:gpu", "open"),
    ("   ", None, "open"),
    ("z = x", None, "negotiate"),
    ("z = x", "mode:host", "negotiate"),
    ("y = x +", None, "open"),
])
def test_bad_scripts_raise_in_both(model, custom, when):
    for pkg, info_cls in ((jnt, JaxInfo), (tnt, TensorsInfo)):
        if when == "open":
            with pytest.raises((ValueError, SyntaxError)):
                _open(pkg, model, custom)
            continue
        f = _open(pkg, model, custom)
        with pytest.raises(ValueError, match="y"):
            f.set_input_info(info_cls.from_str("2:2", "float32"))
        f.close()


def test_a_script_file_runs_as_its_text(tmp_path):
    path = tmp_path / "split.jaxs"
    path.write_text(SCRIPTS["multi_output"][0])
    frames = _inputs("3:8:8:1", "float32", seed=11)
    by_file = _through(tnt, str(path), "3:8:8:1", "float32", frames, None)
    by_text = _through(tnt, SCRIPTS["multi_output"][0], "3:8:8:1",
                       "float32", frames, None)
    assert by_file[0] == by_text[0]
    for a, b in zip(by_file[1], by_text[1]):
        assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))


def _pipeline_outputs(pkg, desc):
    pipe = pkg.parse_launch(desc)
    outs = []
    pipe.get("out").connect(lambda b: outs.append(
        [np.asarray(t) for t in b.tensors]))
    msg = pipe.run(timeout=120)
    assert msg is not None and msg.kind == "eos", msg
    return outs


@pytest.mark.parametrize("custom", ["", "custom=mode:host "],
                         ids=["device", "host"])
@pytest.mark.parametrize("name", ["inline_expression", "branch",
                                  "multi_output"])
def test_in_a_pipeline_as_jax(name, custom, tmp_path):
    """TestScriptFilter's launch strings (videotestsrc gradient frames,
    the arithmetic typecast) through both packages."""
    path = tmp_path / f"{name}.jaxs"
    path.write_text(SCRIPTS[name][0])
    desc = ("videotestsrc num-buffers=4 width=8 height=8 pattern=gradient "
            "! tensor_converter ! tensor_transform mode=arithmetic "
            "option=typecast:float32,div:255.0 acceleration=false ! "
            f"tensor_filter framework=script model={path} {custom}! "
            "tensor_sink name=out to-host=true")
    want = _pipeline_outputs(jnt, desc)
    got = _pipeline_outputs(tnt, desc)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert [(a.shape, a.dtype) for a in g] == \
            [(a.shape, a.dtype) for a in w]
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
