"""The port's ``SingleShot`` (``single.py``, pipeline-less invoke) held to
the JAX package's on the CPU: a small MobileNetV2 (32×32, 10 classes,
float32) with the JAX package's seeded variables converted into the port's
module, the same numpy-seeded frames through ``SingleShot(framework="jax")``
in both packages. Logits agree to rtol 1e-4 and atol 1e-4 × max|logit|,
the tolerance of the port's filter parity tests
(``tests/test_torch_pipeline.py``, ``tests/test_torch_mobilenet_v2.py``).
The port's ``SingleShot`` runs on the card unless the CPU is asked for,
as its ``tensor_filter`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.filters.jax_backend import (
    register_jax_model,
    unregister_jax_model,
)
from nnstreamer_tpu.models.mobilenet_v2 import mobilenet_v2 as jax_mobilenet_v2
from nnstreamer_tpu.single import SingleShot as JSingleShot
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2, params_from_jax
from nnstreamer_tpu_torch.single import SingleShot

SIZE, CLASSES, FRAMES = 32, 10, 4
RTOL = 1e-4


@pytest.fixture(scope="module")
def models():
    apply_fn, variables, in_info, out_info = jax_mobilenet_v2(
        num_classes=CLASSES, image_size=SIZE, dtype=jnp.float32, seed=16)
    module = MobileNetV2(num_classes=CLASSES)
    module.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                        variables)))
    register_jax_model("single_mnv2", apply_fn, variables, in_info=in_info,
                       out_info=out_info)
    register_torch_model(
        "single_mnv2", module.eval(),
        tnt.TensorsInfo.from_str(f"3:{SIZE}:{SIZE}:1", "float32"),
        tnt.TensorsInfo.from_str(f"{CLASSES}:1", "float32"))
    yield "single_mnv2"
    unregister_jax_model("single_mnv2")
    unregister_torch_model("single_mnv2")


def _frames():
    rng = np.random.default_rng(16)
    return [rng.uniform(-1.0, 1.0, (1, SIZE, SIZE, 3)).astype(np.float32)
            for _ in range(FRAMES)]


def test_invoke_matches_jax(models):
    with JSingleShot(framework="jax", model=models) as ref:
        want = [np.asarray(ref.invoke([f])[0]) for f in _frames()]
    with SingleShot(framework="jax", model=models,
                    accelerator="true:cpu") as s:
        got = [s.invoke([f])[0] for f in _frames()]
        assert s.stats.total_invokes == FRAMES
    for g, w in zip(got, want):
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) \
            else np.asarray(g)
        assert g.shape == w.shape == (1, CLASSES)
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=RTOL * float(np.abs(w).max()))
        assert int(np.argmax(g)) == int(np.argmax(w))


def test_model_info_matches_jax(models):
    with JSingleShot(framework="jax", model=models) as ref, \
            SingleShot(framework="jax", model=models,
                       accelerator="true:cpu") as s:
        assert str(s.get_input_info()) == str(ref.get_input_info())
        assert str(s.get_output_info()) == str(ref.get_output_info())


def test_the_package_device_serves_when_no_accelerator_is_named(models):
    tnt.set_device("cpu")
    try:
        with SingleShot(framework="torch", model=models) as s:
            (out,) = s.invoke([_frames()[0]])
        assert tuple(out.shape) == (1, CLASSES)
    finally:
        tnt.set_device(None)


def test_without_a_card_it_raises_unless_the_cpu_was_asked_for(models):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(Exception, match="(?i)cuda|card|gpu"):
        with SingleShot(framework="jax", model=models) as s:
            s.invoke([_frames()[0]])


@pytest.mark.parametrize("kwargs,match", [
    (dict(framework="auto"), "needs a model"),
    (dict(framework="auto", model="m.unknownext"), "cannot detect"),
    (dict(framework="nope", model="m"), "no filter backend"),
])
def test_open_errors_match_jax(kwargs, match):
    with pytest.raises(ValueError, match=match) as port_err:
        SingleShot(**kwargs)
    with pytest.raises(ValueError, match=match) as jax_err:
        JSingleShot(**kwargs)
    assert str(port_err.value) == str(jax_err.value)
