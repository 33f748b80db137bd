"""MobileNetV2 in the PyTorch port, on weights converted from the JAX
package's flax model (``params_from_jax``), held to the flax model.

Both run in float32 on the CPU. Convolutions sum in another order in the
two frameworks, so logits agree to rtol 1e-4 and atol 1e-4 * max|logit|,
and the top-1 class agrees exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.models.mobilenet_v2 import mobilenet_v2 as jax_mobilenet_v2
from nnstreamer_tpu_torch.models.mobilenet_v2 import (
    MobileNetV2,
    mobilenet_v2,
    params_from_jax,
    same_pads,
)

CLASSES = 10


@pytest.fixture(scope="module")
def models():
    apply_fn, variables, _, _ = jax_mobilenet_v2(
        num_classes=CLASSES, image_size=32, dtype=jnp.float32, seed=3)
    np_vars = jax.tree.map(np.asarray, variables)
    module = MobileNetV2(num_classes=CLASSES)
    module.load_state_dict(params_from_jax(np_vars), strict=True)
    return apply_fn, variables, module.eval()


def _assert_logits_close(out, ref):
    assert out.shape == ref.shape
    atol = 1e-4 * float(np.abs(ref).max())
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=atol)
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("size", [32, 33])
def test_logits_match_flax(models, size):
    apply_fn, variables, module = models
    x = np.random.default_rng(size).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    ref = np.asarray(apply_fn(variables, jnp.asarray(x)))
    with torch.inference_mode():
        out = module(torch.from_numpy(x)).numpy()
    assert out.dtype == np.float32
    _assert_logits_close(out, ref)


def test_symmetric_padding_would_differ(models):
    """The explicit SAME pads matter: a stride-2 stem padded (1, 1), as
    ``nn.Conv2d(padding=1)`` pads it, gives other logits."""
    apply_fn, variables, module = models
    x = np.random.default_rng(7).standard_normal((1, 32, 32, 3)).astype(
        np.float32)
    ref = np.asarray(apply_fn(variables, jnp.asarray(x)))
    stem = module.stem
    try:
        stem._explicit, stem.padding = False, (1, 1)
        with torch.inference_mode():
            wrong = module(torch.from_numpy(x)).numpy()
    finally:
        stem._explicit, stem.padding = True, (0, 0)
    assert not np.allclose(wrong, ref, rtol=1e-4,
                           atol=1e-4 * float(np.abs(ref).max()))


@pytest.mark.parametrize("size,kernel,stride,pads", [
    (224, 3, 2, (0, 1)), (112, 3, 2, (0, 1)), (33, 3, 2, (1, 1)),
    (7, 3, 2, (1, 1)), (32, 3, 1, (1, 1)), (32, 1, 1, (0, 0)),
])
def test_same_pads(size, kernel, stride, pads):
    assert same_pads(size, kernel, stride) == pads


def test_state_dict_layout(models):
    _, variables, module = models
    sd = module.state_dict()
    # HWIO → OIHW; depthwise (3, 3, 1, C) → (C, 1, 3, 3); Dense (I, O) → (O, I)
    stem = np.asarray(variables["params"]["Conv_0"]["kernel"])
    np.testing.assert_array_equal(sd["stem.weight"].numpy(),
                                  stem.transpose(3, 2, 0, 1))
    dw = np.asarray(variables["params"]["InvertedResidual_1"]["Conv_1"]
                    ["kernel"])
    assert dw.shape[2] == 1
    assert tuple(sd["blocks.1.convs.1.weight"].shape) == (
        dw.shape[3], 1, 3, 3)
    assert module.blocks[1].convs[1].groups == dw.shape[3]
    dense = np.asarray(variables["params"]["Dense_0"]["kernel"])
    np.testing.assert_array_equal(sd["classifier.weight"].numpy(), dense.T)
    # an expand == 1 block has two convolutions, the others three
    assert len(module.blocks[0].convs) == 2
    assert all(len(b.convs) == 3 for b in module.blocks[1:])
    assert len(module.blocks) == 17


def test_factory_defaults_and_seed():
    module, in_info, out_info = mobilenet_v2(num_classes=CLASSES,
                                             image_size=16, seed=5)
    assert in_info[0].dim == (3, 16, 16, 1)
    assert out_info[0].dim == (CLASSES, 1)
    assert module.classifier.weight.dtype is torch.bfloat16
    again, _, _ = mobilenet_v2(num_classes=CLASSES, image_size=16, seed=5,
                               dtype=torch.float32)
    # the bfloat16 weights are the float32 ones of the same seed, rounded
    assert torch.equal(module.stem.weight,
                       again.stem.weight.to(torch.bfloat16))
    x = torch.zeros(1, 16, 16, 3)
    with torch.inference_mode():
        out = module(x)
    assert out.dtype is torch.float32 and tuple(out.shape) == (1, CLASSES)
    assert bool(torch.isfinite(out).all())
