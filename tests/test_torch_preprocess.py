"""Kernel B1 (the normalize chain) in the PyTorch port, held to the JAX
package.

On the CPU the port's wrapper runs its plain version; the JAX side runs the
Pallas kernel in interpret mode, as ``tests/test_ops.py`` runs it. The CUDA
kernel itself is held to the plain version on the card by
``chip_smoke.py`` and by the ``gpu``-marked test at the end of this file.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.elements.transform import _TransformSpec as JaxSpec
from nnstreamer_tpu.ops import normalize_u8 as jax_normalize_u8
from nnstreamer_tpu_torch.elements import transform as port_transform
from nnstreamer_tpu_torch.elements.transform import _TransformSpec, kernel_chain
from nnstreamer_tpu_torch.ops import preprocess as pp

FLAGSHIP = "typecast:float32,add:-127.5,div:127.5"


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 unit in the last place at each value of ``x``
    (8 significant bits)."""
    mag = np.maximum(np.abs(x.astype(np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _inputs(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return (rng.standard_normal(shape) * 200.0).astype(np.float32)


@pytest.mark.parametrize("in_dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shape", [(224, 224, 3), (2, 17, 5), (15,)])
def test_normalize_u8_f32_matches_pallas(in_dtype, shape):
    x = _inputs(in_dtype, shape, seed=0)
    ref = np.asarray(jax_normalize_u8(jnp.asarray(x), 127.5, 1 / 127.5,
                                      jnp.float32, force="pallas"))
    out = pp.normalize_u8(torch.from_numpy(x), 127.5, 1 / 127.5,
                          torch.float32)
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    # per-op rounding may differ from XLA's by an ulp
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)


@pytest.mark.parametrize("in_dtype", [np.uint8, np.float32])
def test_normalize_u8_bf16_matches_pallas(in_dtype):
    x = _inputs(in_dtype, (10, 30), seed=1)
    ref = np.asarray(jax_normalize_u8(jnp.asarray(x), force="pallas")
                     .astype(jnp.float32))
    out = pp.normalize_u8(torch.from_numpy(x))  # default: bfloat16 out
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (10, 30)
    diff = np.abs(out.float().numpy().astype(np.float64) - ref)
    assert np.all(diff <= _bf16_ulp(ref)), diff.max()


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_transform_chain_matches_jax_transform(dtype):
    x = _inputs(dtype, (1, 24, 24, 3), seed=2)
    ref = np.asarray(JaxSpec("arithmetic", FLAGSHIP, True)(jnp.asarray(x)))
    spec = _TransformSpec("arithmetic", FLAGSHIP)
    assert spec.chain == ([("add", -127.5), ("div", 127.5)], torch.float32)
    out = spec(torch.from_numpy(x))  # the kernel path's plain version
    assert out.dtype == torch.float32 and tuple(out.shape) == x.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)
    # the torch-ops form of the same transform agrees too
    np.testing.assert_allclose(spec.apply(torch.from_numpy(x)).numpy(),
                               ref, rtol=1e-6)


@pytest.mark.parametrize("option,expected", [
    (FLAGSHIP, ([("add", -127.5), ("div", 127.5)], torch.float32)),
    ("typecast:float32,sub:127.5,mul:0.5,typecast:bfloat16",
     ([("sub", 127.5), ("mul", 0.5)], torch.bfloat16)),
    ("typecast:float32,mul:2,typecast:float16",
     ([("mul", 2.0)], torch.float16)),
    ("typecast:float32", ([], torch.float32)),
    ("typecast:float32," + ",".join(["add:1"] * 8),
     ([("add", 1.0)] * 8, torch.float32)),
    ("typecast:float32," + ",".join(["add:1"] * 9), None),
    ("add:-127.5,div:127.5", None),
    ("typecast:float16,add:1", None),
    ("typecast:float32,add:1,typecast:int32", None),
    ("typecast:float32,add:1,typecast:bfloat16,add:1", None),
    ("typecast:float32,typecast:bfloat16,typecast:float16", None),
])
def test_kernel_chain_selector(option, expected):
    assert kernel_chain("arithmetic", option) == expected


@pytest.mark.parametrize("mode,option", [
    ("typecast", "float32"), ("clamp", "0:1"), ("transpose", "1:0:2:3"),
])
def test_kernel_chain_selector_other_modes(mode, option):
    assert kernel_chain(mode, option) is None


@pytest.mark.parametrize("np_dtype,kernel", [
    (np.uint8, True), (np.float32, True), (np.int16, False),
    (np.float64, False),
])
def test_transform_routes_only_kernel_inputs(monkeypatch, np_dtype, kernel):
    calls = []
    real = port_transform.normalize_chain

    def spy(x, ops, out_dtype):
        calls.append(x.dtype)
        return real(x, ops, out_dtype)

    monkeypatch.setattr(port_transform, "normalize_chain", spy)
    x = torch.from_numpy(np.arange(12).astype(np_dtype).reshape(3, 4))
    out = _TransformSpec("arithmetic", FLAGSHIP)(x)
    assert out.dtype == torch.float32
    assert calls == ([x.dtype] if kernel else [])
    np.testing.assert_allclose(out.numpy(),
                               (np.arange(12.0).reshape(3, 4) - 127.5)
                               / 127.5, rtol=1e-6)


def test_out_info_follows_the_trailing_typecast():
    from nnstreamer_tpu_torch.tensors.types import TensorInfo, TensorType

    spec = _TransformSpec("arithmetic", FLAGSHIP + ",typecast:bfloat16")
    info = spec.out_info(TensorInfo(dim=(3, 8, 8, 1), type=TensorType.UINT8))
    assert info.dim == (3, 8, 8, 1) and info.type is TensorType.BFLOAT16


def test_chain_wrapper_rejects_what_it_cannot_run():
    x = torch.zeros(4, dtype=torch.uint8)
    with pytest.raises(ValueError, match="at most 8"):
        pp.normalize_chain(x, [("add", 1.0)] * 9)
    with pytest.raises(ValueError, match="unknown op"):
        pp.normalize_chain(x, [("pow", 2.0)])
    with pytest.raises(ValueError, match="no kernel for device"):
        pp.normalize_chain(x.to("meta"), [("add", 1.0)])


def test_plain_chain_divides_exactly():
    # IEEE division, not a multiply by the reciprocal: 3 / 3 stays 1
    x = torch.full((5,), 3.0)
    out = pp.normalize_chain_reference(x, [("div", 3.0)], torch.float32)
    assert torch.equal(out, torch.ones(5))
    # one rounding to bfloat16, at the end of the chain: 1 + 3 * 2**-8 is
    # 1.5 bfloat16 ulps above 1 and rounds to 1 + 2**-6, where rounding
    # after every add would stay at 1
    y = pp.normalize_chain_reference(torch.tensor([1.0]),
                                     [("add", 2.0 ** -8)] * 3,
                                     torch.bfloat16)
    assert y.float().item() == 1.0 + 2.0 ** -6


@pytest.mark.gpu
def test_kernel_bit_identical_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator().manual_seed(0)
    for n in (1, 17, 224 * 224 * 3, 10 ** 6 + 3):
        for offset in (0, 1):
            base = torch.randint(0, 256, (n + offset,), generator=gen,
                                 dtype=torch.uint8).cuda()
            x = base[offset:]
            for out_dtype in (torch.float32, torch.bfloat16, torch.float16):
                for ops in ([("add", -127.5), ("div", 127.5)],
                            [("sub", 127.5), ("mul", 1 / 127.5)]):
                    y = pp.normalize_chain(x, ops, out_dtype)
                    ref = pp.normalize_chain_reference(x, ops, out_dtype)
                    assert torch.equal(y, ref)
