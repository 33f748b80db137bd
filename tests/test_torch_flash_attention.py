"""Kernel B2's wrapper and plain version (nnstreamer_tpu_torch/ops/
flash_attention.py), held against the JAX package's Pallas kernel (run in
interpret mode, as tests/test_ops.py runs it on the CPU) and its XLA
reference, on the same inputs made with numpy.

On the CPU the wrapper takes its plain version; the CUDA kernel is held to
it on the card by ``chip_smoke.py`` and the ``gpu``-marked test at the
end of this file.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.ops import flash_attention as jax_flash
from nnstreamer_tpu.ops.flash_attention import (
    attention_reference as jax_reference,
)
from nnstreamer_tpu_torch.ops import LAUNCHES, reset_launches
from nnstreamer_tpu_torch.ops.flash_attention import (
    attention_reference,
    flash_attention,
    kernel_takes,
)

#: the Pallas kernel against the plain version (tests/test_ops.py:28-30)
KERNEL_TOL = 2e-3
#: plain version against plain version: both fp32 einsum + softmax
REFERENCE_TOL = 1e-5

#: (q shape, k shape); the JAX kernel tiles the first group
TILEABLE = [((2, 256, 2, 32), (2, 256, 2, 32)),
            ((1, 256, 1, 16), (1, 256, 1, 16)),
            ((1, 16, 8, 64), (1, 16, 8, 64))]
RAGGED = [((2, 100, 2, 24), (2, 100, 2, 24)),
          ((1, 77, 3, 64), (1, 77, 3, 64))]
CROSS = ((1, 64, 2, 64), (1, 200, 2, 64))  # sq != sk, non-causal


def _qkv(qshape, kshape, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=qshape).astype(np.float32)
    k = rng.normal(size=kshape).astype(np.float32)
    v = rng.normal(size=kshape).astype(np.float32)
    return q, k, v


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jnp(*arrays):
    return [jnp.asarray(a) for a in arrays]


CASES = [(qs, ks, causal) for qs, ks in TILEABLE + RAGGED
         for causal in (True, False)] + [(CROSS[0], CROSS[1], False)]


@pytest.mark.parametrize("qshape,kshape,causal", CASES)
def test_reference_matches_jax_reference(qshape, kshape, causal):
    q, k, v = _qkv(qshape, kshape, seed=1)
    ref = np.asarray(jax_reference(*_jnp(q, k, v), causal=causal))
    got = attention_reference(*_torch(q, k, v), causal=causal)
    assert got.dtype == torch.float32 and tuple(got.shape) == qshape
    np.testing.assert_allclose(got.numpy(), ref, rtol=REFERENCE_TOL,
                               atol=REFERENCE_TOL)


@pytest.mark.parametrize(
    "qshape,kshape,causal",
    [(qs, ks, c) for qs, ks in TILEABLE for c in (True, False)]
    + [(CROSS[0], CROSS[1], False)])
def test_flash_matches_jax_pallas_kernel(qshape, kshape, causal):
    q, k, v = _qkv(qshape, kshape, seed=2)
    ref = np.asarray(jax_flash(*_jnp(q, k, v), causal=causal,
                               force="pallas"))
    got = flash_attention(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), ref, rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)


@pytest.mark.parametrize("qshape,kshape,causal",
                         [(qs, ks, c) for qs, ks in RAGGED
                          for c in (True, False)])
def test_ragged_shapes_match_jax(qshape, kshape, causal):
    """Shapes the Pallas kernel cannot tile (the JAX package falls back to
    its reference there); the port's wrapper takes them."""
    q, k, v = _qkv(qshape, kshape, seed=3)
    ref = np.asarray(jax_flash(*_jnp(q, k, v), causal=causal))
    got = flash_attention(*_torch(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), ref, rtol=REFERENCE_TOL,
                               atol=REFERENCE_TOL)


def test_blocked_causality():
    """Zeroing keys and values from position 128 on leaves earlier rows
    as they were (tests/test_ops.py:33-45)."""
    q, k, v = _qkv((1, 256, 1, 16), (1, 256, 1, 16), seed=3)
    out = flash_attention(*_torch(q, k, v), causal=True)
    k2, v2 = k.copy(), v.copy()
    k2[:, 128:] = 0.0
    v2[:, 128:] = 0.0
    out2 = flash_attention(*_torch(q, k2, v2), causal=True)
    np.testing.assert_allclose(out[:, :128].numpy(), out2[:, :128].numpy(),
                               rtol=1e-4, atol=1e-5)


def test_strided_views_give_the_contiguous_result():
    """The LM hands the kernel q/k/v as views of one [b, s, 3, h, d]
    projection."""
    qkv = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 48, 3, 2, 32)).astype(np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    got = flash_attention(q, k, v)
    ref = attention_reference(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, ref)


def test_low_precision_output_keeps_the_input_dtype():
    q, k, v = (t.to(torch.bfloat16) for t in
               _torch(*_qkv((1, 16, 2, 16), (1, 16, 2, 16))))
    out = flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


def test_cpu_calls_count_no_launch_and_force_reference():
    """A CPU call is the plain version itself, and launches nothing."""
    q, k, v = _torch(*_qkv((1, 16, 2, 16), (1, 16, 2, 16)))
    reset_launches()
    a = flash_attention(q, k, v)
    b = attention_reference(q, k, v)
    assert torch.equal(a, b)
    assert all(n == 0 for n in LAUNCHES.values())


def test_meta_tensors_infer_shapes():
    q = torch.empty((2, 10, 4, 16), device="meta")
    out = flash_attention(q, q, q)
    assert out.device.type == "meta" and out.shape == q.shape


def test_shape_rule_is_the_kernels_limits():
    assert kernel_takes(64) and kernel_takes(8) and kernel_takes(256)
    assert not kernel_takes(12) and not kernel_takes(264)
    assert not kernel_takes(0)


def test_bad_arguments_raise():
    q, k, v = _torch(*_qkv((1, 16, 2, 16), (1, 16, 2, 16)))
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :1], v)
    with pytest.raises(ValueError):
        flash_attention(q, k, v[:, :8])
    with pytest.raises(ValueError):
        flash_attention(q[0], k[0], v[0])
    with pytest.raises(TypeError):  # the JAX API's options are not kept
        flash_attention(q, k, v, True, 64)


@pytest.mark.gpu
def test_kernel_matches_the_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for qshape, kshape in TILEABLE + RAGGED + [CROSS]:
        for causal in (True, False):
            if qshape != kshape and causal:
                continue
            q, k, v = (t.cuda() for t in _torch(*_qkv(qshape, kshape)))
            reset_launches()
            got = flash_attention(q, k, v, causal=causal)
            ref = attention_reference(q, k, v, causal=causal)
            torch.cuda.synchronize()
            assert LAUNCHES["flash_attention"] == 1
            torch.testing.assert_close(got, ref, rtol=KERNEL_TOL,
                                       atol=KERNEL_TOL)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.gpu
def test_kernel_takes_misaligned_contiguous_views_on_the_card():
    """A contiguous view whose base is not 16-byte aligned is copied to a
    fresh tensor before the kernel's vector loads read it."""
    _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    shape = (1, 77, 3, 64)
    n = int(np.prod(shape))
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.from_numpy(a.reshape(-1)).cuda().to(dtype)
                   for a in _qkv(shape, shape, seed=5))
        views = []
        for t, offset in ((q, 3), (k, 1), (v, 5)):
            buf = torch.zeros(n + offset, dtype=dtype, device="cuda")
            buf[offset:] = t
            views.append(buf[offset:].view(shape))
        assert all(t.is_contiguous() and t.data_ptr() % 16 for t in views)
        reset_launches()
        got = flash_attention(*views, causal=True)
        ref = attention_reference(*views, causal=True)
        torch.cuda.synchronize()
        assert LAUNCHES["flash_attention"] == 1
        tol = KERNEL_TOL if dtype is torch.float32 else 1e-2
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.gpu
def test_head_dims_outside_the_kernel_raise_on_the_card():
    _needs_card()
    q = torch.zeros((1, 16, 2, 12), device="cuda")
    reset_launches()
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention(q, q, q)
    assert LAUNCHES["flash_attention"] == 0
