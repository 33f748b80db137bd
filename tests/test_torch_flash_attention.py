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
    attention_tiled_reference,
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
#: bf16/f16 bounds of chip_smoke.py: atol = rtol, and the share of
#: elements more than one ulp from the plain version's
LOW_TOL = 1e-2
ULP_SHARE_MAX = 1e-3
#: (q shape, k shape, causal) of the tiled model's checks: ragged tiles,
#: d = 24 and 32, several q and k tiles, sq != sk
TILED_CASES = [((2, 100, 2, 24), (2, 100, 2, 24), True),
               ((2, 100, 2, 24), (2, 100, 2, 24), False),
               ((1, 77, 3, 64), (1, 77, 3, 64), True),
               ((2, 256, 2, 32), (2, 256, 2, 32), True),
               ((1, 64, 8, 64), (1, 64, 8, 64), True),
               (CROSS[0], CROSS[1], False)]
LOW_DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
              "float16": (torch.float16, jnp.float16)}


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


def _share_over_one_ulp(a: np.ndarray, b: np.ndarray) -> float:
    """Share of elements of two 16-bit float arrays more than one ulp
    apart, by their bit patterns."""
    ia = a.view(np.int16).astype(np.int32)
    ib = b.view(np.int16).astype(np.int32)
    return float(np.mean(np.abs(ia - ib) > 1))


def _low_precision_case(qshape, kshape, causal, dtype_name, **kw):
    """The tiled model and the JAX package's plain attention on the same
    16-bit inputs: (model bits, JAX bits, model as f32, JAX as f32)."""
    tdt, jdt = LOW_DTYPES[dtype_name]
    q, k, v = _qkv(qshape, kshape, seed=6)
    ref = np.asarray(jax_reference(*(a.astype(jdt) for a in _jnp(q, k, v)),
                                   causal=causal))
    got = attention_tiled_reference(*(t.to(tdt) for t in _torch(q, k, v)),
                                    causal=causal, **kw)
    assert got.dtype == tdt and tuple(got.shape) == qshape
    got_bits = got.view(torch.int16).numpy()
    ref_bits = ref.view(np.int16)
    return (got_bits, ref_bits, got.float().numpy(),
            ref.astype(np.float32))


@pytest.mark.parametrize("dtype_name", sorted(LOW_DTYPES))
@pytest.mark.parametrize("qshape,kshape,causal", TILED_CASES)
def test_tiled_model_with_split_p_matches_jax(qshape, kshape, causal,
                                              dtype_name):
    """The bf16/f16 kernel's arithmetic (64-key tiles, scale after QK,
    fp32 m and l, P split into two 16-bit halves) stays within chip_smoke's
    bounds of the JAX package's plain attention."""
    got_bits, ref_bits, got, ref = _low_precision_case(
        qshape, kshape, causal, dtype_name)
    np.testing.assert_allclose(got, ref, rtol=LOW_TOL, atol=LOW_TOL)
    assert _share_over_one_ulp(got_bits, ref_bits) <= ULP_SHARE_MAX


@pytest.mark.parametrize("dtype_name", sorted(LOW_DTYPES))
@pytest.mark.parametrize("qshape,kshape,causal", TILED_CASES[1:4])
def test_single_rounded_p_exceeds_the_ulp_share(qshape, kshape, causal,
                                                dtype_name):
    """Why the kernel splits P: P rounded once to the input type stays
    within atol = rtol = 1e-2 but leaves far more than 1e-3 of the outputs
    more than one ulp from plain attention."""
    got_bits, ref_bits, got, ref = _low_precision_case(
        qshape, kshape, causal, dtype_name, split_p=False)
    np.testing.assert_allclose(got, ref, rtol=LOW_TOL, atol=LOW_TOL)
    assert _share_over_one_ulp(got_bits, ref_bits) > 10 * ULP_SHARE_MAX


def test_tiled_model_in_f32_is_the_plain_version():
    """In f32 the split adds nothing (P - P_hi is 0) and the tile loop
    agrees with the plain version to fp32 rounding."""
    q, k, v = _torch(*_qkv((1, 150, 2, 40), (1, 150, 2, 40), seed=7))
    for causal in (True, False):
        got = attention_tiled_reference(q, k, v, causal=causal,
                                        block_q=64, block_k=32)
        ref = attention_reference(q, k, v, causal=causal)
        torch.testing.assert_close(got, ref, rtol=REFERENCE_TOL,
                                   atol=REFERENCE_TOL)


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
    # the bf16/f16 body (wgmma, split P) at every padded head dimension,
    # then last q tiles of at most 64 rows behind more k tiles than its
    # ring holds (one consumer warpgroup has no rows there)
    low_cases = [((2, 200, 2, d),) * 2 + (causal,)
                 for d in (24, 64, 128, 256) for causal in (True, False)]
    low_cases += [((1, 320, 2, 64),) * 2 + (True,),
                  ((2, 300, 2, 128),) * 2 + (True,),
                  ((1, 64, 2, 64), (1, 512, 2, 64), False)]
    for qshape, kshape, causal in low_cases:
        for dtype_name in sorted(LOW_DTYPES):
            dtype = LOW_DTYPES[dtype_name][0]
            q, k, v = (t.cuda().to(dtype) for t in _torch(
                *_qkv(qshape, kshape, seed=qshape[-1])))
            reset_launches()
            got = flash_attention(q, k, v, causal=causal)
            ref = attention_reference(q, k, v, causal=causal)
            torch.cuda.synchronize()
            assert LAUNCHES["flash_attention"] == 1
            torch.testing.assert_close(got.float(), ref.float(),
                                       rtol=LOW_TOL, atol=LOW_TOL)
            assert _share_over_one_ulp(
                got.view(torch.int16).cpu().numpy(),
                ref.view(torch.int16).cpu().numpy()) <= ULP_SHARE_MAX


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
