"""Flash attention — tiled online-softmax attention, one kernel on the card.

Port of the TPU kernel ``nnstreamer_tpu/ops/flash_attention.py::_kernel``
(kernel B2 in ROADMAP.md). The CUDA kernel (``csrc/flash_attention.cu``)
computes causal or non-causal attention on ``[batch, seq, heads, dim]``
tensors with fp32 running max, sum and accumulator, so the ``[sq, sk]``
score matrix never exists. It reads q, k and v through their strides (the
LM's q/k/v are views of one projection), masks ragged tiles itself (any
``sq`` and ``sk``) and writes the output in the input dtype. bfloat16 and
float16 take its Hopper body (TMA loads into a shared-memory ring, wgmma
for QK and for P.V with P split into two 16-bit halves); float32 takes its
CUDA-core body.

Beside it, :func:`attention_reference` is the plain version: fp32 einsum,
the scale applied after QK, ``-1e30`` for masked scores, softmax, fp32 PV
and one rounding to ``q.dtype``. :func:`attention_tiled_reference` models
the kernel's bf16/f16 tile loop in torch ops (tests use it to pin why the
kernel splits P into two bf16 halves). :func:`flash_attention` takes the plain
version only for a tensor on the CPU (or the meta device, where it infers
shapes); for a CUDA tensor it launches the kernel or raises. The kernel's
shape rule is ``d % 8 == 0 and d <= 256``; a CUDA call outside it raises,
and a caller that wants plain attention on the card calls
:func:`attention_reference`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nnstreamer_tpu_torch.ops import _build
from nnstreamer_tpu_torch.ops._counts import count_launch

#: scores below this act as -inf without producing exp() NaNs in fully
#: masked rows
NEG_BIG = -1e30
#: dtype codes shared with csrc/flash_attention.cu
DTYPE_CODES = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}
#: the kernel's largest head dimension
MAX_HEAD_DIM = 256


class _Args(ctypes.Structure):
    """``NnsAttnArgs`` of csrc/flash_attention.cu."""

    _fields_ = [("q", ctypes.c_void_p), ("k", ctypes.c_void_p),
                ("v", ctypes.c_void_p), ("o", ctypes.c_void_p),
                ("q_sb", ctypes.c_longlong), ("q_ss", ctypes.c_longlong),
                ("q_sh", ctypes.c_longlong),
                ("k_sb", ctypes.c_longlong), ("k_ss", ctypes.c_longlong),
                ("k_sh", ctypes.c_longlong),
                ("v_sb", ctypes.c_longlong), ("v_ss", ctypes.c_longlong),
                ("v_sh", ctypes.c_longlong),
                ("b", ctypes.c_int), ("h", ctypes.c_int),
                ("sq", ctypes.c_int), ("sk", ctypes.c_int),
                ("d", ctypes.c_int), ("causal", ctypes.c_int),
                ("scale", ctypes.c_float)]


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Plain attention on ``[batch, seq, heads, dim]``, fp32 softmax."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qi = torch.arange(q.shape[1], device=q.device)[:, None]
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(qi >= ki, s, NEG_BIG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


def attention_tiled_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              block_q: int = 128, block_k: int = 64,
                              split_p: bool = True) -> torch.Tensor:
    """The bf16/f16 body's arithmetic in torch ops, for tests: q tiles of
    ``block_q`` rows walk k tiles of ``block_k`` keys (causally dead ones
    skipped); fp32 scores of the input-type q and k, times ``d**-0.5``;
    ``-1e30`` for masked scores; fp32 running max ``m`` and sum ``l`` (from
    the unsplit P); the accumulator rescaled, then ``P_hi . v + P_lo . v``
    with ``P_hi = P`` rounded to the input type and ``P_lo = P - P_hi``
    rounded too (``split_p=False``: ``P_hi . v`` alone, P rounded once);
    ``acc / max(l, 1e-30)`` rounded once to ``q.dtype``. For float16 P is
    split as ``2**15 P`` and ``acc`` divided back, as the kernel does, so
    that small P stays out of f16's subnormals."""
    dtype = q.dtype
    p_scale = 2.0 ** 15 if dtype is torch.float16 else 1.0
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = d ** -0.5
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # b,h,s,d
    out = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, block_q):
        qt = qf[:, :, q0:q0 + block_q]
        rows = torch.arange(q0, q0 + qt.shape[2], device=q.device)[:, None]
        m = torch.full(qt.shape[:3] + (1,), NEG_BIG, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qt.shape[:3] + (d,), device=q.device)
        k_end = min(sk, q0 + qt.shape[2]) if causal else sk
        for k0 in range(0, k_end, block_k):
            kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
            s = (qt @ kt.transpose(-1, -2)) * scale
            if causal:
                keys = torch.arange(k0, k0 + kt.shape[2],
                                    device=q.device)[None, :]
                s = torch.where(rows >= keys, s, NEG_BIG)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            m = m_new
            p = p * p_scale
            p_hi = p.to(dtype).float()
            acc = acc * corr + p_hi @ vt
            if split_p:
                acc = acc + (p - p_hi).to(dtype).float() @ vt
        out[:, :, q0:q0 + block_q] = acc / p_scale / l.clamp_min(1e-30)
    return out.transpose(1, 2).to(dtype)


def kernel_takes(head_dim: int) -> bool:
    """The kernel's shape rule: the head dimension is a multiple of 8 and at
    most 256 (any ``sq`` and ``sk``: ragged tiles are masked)."""
    return head_dim % 8 == 0 and 0 < head_dim <= MAX_HEAD_DIM


@functools.lru_cache(maxsize=None)
def _kernel_entry():
    """``nns_flash_attention`` from the built library, with its C types
    declared (built at first use)."""
    fn = _build.load("flash_attention").nns_flash_attention
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _vector_ready(t: torch.Tensor) -> bool:
    """True when the kernel may read ``t`` in place (16-byte loads for f32,
    TMA for bf16/f16): unit stride along d, and the base and the b/s/h
    strides 16-byte aligned."""
    per16 = 16 // t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0 and
            all(t.stride(i) % per16 == 0 for i in range(3)))


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k and v must be "
                         "[batch, seq, heads, dim]")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or \
            q.shape[2:] != k.shape[2:]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "match")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention on ``[batch, seq, heads, dim]`` tensors: the plain version
    for a CPU tensor, the kernel for a CUDA tensor its shape rule takes,
    and an error for any other."""
    _check(q, k, v)
    if q.device.type in ("cpu", "meta"):
        return attention_reference(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must be on one device")
    d = q.shape[-1]
    if not kernel_takes(d):
        raise ValueError(f"flash_attention: the kernel takes a head "
                         f"dimension that is a multiple of 8 and at most "
                         f"{MAX_HEAD_DIM}, got {d}; call "
                         "attention_reference for plain attention")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k and v must share one of "
                        f"float32, bfloat16, float16; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    if sk == 0:
        raise ValueError("flash_attention: no keys")
    # a fresh allocation is aligned; .contiguous() may return a
    # misaligned contiguous view as it is
    q, k, v = (t if _vector_ready(t) else torch.empty_like(
        t, memory_format=torch.contiguous_format).copy_(t) for t in (q, k, v))
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    args = _Args(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 b, h, sq, sk, d, int(bool(causal)), d ** -0.5)
    rc = _build.call_on_stream(_kernel_entry(), q.device,
                               ctypes.addressof(args), DTYPE_CODES[q.dtype])
    if rc != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with "
                           f"CUDA error {rc}")
    count_launch("flash_attention")
    return o
