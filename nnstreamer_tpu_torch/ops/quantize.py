"""Int8 tensor quantization — bandwidth compression for tensor streams.

Port of the TPU kernels ``nnstreamer_tpu/ops/quantize.py::_quant_kernel_prng``
and ``::_quant_kernel_dither`` (kernel B3 in ROADMAP.md), with the absmax
reduction the JAX wrapper runs outside them. Per-tensor absmax int8:
``scale = max(max|x| / 127, 1e-30)``, then either

- **nearest** (the JAX reference path, ``_quantize_reference``):
  ``q = clip(round(x / scale), -127, 127)``, round half to even — what the
  ``tensor_quant_enc`` codec ships; or
- **dither** (the TPU kernel): ``q = clip(round(clip(x * (1 / scale), ±127)
  + d), ±127)`` with a uniform dither ``d = int32(bits) * 2**-32`` in
  [-0.5, 0.5], so repeated quantization of a stream is unbiased.

The CUDA kernel (``csrc/quantize.cu``) computes absmax, scale and q in one
cooperative launch on the caller's stream: each block stages its slice of
x in shared memory and the blocks meet at a grid barrier;
:func:`quantize_plan` picks the slices. q and the scale are views of one
allocation. Its dither bits
come from Philox4x32-10 with key ``(seed lo, seed hi)`` and counter
``(i // 4 lo, i // 4 hi, 0, 0)`` — word ``i % 4`` for element ``i`` — so
they depend on the element's index alone. The TPU seeds its core PRNG
with ``seed + program_id``, whose bits no other device reproduces; the
two dithered functions agree in distribution, not bit for bit.

Beside it, :func:`quantize_nearest_reference` and
:func:`quantize_dither_reference` are the plain versions (the second runs
the same Philox in int64 torch ops). :func:`quantize_int8` takes a plain
version only for a tensor on the CPU; for a CUDA tensor it launches the
kernel or raises. ``force`` picks the function:

- ``None``: dithered on a CUDA tensor (as the JAX function dithers on a
  TPU), nearest on a CPU tensor (as the JAX function rounds on a CPU);
- ``"reference"``: nearest on any device (on CUDA the kernel's nearest
  mode);
- ``"dither"``: dithered on any device (on the CPU the plain version). It
  takes the place of the JAX function's ``force="pallas"``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from nnstreamer_tpu_torch.ops import _build
from nnstreamer_tpu_torch.ops._counts import count_launch

#: dtype codes shared with csrc/quantize.cu
IN_CODES = {
    torch.uint8: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
    torch.int64: 4, torch.float16: 5, torch.bfloat16: 6, torch.float32: 7,
    torch.float64: 8,
}
FORCES = (None, "reference", "dither")
SCALE_FLOOR = 1e-30

# Philox4x32-10 constants (Salmon et al., SC'11; Random123)
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _f32(value: float, device) -> torch.Tensor:
    """A 0-dim f32 operand on ``device``: tensor-tensor ops keep division
    IEEE division (torch on CUDA multiplies by a CPU scalar's reciprocal)."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def _empty_result(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.empty(x.shape, dtype=torch.int8, device=x.device),
            torch.full((1,), SCALE_FLOOR, dtype=torch.float32,
                       device=x.device))


def _scale(xf: torch.Tensor) -> torch.Tensor:
    """``max(max|x| / 127, 1e-30)`` as a 0-dim f32 tensor (NaN stays)."""
    s = xf.abs().max() / _f32(127.0, xf.device)
    return torch.maximum(s, _f32(SCALE_FLOOR, xf.device))


def _to_int8(r: torch.Tensor) -> torch.Tensor:
    """Rounded, clamped f32 values to int8; NaN (from a NaN or an inf in
    x) becomes 0, as XLA's and numpy's casts give it."""
    return torch.nan_to_num(r, nan=0.0).to(torch.int8)


def quantize_nearest_reference(x: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain nearest quantize: ``(int8 q of x's shape, f32 scale [1])``,
    the JAX package's ``_quantize_reference`` in f32 torch ops."""
    if x.numel() == 0:
        return _empty_result(x)
    xf = x.to(torch.float32)
    scale = _scale(xf)
    q = _to_int8(torch.clamp(torch.round(xf / scale), -127, 127))
    return q, scale.reshape(1)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 values + scale → float32, on ``q``'s device."""
    return q.to(torch.float32) * scale.reshape(())


def _round_dithered(scaled: torch.Tensor, dither: torch.Tensor
                    ) -> torch.Tensor:
    """Stochastic round to int8: a uniform dither in [-0.5, 0.5) before the
    nearest round has the expectation of true stochastic rounding (port of
    the JAX package's ``_round_dithered``)."""
    return _to_int8(torch.clamp(torch.round(scaled + dither), -127, 127))


def _mulhilo32(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low 32 bits of ``a * m`` for an int64 tensor of uint32
    values and a uint32 constant. 16-bit limbs keep every partial product
    below 2**32, so no int64 product overflows."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    ll, lh = a_lo * m_lo, a_lo * m_hi
    hl, hh = a_hi * m_lo, a_hi * m_hi
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def philox4x32_10(counter, key: Tuple[int, int]):
    """Philox4x32-10 on int64 tensors holding uint32 words: ``counter`` is
    four tensors (or ints) of one shape, ``key`` two uint32 ints. Returns
    the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo32(c0, _M0)
        hi1, lo1 = _mulhilo32(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dither_bits(n: int, seed: int, device) -> torch.Tensor:
    """The kernel's ``n`` dither words (int64 tensor of uint32 values):
    element ``i`` takes word ``i % 4`` of Philox at counter ``i // 4``."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    g = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(g)
    words = philox4x32_10((g & _MASK32, g >> 32, zero, zero),
                          (seed & _MASK32, seed >> 32))
    return torch.stack(words, dim=1).reshape(-1)[:n]


def dither_values(n: int, seed: int, device) -> torch.Tensor:
    """``f32(int32(bits)) * 2**-32`` for the kernel's ``n`` dither words."""
    bits = dither_bits(n, seed, device)
    signed = (bits - ((bits >> 31) << 32)).to(torch.int32)
    return signed.to(torch.float32) * _f32(2.0 ** -32, device)


def quantize_dither_reference(x: torch.Tensor, seed: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain dithered quantize, bit for bit the kernel's dither mode."""
    if x.numel() == 0:
        return _empty_result(x)
    xf = x.to(torch.float32)
    scale = _scale(xf)
    inv = _f32(1.0, x.device) / scale
    scaled = torch.clamp(xf * inv, -127.0, 127.0)
    dither = dither_values(x.numel(), seed, x.device).reshape(x.shape)
    return _round_dithered(scaled, dither), scale.reshape(1)


#: kernel geometry shared with csrc/quantize.cu: threads a block (512
#: where each block keeps its slice on chip, 1024 where x is read twice and
#: more loads in flight pay: tools/plan_sweep.py) and dynamic shared
#: memory a block may take
THREADS = 512
THREADS_READ_TWICE = 1024
SMEM_MAX = 224 * 1024
#: q's byte offset in the output buffer (the scale sits at 0)
Q_OFFSET = 16


def _round16(v: int) -> int:
    return -(-v // 16) * 16


class QuantPlan(NamedTuple):
    """How the kernel covers n elements: ``blocks`` blocks of ``threads``,
    block b owning elements ``[b * chunk, min(n, (b + 1) * chunk))``
    (``chunk`` a multiple of 16) and keeping the first ``kept`` of them in
    ``smem`` bytes of shared memory; ``buffer`` bytes hold the scale, q
    and one max word a block."""
    blocks: int
    threads: int
    chunk: int
    kept: int
    smem: int
    buffer: int


def kept_per_block(elem_size: int, smem_max: int = SMEM_MAX) -> int:
    """Elements of ``elem_size`` bytes a block can keep: 16 bytes of the
    shared memory go to the shift that aligns the slice's bulk copy."""
    return (smem_max - 16) // elem_size // 16 * 16


def quantize_plan(n: int, elem_size: int, sms: int = 132,
                  smem_max: int = SMEM_MAX) -> QuantPlan:
    """Launch plan for ``n`` elements of ``elem_size`` bytes on a card of
    ``sms`` SMs: one block an SM, each keeping its whole slice while
    ``smem_max`` bytes hold it and none of it past that (see
    csrc/quantize.cu)."""
    chunk = _round16(-(-n // sms))
    blocks = -(-n // chunk)
    kept = chunk if chunk <= kept_per_block(elem_size, smem_max) else 0
    return QuantPlan(blocks, THREADS if kept else THREADS_READ_TWICE,
                     chunk, kept, kept * elem_size + 16,
                     Q_OFFSET + _round16(n) + 4 * blocks)


def block_slices(plan: QuantPlan, n: int) -> List[Tuple[int, int, int]]:
    """``(start, kept_end, end)`` of each block's slice, as the kernel
    computes them: ``[start, kept_end)`` in shared memory, the rest read
    from device memory."""
    out = []
    for b in range(plan.blocks):
        start = b * plan.chunk
        end = min(n, start + plan.chunk)
        out.append((start, start + min(end - start, plan.kept), end))
    return out


def _entry(name: str, argtypes):
    """A C entry point of the built library with its C types declared
    (built at first use)."""
    fn = getattr(_build.load("quantize"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _prepare_entry():
    return _entry("nns_quantize_prepare", [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)])


@functools.lru_cache(maxsize=None)
def _kernel_entry():
    return _entry("nns_quantize_int8", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p])


@functools.lru_cache(maxsize=1024)
def device_plan(n: int, dtype: torch.dtype, dither: bool,
                index: int) -> QuantPlan:
    """The plan for ``n`` elements of ``dtype`` on CUDA device ``index``,
    made once: the kernel is given its shared memory, and a plan with more
    blocks than the card can hold at once (by the occupancy calculator)
    raises."""
    elem_size = torch.empty((), dtype=dtype).element_size()
    sms = _build.sm_count(index)
    plan = quantize_plan(n, elem_size, sms)
    fit = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = _prepare_entry()(IN_CODES[dtype], int(dither), plan.threads,
                              plan.smem, ctypes.byref(fit))
    if rc != 0:
        raise RuntimeError(f"quantize_int8: preparing the kernel failed "
                           f"with CUDA error {rc}")
    if fit.value * sms < plan.blocks:
        raise RuntimeError(
            f"quantize_int8: the card cannot hold {plan.blocks} blocks with "
            f"{plan.smem} B of shared memory each at once (occupancy "
            f"{fit.value} an SM)")
    return plan


def quantize_int8(x: torch.Tensor, seed: int = 0,
                  force: Optional[str] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor absmax int8: ``(int8 q of x's shape, f32 scale [1])``,
    both on ``x``'s device. See the module docstring for ``force``."""
    if force not in FORCES:
        raise ValueError(f"quantize_int8: force must be one of {FORCES}, "
                         f"got {force!r}")
    dither = force == "dither" or (force is None and x.device.type == "cuda")
    device = x.device
    if device.type == "cpu":
        if dither:
            return quantize_dither_reference(x, seed)
        return quantize_nearest_reference(x)
    if device.type != "cuda":
        raise ValueError(f"quantize_int8: no kernel for device {device}")
    code = IN_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"quantize_int8: no kernel for {x.dtype} (takes "
                        f"{', '.join(str(d) for d in IN_CODES)})")
    n = x.numel()
    if n == 0:
        return _empty_result(x)
    x = x.contiguous()
    plan = device_plan(n, x.dtype, dither, device.index)
    buf = torch.empty(plan.buffer, dtype=torch.int8, device=device)
    base = buf.data_ptr()
    rc = _build.call_on_stream(
        _kernel_entry(), device, x.data_ptr(), code, n, base + Q_OFFSET,
        base, base + Q_OFFSET + _round16(n), int(dither),
        int(seed) & 0xFFFFFFFFFFFFFFFF, plan.blocks, plan.threads,
        plan.chunk, plan.kept, plan.smem)
    if rc != 0:
        raise RuntimeError(f"quantize_int8: kernel launch failed with CUDA "
                           f"error {rc}")
    count_launch("quantize_int8")
    # x is contiguous, so its strides are q's
    return (buf.as_strided(x.shape, x.stride(), Q_OFFSET),
            buf[:4].view(torch.float32))
