"""Image preprocess — uint8 frame → normalized float, one pass on the card.

Port of the TPU kernel ``nnstreamer_tpu/ops/preprocess.py::_kernel``
(kernel B1 in ROADMAP.md). The CUDA kernel (``csrc/normalize.cu``)
evaluates a chain of up to 8 ``(op, value)`` pairs (``add``, ``sub``,
``mul``, ``div``) per element in fp32, in order, and rounds once to the
output type; an input of any numeric type is converted to fp32 first, as
the JAX function's ``astype(jnp.float32)`` converts it. :func:`normalize_u8`
is the chain ``sub mean, mul scale``; ``tensor_transform``'s arithmetic
chain ``typecast:float32,add:A,div:D`` is the chain ``add A, div D`` — the
transform's per-frame kernel on the main path.

Beside it, :func:`normalize_chain_reference` does the same fp32 per-op
math in plain PyTorch. The wrapper :func:`normalize_chain` takes the plain
version only for a tensor on the CPU; for a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from nnstreamer_tpu_torch.ops import _build
from nnstreamer_tpu_torch.ops._counts import (  # noqa: F401 (re-exported)
    LAUNCHES,
    count_launch,
    reset_launches,
)

CHAIN_MAX = 8
#: opcodes and dtype codes shared with csrc/normalize.cu: every numeric
#: input type (a bool as 0 or 1), and three output types
OPCODES = {"add": 0, "sub": 1, "mul": 2, "div": 3}
IN_CODES = {
    torch.uint8: 0, torch.float32: 1, torch.bfloat16: 2, torch.float16: 3,
    torch.int8: 4, torch.int16: 5, torch.int32: 6, torch.int64: 7,
    torch.uint16: 8, torch.uint32: 9, torch.uint64: 10, torch.float64: 11,
    torch.bool: 12,
}
OUT_CODES = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}
#: ``normalize_u8``'s ``force`` values; JAX's ``"pallas"`` has no
#: counterpart (the kernel is what a CUDA tensor takes) and raises
FORCES = (None, "reference")

_TORCH_OPS = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
              "div": torch.div}


class _Chain(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int),
                ("op", ctypes.c_int * CHAIN_MAX),
                ("val", ctypes.c_float * CHAIN_MAX)]


def _check_ops(ops: Sequence[Tuple[str, float]]) -> None:
    if len(ops) > CHAIN_MAX:
        raise ValueError(f"normalize_chain: at most {CHAIN_MAX} ops, "
                         f"got {len(ops)}")
    for op, _ in ops:
        if op not in OPCODES:
            raise ValueError(f"normalize_chain: unknown op {op!r}")


def normalize_chain_reference(x: torch.Tensor,
                              ops: Sequence[Tuple[str, float]],
                              out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version: cast to fp32, apply each op in order with an fp32
    operand (tensor-tensor ops, so division stays IEEE division), round
    once to ``out_dtype``."""
    _check_ops(ops)
    y = x.to(torch.float32)
    for op, val in ops:
        y = _TORCH_OPS[op](y, torch.tensor(val, dtype=torch.float32,
                                           device=y.device))
    return y.to(out_dtype)


def build_chain(ops: Sequence[Tuple[str, float]]) -> _Chain:
    """The kernel's chain struct for ``ops`` (checked here)."""
    _check_ops(ops)
    chain = _Chain()
    chain.n = len(ops)
    for k, (op, val) in enumerate(ops):
        chain.op[k] = OPCODES[op]
        chain.val[k] = float(val)
    return chain


def _cached_chain(ops: Sequence[Tuple[str, float]]) -> Tuple[_Chain, int]:
    """The chain struct of ``ops``, built and checked once, and its
    address (the struct stays alive in the cache). The cache is keyed by
    each value's bits: -0.0 equals 0.0 and has its hash, but a chain that
    divides by it gives -inf where the other gives +inf."""
    return _chain_by_bits(tuple((op, struct.pack("<d", val))
                                for op, val in ops))


@functools.lru_cache(maxsize=256)
def _chain_by_bits(key: Tuple[Tuple[str, bytes], ...]
                   ) -> Tuple[_Chain, int]:
    chain = build_chain([(op, struct.unpack("<d", bits)[0])
                         for op, bits in key])
    return chain, ctypes.addressof(chain)


class NormalizePlan(NamedTuple):
    """How the kernel covers n elements: vectors of ``ept`` elements (1, 4
    or 16) over ``blocks`` blocks of ``threads``, in a grid-stride loop."""
    ept: int
    blocks: int
    threads: int


#: threads a block, and blocks an SM in one full wave (2048 threads an SM)
THREADS = 256
WAVE_BLOCKS_PER_SM = 8
#: passes of one wave the grid-stride loop may take over 4-element vectors
#: before the plan switches to 16-element ones (tools/plan_sweep.py on an
#: H100: 4 a thread is faster at 8 frames, 1.14 passes; 16 from 2 passes
#: on, where 4 a thread leaves the loads of a pass's threads too few)
PASSES_OF_4_MAX = 1.5


@functools.lru_cache(maxsize=1024)
def normalize_plan(n: int, aligned: bool, sms: int = 132) -> NormalizePlan:
    """Launch plan for ``n`` elements on a card of ``sms`` SMs: 4 elements
    a thread while that takes at most ``PASSES_OF_4_MAX`` passes of one
    wave (the 224x224x3 frame: 147 blocks), 16 above it, single elements
    when x is not 16-byte aligned; at most one wave of blocks, the rest by
    the grid-stride loop (see csrc/normalize.cu)."""
    wave = sms * WAVE_BLOCKS_PER_SM
    if not aligned:
        ept = 1
    elif n // 4 <= PASSES_OF_4_MAX * wave * THREADS:
        ept = 4
    else:
        ept = 16
    vectors = n // ept
    return NormalizePlan(ept, max(1, min(wave, -(-vectors // THREADS))),
                         THREADS)


@functools.lru_cache(maxsize=None)
def _kernel_entry():
    """``nns_normalize_chain`` from the built library, with its C types
    declared (built at first use)."""
    fn = _build.load("normalize").nns_normalize_chain
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def normalize_chain(x: torch.Tensor, ops: Sequence[Tuple[str, float]],
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Apply an ``(op, value)`` chain elementwise: ``x`` of any numeric
    type (contiguous), first converted to float32 as ``.to(torch.float32)``
    converts it, result ``out_dtype`` (float32, bfloat16 or float16) of the
    same shape. CPU tensors take the plain version; CUDA tensors the
    kernel. The chain struct is built once per ``ops`` and cached."""
    device = x.device
    if device.type == "cpu":
        return normalize_chain_reference(x, ops, out_dtype)
    if device.type != "cuda":
        _check_ops(ops)
        raise ValueError(f"normalize_chain: no kernel for device {device}")
    _, chain_ptr = _cached_chain(ops)
    in_code = IN_CODES.get(x.dtype)
    if in_code is None:
        raise TypeError(f"normalize_chain: no kernel for input type "
                        f"{x.dtype}")
    out_code = OUT_CODES.get(out_dtype)
    if out_code is None:
        raise TypeError(f"normalize_chain: output must be float32, bfloat16 "
                        f"or float16, got {out_dtype}")
    if not x.is_contiguous():
        raise ValueError("normalize_chain: input must be contiguous")
    y = torch.empty(x.shape, dtype=out_dtype, device=device)
    n = x.numel()
    xp = x.data_ptr()
    plan = normalize_plan(n, xp % 16 == 0, _build.sm_count(device.index))
    rc = _build.call_on_stream(
        _kernel_entry(), device, xp, in_code, y.data_ptr(), out_code, n,
        chain_ptr, plan.ept, plan.blocks)
    if rc != 0:
        raise RuntimeError(f"normalize_chain: kernel launch failed with "
                           f"CUDA error {rc}")
    count_launch("normalize_chain")
    return y


def normalize_u8(x: torch.Tensor, mean: float = 127.5,
                 scale: float = 1.0 / 127.5,
                 out_dtype: torch.dtype = torch.bfloat16,
                 force: Optional[str] = None) -> torch.Tensor:
    """``(x - mean) * scale`` → ``out_dtype``, for an input of any shape
    and numeric type (the API of ``nnstreamer_tpu.ops.normalize_u8``).
    ``force=None`` takes the kernel on a CUDA tensor and the plain version
    on a CPU tensor; ``"reference"`` the plain version on any device. The
    JAX function's ``"pallas"`` raises, as ``quantize_int8``'s does
    (ROADMAP.md C.6, C.8)."""
    if force not in FORCES:
        raise ValueError(f"normalize_u8: force must be one of {FORCES}, "
                         f"got {force!r}: a CUDA tensor takes the kernel "
                         f"with force=None (ROADMAP.md C.6, C.8)")
    ops = [("sub", mean), ("mul", scale)]
    if force == "reference":
        return normalize_chain_reference(x, ops, out_dtype)
    return normalize_chain(x, ops, out_dtype)
