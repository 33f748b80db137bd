"""Image preprocess — uint8 frame → normalized float, one pass on the card.

Port of the TPU kernel ``nnstreamer_tpu/ops/preprocess.py::_kernel``
(kernel B1 in ROADMAP.md). The CUDA kernel (``csrc/normalize.cu``)
evaluates a chain of up to 8 ``(op, value)`` pairs (``add``, ``sub``,
``mul``, ``div``) per element in fp32, in order, and rounds once to the
output type. :func:`normalize_u8` is the chain ``sub mean, mul scale``;
``tensor_transform``'s arithmetic chain ``typecast:float32,add:A,div:D``
is the chain ``add A, div D`` — the transform's per-frame kernel on the
main path.

Beside it, :func:`normalize_chain_reference` does the same fp32 per-op
math in plain PyTorch. The wrapper :func:`normalize_chain` takes the plain
version only for a tensor on the CPU; for a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from nnstreamer_tpu_torch.ops._counts import (  # noqa: F401 (re-exported)
    LAUNCHES,
    count_launch,
    reset_launches,
)

CHAIN_MAX = 8
#: opcodes and dtype codes shared with csrc/normalize.cu
OPCODES = {"add": 0, "sub": 1, "mul": 2, "div": 3}
IN_CODES = {torch.uint8: 0, torch.float32: 1}
OUT_CODES = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}

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


@functools.lru_cache(maxsize=None)
def _kernel_entry():
    """``nns_normalize_chain`` from the built library, with its C types
    declared (built at first use)."""
    from nnstreamer_tpu_torch.ops import _build

    fn = _build.load("normalize").nns_normalize_chain
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def normalize_chain(x: torch.Tensor, ops: Sequence[Tuple[str, float]],
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Apply an ``(op, value)`` chain elementwise: ``x`` uint8 or float32
    (contiguous), result ``out_dtype`` (float32, bfloat16 or float16) of
    the same shape. CPU tensors take the plain version; CUDA tensors the
    kernel."""
    _check_ops(ops)
    if x.device.type == "cpu":
        return normalize_chain_reference(x, ops, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"normalize_chain: no kernel for device {x.device}")
    if x.dtype not in IN_CODES:
        raise TypeError(f"normalize_chain: input must be uint8 or float32, "
                        f"got {x.dtype}")
    if out_dtype not in OUT_CODES:
        raise TypeError(f"normalize_chain: output must be float32, bfloat16 "
                        f"or float16, got {out_dtype}")
    if not x.is_contiguous():
        raise ValueError("normalize_chain: input must be contiguous")
    fn = _kernel_entry()
    chain = _Chain()
    chain.n = len(ops)
    for k, (op, val) in enumerate(ops):
        chain.op[k] = OPCODES[op]
        chain.val[k] = float(val)
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    vectorized = int(x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), IN_CODES[x.dtype], y.data_ptr(),
                OUT_CODES[out_dtype], x.numel(), ctypes.addressof(chain),
                vectorized, stream)
    if rc != 0:
        raise RuntimeError(f"normalize_chain: kernel launch failed with "
                           f"CUDA error {rc}")
    count_launch("normalize_chain")
    return y


def normalize_u8(x: torch.Tensor, mean: float = 127.5,
                 scale: float = 1.0 / 127.5,
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``(x - mean) * scale`` → ``out_dtype``, for any-shape input (the
    API of ``nnstreamer_tpu.ops.normalize_u8``)."""
    return normalize_chain(x, [("sub", mean), ("mul", scale)], out_dtype)
