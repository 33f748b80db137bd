"""Kernel B1, ``normalize_chain_kernel`` (``csrc/normalize.cu``): the
transform's chain ``typecast:float32, add, div`` over every element of
a launch, uint8 in and float32 out.

Its least time is the larger of its bytes over HBM's bandwidth and its
operations over the CUDA cores' float32 rate: each input byte read once,
each output element written once, one add and one divide an element. At
any frame size the bytes bound it (5 bytes against 2 FLOPs an element)."""

from h100bench import peaks

IN_BYTES = 1
OUT_BYTES = 4
OPS_PER_ELEMENT = 2


def bytes_moved(elements: int) -> float:
    return float(elements) * (IN_BYTES + OUT_BYTES)


def operations(elements: int) -> float:
    return float(elements) * OPS_PER_ELEMENT


def bound_seconds(elements: int) -> float:
    return max(bytes_moved(elements) / peaks.HBM_BYTES_PER_S,
               operations(elements) / peaks.FLOPS["float32"])
