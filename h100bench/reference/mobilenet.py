"""MobileNetV2's parts in plain PyTorch (Sandler et al., arXiv:1801.04381):
``SAME``-padded convolutions, eval BatchNorm, ReLU6, inverted residuals
with linear bottlenecks. Written from the paper and TF's ``SAME`` rule,
not from the port: NHWC uint8 frames in, float32 (or the fp8 control)
arithmetic, parameters by name from a dict.

Parameter names follow one scheme (``stem``, ``stem_bn``,
``blocks.<k>.convs.<i>``, ``blocks.<k>.bns.<i>``, ...), which the
configuration files map onto the port's modules.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
#: the largest finite float8 e4m3 value
FP8_MAX = 448.0

Spec = Tuple[str, Tuple[int, ...], tuple]


def make_divisible(v: float, divisor: int = 8) -> int:
    """TF-slim's channel rounding."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of TF's ``SAME`` along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def fp8(x: torch.Tensor, per_row: bool = False) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 with a scale that maps its
    absolute maximum (per tensor, or per leading index) to 448."""
    if per_row:
        amax = x.abs().flatten(1).amax(1).view(-1, *([1] * (x.dim() - 1)))
    else:
        amax = x.abs().amax()
    s = (amax / FP8_MAX).clamp_min(1e-30)
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Params:
    """Parameters by name, upcast to float32 as they are read; with
    ``control`` every convolution and dense layer reads its weights and
    its input through :func:`fp8` (the lower-precision control)."""

    def __init__(self, weights: Dict[str, torch.Tensor],
                 control: bool = False):
        self.w = weights
        self.control = control

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.w[name].to(torch.float32)


def conv(p: Params, name: str, x: torch.Tensor, stride: int = 1,
         groups: int = 1, bias: bool = False) -> torch.Tensor:
    """A ``SAME`` convolution of NCHW ``x`` with ``p[name.weight]``."""
    w = p[f"{name}.weight"]
    b = p[f"{name}.bias"] if bias else None
    if p.control:
        x, w = fp8(x), fp8(w, per_row=True)
    k = w.shape[-1]
    top, bottom = same_pads(x.shape[2], k, stride)
    left, right = same_pads(x.shape[3], k, stride)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w, b, stride=stride, groups=groups)


def bn(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """Eval BatchNorm over NCHW channels."""
    shape = (1, -1, 1, 1)
    scale = p[f"{name}.weight"] / torch.sqrt(
        p[f"{name}.running_var"] + BN_EPS)
    return (x - p[f"{name}.running_mean"].view(shape)) * \
        scale.view(shape) + p[f"{name}.bias"].view(shape)


def dense(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    w = p[f"{name}.weight"]
    if p.control:
        x, w = fp8(x), fp8(w, per_row=True)
    return x @ w.t() + p[f"{name}.bias"]


def blocks(stages: List[List[int]], cin: int, width: float = 1.0
           ) -> Iterator[Tuple[int, int, int, int]]:
    """``(cin, cout, stride, expand)`` of each inverted residual of the
    stage table ``[[expand, channels, repeats, stride], ...]``."""
    for expand, out, repeats, stride in stages:
        out = make_divisible(out * width)
        for i in range(repeats):
            yield cin, out, stride if i == 0 else 1, expand
            cin = out


def conv_specs(name: str, cin: int, cout: int, k: int, groups: int = 1,
               bias: bool = False) -> List[Spec]:
    """A convolution's weight, normal with std 1/sqrt(fan_in) as the
    port's models draw theirs, and (with ``bias``) a bias of std 0.05."""
    fan_in = cin // groups * k * k
    out = [(f"{name}.weight", (cout, cin // groups, k, k),
            ("normal", 1.0 / math.sqrt(fan_in)))]
    if bias:
        out.append((f"{name}.bias", (cout,), ("normal", 0.05)))
    return out


def bn_specs(name: str, c: int, shift: float = 0.05) -> List[Spec]:
    """BatchNorm statistics near identity, drawn, so that a path that
    skipped or folded them wrongly would show: scale and variance
    U(0.75, 1.25), shift and mean normal with std ``shift`` (0: none)."""
    return [(f"{name}.weight", (c,), ("uniform", 0.75, 1.25)),
            (f"{name}.bias", (c,), ("normal", shift) if shift else
             ("const", 0.0)),
            (f"{name}.running_mean", (c,), ("normal", shift) if shift else
             ("const", 0.0)),
            (f"{name}.running_var", (c,), ("uniform", 0.75, 1.25)),
            (f"{name}.num_batches_tracked", (), ("const", 0))]


def block_specs(k: int, cin: int, cout: int, expand: int,
                shift: float = 0.05) -> List[Spec]:
    hidden = cin * expand
    out: List[Spec] = []
    i = 0
    if expand != 1:
        out += conv_specs(f"blocks.{k}.convs.{i}", cin, hidden, 1)
        out += bn_specs(f"blocks.{k}.bns.{i}", hidden, shift)
        i += 1
    out += conv_specs(f"blocks.{k}.convs.{i}", hidden, hidden, 3,
                      groups=hidden)
    out += bn_specs(f"blocks.{k}.bns.{i}", hidden, shift)
    i += 1
    out += conv_specs(f"blocks.{k}.convs.{i}", hidden, cout, 1)
    out += bn_specs(f"blocks.{k}.bns.{i}", cout, shift)
    return out


def block(p: Params, k: int, x: torch.Tensor, cin: int, cout: int,
          stride: int, expand: int) -> torch.Tensor:
    """Expand 1×1 (unless ``expand == 1``), depthwise 3×3, project 1×1;
    ReLU6 after all but the projection; the input added back where the
    shape is kept."""
    hidden = cin * expand
    y, i = x, 0
    if expand != 1:
        y = F.relu6(bn(p, f"blocks.{k}.bns.{i}",
                       conv(p, f"blocks.{k}.convs.{i}", y)))
        i += 1
    y = F.relu6(bn(p, f"blocks.{k}.bns.{i}",
                   conv(p, f"blocks.{k}.convs.{i}", y, stride,
                        groups=hidden)))
    i += 1
    y = bn(p, f"blocks.{k}.bns.{i}", conv(p, f"blocks.{k}.convs.{i}", y))
    return x + y if stride == 1 and cin == cout else y


def preprocess(frames: torch.Tensor, add: float, div: float
               ) -> torch.Tensor:
    """NHWC uint8 frames → NCHW float32 ``(x + add) / div``."""
    return ((frames.to(torch.float32) + add) / div).permute(0, 3, 1, 2)


def conv_flops(h: int, w: int, cin: int, cout: int, k: int, stride: int,
               groups: int = 1) -> Tuple[float, int, int]:
    """FLOPs (2 a multiply-add) of a ``SAME`` convolution on an ``h×w``
    input, and its output size."""
    ho, wo = -(-h // stride), -(-w // stride)
    return 2.0 * ho * wo * cout * (cin // groups) * k * k, ho, wo


def blocks_flops(stages, h: int, w: int, cin: int
                 ) -> Tuple[float, int, int, int, List[Tuple[int, int, int]]]:
    """FLOPs of the inverted residuals, the output size and channels, and
    ``(h, w, channels)`` after each stage."""
    total, ends = 0.0, []
    for expand, out, repeats, stride in stages:
        for i in range(repeats):
            s = stride if i == 0 else 1
            hidden = cin * expand
            if expand != 1:
                total += conv_flops(h, w, cin, hidden, 1, 1)[0]
            f, h, w = conv_flops(h, w, hidden, hidden, 3, s, hidden)
            total += f
            total += conv_flops(h, w, hidden, out, 1, 1)[0]
            cin = out
        ends.append((h, w, cin))
    return total, h, w, cin, ends
