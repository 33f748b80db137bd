"""MobileNetV2 — the flagship classification model, as an ``nn.Module``.

The architecture of the JAX package's model (Sandler et al. 2018:
inverted residuals, linear bottlenecks): the same ``_make_divisible``
channel rounding and CFG table, eval-mode BatchNorm (eps 1e-5, as there),
ReLU6, global mean pool and a dense classifier.

- NHWC at the public boundary (``in_info`` ``3:224:224:B``, float32);
  ``x.permute(0, 3, 1, 2)`` gives channels_last strides with no copy, and
  the weights are kept channels_last so the convolutions stay NHWC.
- The compute dtype is the parameters' dtype (bfloat16 by default); the
  logits come back as float32.
- The JAX package's ``padding="SAME"`` pads a stride-2 3×3 convolution
  asymmetrically (for a 224 input the pads are (0, 1)); the stride-2
  convolutions here compute the SAME pads from the input size and pad
  explicitly.
- :func:`params_from_jax` maps the JAX package's variable tree (as
  numpy arrays) onto this module's ``state_dict``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from nnstreamer_tpu_torch.tensors.types import TensorsInfo

BN_EPS = 1e-5


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of ``SAME`` (the JAX package's and TF's rule)
    along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with the JAX package's ``SAME`` padding, computed per input size
    (stride 1 and odd kernels pad symmetrically, so they use the conv's
    own padding). No bias unless ``bias`` (the JAX layer's ``use_bias``)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = False):
        sym = stride == 1
        super().__init__(cin, cout, kernel, stride=stride,
                         padding=kernel // 2 if sym else 0, groups=groups,
                         bias=bias)
        self._explicit = not sym

    def forward(self, x):
        if self._explicit:
            kh, kw = self.kernel_size
            top, bottom = same_pads(x.shape[2], kh, self.stride[0])
            left, right = same_pads(x.shape[3], kw, self.stride[1])
            x = F.pad(x, (left, right, top, bottom))
        return super().forward(x)


class InvertedResidual(nn.Module):
    """expand 1×1 (when expand != 1) → depthwise 3×3 → project 1×1, each
    with eval BatchNorm; ReLU6 after all but the projection; residual add
    when the shape is kept."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, expand: int):
        super().__init__()
        hidden = in_ch * expand
        convs: List[nn.Module] = []
        if expand != 1:
            convs.append(SameConv2d(in_ch, hidden, 1))
        convs.append(SameConv2d(hidden, hidden, 3, stride, groups=hidden))
        convs.append(SameConv2d(hidden, out_ch, 1))
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(nn.BatchNorm2d(c.out_channels, eps=BN_EPS)
                                 for c in convs)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x):
        y = x
        last = len(self.convs) - 1
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            y = bn(conv(y))
            if i != last:
                y = F.relu6(y)
        return x + y if self.residual else y


class MobileNetV2(nn.Module):
    # (expand, out_ch, repeats, stride) — the paper's table 2
    CFG = [
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
    ]

    def __init__(self, num_classes: int = 1001, width: float = 1.0):
        super().__init__()
        ch = _make_divisible(32 * width)
        self.stem = SameConv2d(3, ch, 3, 2)
        self.stem_bn = nn.BatchNorm2d(ch, eps=BN_EPS)
        blocks = []
        for expand, out_ch, repeats, stride in self.CFG:
            out_ch = _make_divisible(out_ch * width)
            for i in range(repeats):
                blocks.append(InvertedResidual(ch, out_ch,
                                               stride if i == 0 else 1,
                                               expand))
                ch = out_ch
        self.blocks = nn.ModuleList(blocks)
        last = _make_divisible(1280 * max(width, 1.0))
        self.head = SameConv2d(ch, last, 1)
        self.head_bn = nn.BatchNorm2d(last, eps=BN_EPS)
        self.classifier = nn.Linear(last, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: NHWC images; returns float32 logits ``(N, classes)``."""
        x = x.to(self.classifier.weight.dtype).permute(0, 3, 1, 2)
        x = F.relu6(self.stem_bn(self.stem(x)))
        for block in self.blocks:
            x = block(x)
        x = F.relu6(self.head_bn(self.head(x)))
        x = x.mean(dim=(2, 3))  # global average pool
        return self.classifier(x).float()


def init_weights(module: MobileNetV2, generator: torch.Generator) -> None:
    """Random weights in the distribution of the JAX package's seeded
    ``fast_init``: kernels N(0, 1/sqrt(fan_in)), BatchNorm scale 1,
    bias 0, running mean 0, running var 1, dense bias 0."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, 1.0 / float(np.sqrt(fan_in)),
                                 generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)


def mobilenet_v2(num_classes: int = 1001, width: float = 1.0,
                 image_size: int = 224, batch: int = 1,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 device=None
                 ) -> Tuple[MobileNetV2, TensorsInfo, TensorsInfo]:
    """Factory: ``(module, in_info, out_info)``, the arguments
    ``register_torch_model(name, ...)`` takes after the name.

    Weights come from ``torch.Generator().manual_seed(seed)`` in float32
    on the CPU, then move to ``device`` (default: stay on the CPU; the
    filter moves them to its device at open) and ``dtype`` — so two calls
    with the same seed give the same weights, the bfloat16 ones being the
    float32 ones rounded. Input: float32 NHWC (the pipeline's
    tensor_transform owns preprocessing)."""
    module = MobileNetV2(num_classes=num_classes, width=width)
    init_weights(module, torch.Generator().manual_seed(seed))
    module = module.to(device=device, dtype=dtype,
                       memory_format=torch.channels_last).eval()
    in_info = TensorsInfo.from_str(
        f"3:{image_size}:{image_size}:{batch}", "float32")
    out_info = TensorsInfo.from_str(f"{num_classes}:{batch}", "float32")
    return module, in_info, out_info


def _conv_weight(kernel: np.ndarray) -> np.ndarray:
    """JAX HWIO (depthwise: (kh, kw, 1, C)) → torch OIHW ((C, 1, kh, kw))."""
    return np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1)))


# -- converters from the JAX package's variable trees ------------------------
# Each writes numpy arrays into ``out`` under this port's state_dict names;
# :func:`to_state_dict` turns the result into tensors. The models of the
# detection, pose and segmentation slice reuse them.
def jax_conv(out: Dict[str, np.ndarray], dst: str, src) -> None:
    """A JAX-package convolution (``kernel``, and ``bias`` where it has one)."""
    out[f"{dst}.weight"] = _conv_weight(np.asarray(src["kernel"]))
    if "bias" in src:
        out[f"{dst}.bias"] = np.asarray(src["bias"])


def jax_bn(out: Dict[str, np.ndarray], dst: str, p, s) -> None:
    """A JAX-package eval-mode BatchNorm: params ``p``, batch stats ``s``."""
    out[f"{dst}.weight"] = np.asarray(p["scale"])
    out[f"{dst}.bias"] = np.asarray(p["bias"])
    out[f"{dst}.running_mean"] = np.asarray(s["mean"])
    out[f"{dst}.running_var"] = np.asarray(s["var"])
    out[f"{dst}.num_batches_tracked"] = np.asarray(0, np.int64)


def jax_dense(out: Dict[str, np.ndarray], dst: str, src) -> None:
    """A JAX-package dense layer ((in, out) kernel) → ``nn.Linear``."""
    out[f"{dst}.weight"] = np.ascontiguousarray(np.asarray(src["kernel"]).T)
    out[f"{dst}.bias"] = np.asarray(src["bias"])


def jax_blocks(out: Dict[str, np.ndarray], params, stats,
               dst: str = "blocks") -> None:
    """Every ``InvertedResidual_k/{Conv_i, BatchNorm_i}`` (an ``expand ==
    1`` block has two convolutions, the others three) → ``{dst}.k``."""
    k = 0
    while f"InvertedResidual_{k}" in params:
        name = f"InvertedResidual_{k}"
        bp, bs = params[name], stats[name]
        i = 0
        while f"Conv_{i}" in bp:
            jax_conv(out, f"{dst}.{k}.convs.{i}", bp[f"Conv_{i}"])
            jax_bn(out, f"{dst}.{k}.bns.{i}", bp[f"BatchNorm_{i}"],
                   bs[f"BatchNorm_{i}"])
            i += 1
        k += 1


def to_state_dict(out: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Float32 CPU tensors (int64 for ``num_batches_tracked``)."""
    return {k: torch.from_numpy(np.array(v, dtype=np.int64
                                         if k.endswith("num_batches_tracked")
                                         else np.float32))
            for k, v in out.items()}


def params_from_jax(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's MobileNetV2 variables (``{"params": ...,
    "batch_stats": ...}``, leaves as numpy arrays) → this module's
    ``state_dict`` (float32 CPU tensors).

    The JAX package names modules in creation order: ``Conv_0`` and
    ``BatchNorm_0`` (stem), ``InvertedResidual_k`` (:func:`jax_blocks`),
    ``Conv_1`` and ``BatchNorm_1`` (head) and ``Dense_0``."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, np.ndarray] = {}
    jax_conv(out, "stem", params["Conv_0"])
    jax_bn(out, "stem_bn", params["BatchNorm_0"], stats["BatchNorm_0"])
    jax_blocks(out, params, stats)
    jax_conv(out, "head", params["Conv_1"])
    jax_bn(out, "head_bn", params["BatchNorm_1"], stats["BatchNorm_1"])
    jax_dense(out, "classifier", params["Dense_0"])
    return to_state_dict(out)
