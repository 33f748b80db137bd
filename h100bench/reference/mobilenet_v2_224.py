"""Reference of ``mobilenet_v2_224``: MobileNetV2 1.0 (arXiv:1801.04381,
TF-slim ``mobilenet_v2_1.0_224``) in plain PyTorch and float32, the
judge of the labels and scores a stream's sink received, and the fp8
control.

A served answer is a frame's label index and its score (the served
model's logit at that label). One number judges a set of answers against
the reference's logits ``L`` of the same frames: ``answer_gap``, the
widest over the frames of the larger of two gaps, in units of the frame's
logit standard deviation (so that it reads alike whatever scale the seed's
weights give the logits):

- the distance between the served score and ``L`` at the served label;
- how far ``L`` at the served label lies below ``L``'s best.

A wrong label shows in the second whatever score comes with it, a wrong
score in the first. The second alone does not separate bf16 from the fp8
control: both flip a label on too few seeds.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from h100bench.reference import mobilenet as mn

NUMBERS = ("answer_gap",)
#: BatchNorm shift and mean drawn (0: none)
SHIFT = 0.0
#: frames a block of the reference's forward pass
BLOCK = 64


def specs(cfg) -> List[mn.Spec]:
    """Every parameter: name, shape and how it is drawn."""
    width = float(cfg["width_multiplier"])
    ch = mn.make_divisible(cfg["stem_channels"] * width)
    # no BatchNorm shift or mean and a faint classifier bias: with them the
    # constant terms outweigh what is left of a frame after 53 layers, and
    # every frame would get the same answer
    out = mn.conv_specs("stem", cfg["channels"], ch, 3)
    out += mn.bn_specs("stem_bn", ch, SHIFT)
    k = 0
    for cin, cout, _, expand in mn.blocks(cfg["stages"], ch, width):
        out += mn.block_specs(k, cin, cout, expand, SHIFT)
        ch, k = cout, k + 1
    last = mn.make_divisible(cfg["last_channels"] * max(width, 1.0))
    out += mn.conv_specs("head", ch, last, 1)
    out += mn.bn_specs("head_bn", last, SHIFT)
    out += [("classifier.weight", (cfg["num_classes"], last),
             ("normal", 1.0 / math.sqrt(last))),
            ("classifier.bias", (cfg["num_classes"],), ("normal", 1e-4))]
    return out


def forward(cfg, weights: Dict[str, torch.Tensor], frames: torch.Tensor,
            control: bool = False) -> torch.Tensor:
    """NHWC uint8 frames → float32 logits ``[N, classes]``."""
    p = mn.Params(weights, control)
    width = float(cfg["width_multiplier"])
    pre = cfg["preprocess"]
    x = mn.preprocess(frames, pre["add"], pre["div"])
    x = F.relu6(mn.bn(p, "stem_bn", mn.conv(p, "stem", x, 2)))
    ch = mn.make_divisible(cfg["stem_channels"] * width)
    for k, (cin, cout, stride, expand) in enumerate(
            mn.blocks(cfg["stages"], ch, width)):
        x = mn.block(p, k, x, cin, cout, stride, expand)
    x = F.relu6(mn.bn(p, "head_bn", mn.conv(p, "head", x)))
    return mn.dense(p, "classifier", x.mean(dim=(2, 3)))


def logits(cfg, weights, frames, control: bool = False) -> torch.Tensor:
    """:func:`forward` in blocks of :data:`BLOCK` frames."""
    with torch.no_grad():
        return torch.cat([forward(cfg, weights, frames[i:i + BLOCK], control)
                          for i in range(0, frames.shape[0], BLOCK)])


def gaps(ref: torch.Tensor, served: Dict[str, torch.Tensor]
         ) -> Dict[str, float]:
    """The number of ``served`` (``index`` of each answer's frame,
    ``label``, ``score``) against the reference's logits ``ref``."""
    idx = served["index"].to(ref.device)
    label = served["label"].to(ref.device).long()
    score = served["score"].to(ref.device).to(torch.float32)
    rows = ref[idx]
    std = rows.std(dim=1).clamp_min(1e-30)
    at = rows.gather(1, label[:, None])[:, 0]
    gap = torch.maximum((score - at).abs(), rows.max(dim=1).values - at)
    return {"answer_gap": float((gap / std).max())}


def judge(cfg, weights, frames, served) -> Dict[str, float]:
    """The numbers of the answers a run served."""
    return gaps(logits(cfg, weights, frames), served)


def control(cfg, weights, frames) -> Dict[str, torch.Tensor]:
    """The fp8 control's answers for every frame: the label its logits
    put first, and its logit there."""
    c = logits(cfg, weights, frames, control=True)
    label = c.argmax(dim=1)
    return {"index": torch.arange(c.shape[0], device=c.device),
            "label": label, "score": c.gather(1, label[:, None])[:, 0]}
