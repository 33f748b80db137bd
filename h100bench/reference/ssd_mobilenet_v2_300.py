"""Reference of ``ssd_mobilenet_v2_300``: an SSD head (arXiv:1512.02325)
over a MobileNetV2 backbone (arXiv:1801.04381 §6.2), cut as the
configuration file says, in plain PyTorch and float32; the anchor grid,
box decode and greedy NMS of the NNStreamer ``mobilenet-ssd`` decoder
contract, written out here; the judge of the detection rows a stream's
sink received; and the fp8 control.

A served answer is a frame's rows ``(y1, x1, y2, x2, class, score)``
after NMS. Four numbers judge a set of answers against the reference's
decoded boxes and class probabilities of the same frames:

- ``box_gap``: the widest distance (largest coordinate difference)
  between a served box and the nearest of the reference's boxes;
- ``score_gap``: the widest distance between a served score and the
  reference's probability of the served class at that nearest box;
- ``top_gap``: the widest distance between a frame's highest served
  score and the reference's highest probability of the frame (greedy NMS
  never suppresses the best box, and the top 100 keep it);
- ``nms_iou``: the largest IoU between two served rows of one class, in
  float32 as the decoder computes it; greedy NMS keeps it at or below the
  configuration's IoU threshold.

The reference's own NMS result is not compared with the served one row
by row: a bf16 score that crosses another changes which boxes a class
suppresses, and the sorted scores of the two results then differ about as
much under bf16 as under the fp8 control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from h100bench.reference import mobilenet as mn

NUMBERS = ("box_gap", "score_gap", "top_gap", "nms_iou")
#: frames a block of the forward pass and of NMS
BLOCK = 32
#: the score of a row NMS left empty
PAD = -1.0


def _taps(cfg) -> List[int]:
    """The channels at each feature stage's end."""
    return [cfg["stages"][s][1] for s in cfg["feature_stages"]]


def specs(cfg) -> List[mn.Spec]:
    k, c = cfg["anchors_per_cell"], cfg["num_classes"]
    ch = cfg["stem_channels"]
    out = mn.conv_specs("stem", cfg["channels"], ch, 3)
    out += mn.bn_specs("stem_bn", ch)
    for i, (cin, cout, _, expand) in enumerate(mn.blocks(cfg["stages"], ch)):
        out += mn.block_specs(i, cin, cout, expand)
    for f, tap in enumerate(_taps(cfg)):
        out += mn.conv_specs(f"box_heads.{f}", tap, k * 4, 3, bias=True)
        out += mn.conv_specs(f"cls_heads.{f}", tap, k * c, 3, bias=True)
    return out


def _rows(x: torch.Tensor, width: int) -> torch.Tensor:
    """NCHW head output → ``[N, H·W·k, width]``, cell-major with the
    anchor innermost (the NHWC flattening of the model's outputs)."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, width)


def forward(cfg, weights, frames: torch.Tensor, control: bool = False):
    """NHWC uint8 frames → box encodings ``[N, A, 4]`` and class logits
    ``[N, A, C]``, float32."""
    p = mn.Params(weights, control)
    pre = cfg["preprocess"]
    x = mn.preprocess(frames, pre["add"], pre["div"])
    x = F.relu6(mn.bn(p, "stem_bn", mn.conv(p, "stem", x, 2)))
    ends, n = [], 0
    for expand, out, repeats, stride in cfg["stages"]:
        n += repeats
        ends.append(n)
    taps = [ends[s] for s in cfg["feature_stages"]]
    feats = []
    for i, (cin, cout, stride, expand) in enumerate(
            mn.blocks(cfg["stages"], cfg["stem_channels"])):
        x = mn.block(p, i, x, cin, cout, stride, expand)
        if i + 1 in taps:
            feats.append(x)
    c = cfg["num_classes"]
    boxes = [_rows(mn.conv(p, f"box_heads.{f}", x, bias=True), 4)
             for f, x in enumerate(feats)]
    scores = [_rows(mn.conv(p, f"cls_heads.{f}", x, bias=True), c)
              for f, x in enumerate(feats)]
    return torch.cat(boxes, 1), torch.cat(scores, 1)


def anchor_grid(image_size: int, strides: Sequence[int], per_cell: int
                ) -> np.ndarray:
    """Anchors ``[A, 4]`` as (cy, cx, h, w) in [0, 1]: scales evenly from
    0.2 to 0.9 over every (stride, anchor) pair, aspect ratios 1, 2, 1/2,
    3, 1/3, 1; grouped by anchor with the cell innermost, ``ceil(size /
    stride)`` cells a side (the decoder contract's order; the model's rows
    put the anchor innermost, and the pairing is kept as the contract
    has it)."""
    out = []
    scales = np.linspace(0.2, 0.9, len(strides) * per_cell)
    ratios = [1.0, 2.0, 0.5, 3.0, 1.0 / 3.0, 1.0]
    si = 0
    for stride in strides:
        cells = -(-image_size // stride)
        centers = (np.arange(cells) + 0.5) / cells
        ys, xs = np.meshgrid(centers, centers, indexing="ij")
        for a in range(per_cell):
            s, r = scales[si], ratios[a % 6]
            si += 1
            out.append(np.stack(
                [ys.ravel(), xs.ravel(),
                 np.full(cells * cells, s / math.sqrt(r)),
                 np.full(cells * cells, s * math.sqrt(r))], axis=1))
    return np.concatenate(out).astype(np.float32)


def decode(cfg, enc: torch.Tensor, logits: torch.Tensor):
    """Box encodings and logits → boxes ``[N, A, 4]`` as (y1, x1, y2,
    x2) and probabilities ``[N, A, C-1]`` of classes 1.. (0 is the
    background)."""
    anc = torch.from_numpy(anchor_grid(
        cfg["image_size"], cfg["strides"], cfg["anchors_per_cell"])
    ).to(enc.device)
    cy = enc[..., 0] / 10.0 * anc[:, 2] + anc[:, 0]
    cx = enc[..., 1] / 10.0 * anc[:, 3] + anc[:, 1]
    h = torch.exp(enc[..., 2] / 5.0) * anc[:, 2]
    w = torch.exp(enc[..., 3] / 5.0) * anc[:, 3]
    boxes = torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2],
                        dim=-1)
    return boxes, torch.sigmoid(logits[..., 1:])


def outputs(cfg, weights, frames, control: bool = False):
    """:func:`forward` and :func:`decode` in blocks of frames."""
    boxes, probs = [], []
    with torch.no_grad():
        for i in range(0, frames.shape[0], BLOCK):
            b, p = decode(cfg, *forward(cfg, weights, frames[i:i + BLOCK],
                                        control))
            boxes.append(b)
            probs.append(p)
    return torch.cat(boxes), torch.cat(probs)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of boxes ``a [..., n, 4]`` with ``b [..., m, 4]``."""
    y1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    x1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    y2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    x2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = (y2 - y1).clamp_min(0) * (x2 - x1).clamp_min(0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a[..., :, None] + area_b[..., None, :] -
                    inter).clamp_min(1e-9)


def nms(cfg, boxes: torch.Tensor, probs: torch.Tensor) -> List[torch.Tensor]:
    """Greedy NMS of each frame, every class at once: a class keeps its
    highest score at or above the threshold, drops every box whose IoU
    with it exceeds the IoU threshold, and repeats, at most
    ``max_per_class`` times; then the ``max_total`` highest of all kept
    rows. Rows ``[n, 6]`` a frame."""
    thresh, iou_t = cfg["score_threshold"], cfg["iou_threshold"]
    out = []
    for i in range(0, boxes.shape[0], BLOCK):
        b, s = boxes[i:i + BLOCK], probs[i:i + BLOCK].transpose(1, 2)
        s = torch.where(s >= thresh, s, torch.full_like(s, PAD))
        kept_i, kept_s = [], []
        for _ in range(cfg["max_per_class"]):
            j = s.argmax(dim=-1)                                # [f, C]
            kept_i.append(j)
            kept_s.append(s.gather(-1, j[..., None])[..., 0])
            top = torch.gather(b, 1, j[..., None].expand(*j.shape, 4))
            over = iou(top[..., None, :], b[:, None])[..., 0, :]  # [f, C, A]
            s = torch.where(over > iou_t, torch.full_like(s, PAD), s)
            s = s.scatter(-1, j[..., None], PAD)
        idx = torch.stack(kept_i, -1).flatten(1)                # [f, C·k]
        sc = torch.stack(kept_s, -1).flatten(1)
        cls = (torch.arange(s.shape[1], device=s.device) + 1
               ).repeat_interleave(cfg["max_per_class"])
        for f in range(b.shape[0]):
            order = torch.sort(sc[f], descending=True, stable=True
                               ).indices[:cfg["max_total"]]
            order = order[sc[f][order] > PAD / 2]
            out.append(torch.cat([b[f][idx[f][order]],
                                  cls[order, None].to(b.dtype),
                                  sc[f][order, None]], dim=1))
    return out


def _padded(rows: List[torch.Tensor], width: int, device):
    n = max([r.shape[0] for r in rows] + [1])
    out = torch.zeros(len(rows), n, width, device=device)
    valid = torch.zeros(len(rows), n, dtype=torch.bool, device=device)
    for i, r in enumerate(rows):
        out[i, :r.shape[0]] = r.to(device=device, dtype=torch.float32)
        valid[i, :r.shape[0]] = True
    return out, valid


def gaps(cfg, boxes, probs, served) -> Dict[str, float]:
    """The four numbers of ``served`` (``index`` of each answer's frame,
    ``rows`` a frame) against the reference's boxes and probabilities of
    the frames."""
    worst = dict.fromkeys(NUMBERS, 0.0)
    index = served["index"].tolist()
    dev = boxes.device
    classes = probs.shape[-1]
    for c0 in range(0, len(index), BLOCK):
        idx = index[c0:c0 + BLOCK]
        rows, valid = _padded(served["rows"][c0:c0 + BLOCK], 6, dev)
        if not valid.any():
            continue
        b = boxes[idx]                                          # [f, A, 4]
        d = (rows[:, :, None, :4] - b[:, None]).abs().amax(-1)  # [f, n, A]
        near, a = d.min(dim=-1)
        cls = rows[..., 4].round().long()
        known = (cls >= 1) & (cls <= classes)
        p = probs[idx].gather(1, a[..., None].expand(*a.shape, classes))
        p = p.gather(2, (cls.clamp(1, classes) - 1)[..., None])[..., 0]
        score = torch.where(known, (rows[..., 5] - p).abs(),
                            torch.ones_like(p))
        worst["box_gap"] = max(worst["box_gap"], float(near[valid].max()))
        worst["score_gap"] = max(worst["score_gap"],
                                 float(score[valid].max()))
        best = torch.where(valid, rows[..., 5], torch.full_like(p, PAD))
        top = (best.max(dim=1).values -
               probs[idx].flatten(1).max(dim=1).values).abs()
        worst["top_gap"] = max(worst["top_gap"],
                               float(top[valid.any(dim=1)].max()))
        pair = iou(rows[..., :4], rows[..., :4])
        same = (cls[:, :, None] == cls[:, None, :]) & \
            valid[:, :, None] & valid[:, None, :]
        same &= ~torch.eye(rows.shape[1], dtype=torch.bool, device=dev)
        if same.any():
            worst["nms_iou"] = max(worst["nms_iou"], float(pair[same].max()))
    return worst


def judge(cfg, weights, frames, served) -> Dict[str, float]:
    boxes, probs = outputs(cfg, weights, frames)
    return gaps(cfg, boxes, probs, served)


def control(cfg, weights, frames) -> Dict[str, object]:
    """The fp8 control's rows for every frame, through the same decode
    and NMS."""
    boxes, probs = outputs(cfg, weights, frames, control=True)
    return {"index": torch.arange(frames.shape[0]),
            "rows": nms(cfg, boxes, probs)}
