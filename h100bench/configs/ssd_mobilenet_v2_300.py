"""The port's side of ``ssd_mobilenet_v2_300``: the caps of its source
and the seeded frames it is fed, its ``SSDMobileNet`` module holding
the benchmark's weights, the launch string's model
segment (kernel B1's transform, the filter, the ``bounding_boxes``
decoder with its device NMS), the rows a sink buffer carries, and the
FLOPs of a frame."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from h100bench.reference import mobilenet as mn

KERNELS = {"normalize_chain_kernel": lambda cfg: (
    cfg["image_size"] * cfg["image_size"] * cfg["channels"])}


def caps(cfg) -> str:
    """The caps of the ``appsrc`` that feeds the configuration: RGB
    video frames of its size."""
    size = cfg["image_size"]
    return (f"video/x-raw,format=RGB,width={size},height={size},"
            "framerate=0/1")


def inputs(cfg, seed: int, count: int, device) -> torch.Tensor:
    """``count`` seeded frames ``[count, size, size, channels]`` uint8,
    made on ``device``: what the sources push and the reference reads."""
    from h100bench import weights

    size = cfg["image_size"]
    return weights.frames(seed, count, size, size, cfg["channels"], device)


def module(cfg, weights: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    from nnstreamer_tpu_torch.models.ssd_mobilenet import SSDMobileNet

    with torch.device("meta"):
        m = SSDMobileNet(num_classes=cfg["num_classes"],
                         num_anchors_per_cell=cfg["anchors_per_cell"])
    m = m.to_empty(device=device).to(
        dtype=getattr(torch, cfg["dtype"]), memory_format=torch.channels_last)
    m.load_state_dict(weights)
    return m.eval()


def segment(cfg, model: str, batch: int, inflight: int) -> str:
    pre = cfg["preprocess"]
    size = cfg["image_size"]
    return ("tensor_transform mode=arithmetic "
            f"option=typecast:float32,add:{pre['add']},div:{pre['div']} ! "
            f"tensor_filter framework=torch model={model} "
            f"inflight={inflight} ! "
            "tensor_decoder mode=bounding_boxes option1=mobilenet-ssd "
            f"option3={cfg['score_threshold']} option4={size}:{size} "
            f"option5={cfg['iou_threshold']} option7=meta ")


def answers(buf) -> List[np.ndarray]:
    """A sink buffer's frame: its ``[n, 6]`` float32 rows."""
    return [np.asarray(buf[0], dtype=np.float32).reshape(-1, 6)]


def served(answers: List[np.ndarray], index: List[int]):
    return {"index": torch.tensor(index, dtype=torch.long),
            "rows": [torch.from_numpy(a) for a in answers]}


def flops(cfg) -> float:
    """FLOPs of one frame's forward pass (convolutions only, two a
    multiply-add); the decode and NMS are not counted."""
    h = w = cfg["image_size"]
    ch = cfg["stem_channels"]
    total, h, w = mn.conv_flops(h, w, cfg["channels"], ch, 3, 2)
    f, h, w, ch, ends = mn.blocks_flops(cfg["stages"], h, w, ch)
    total += f
    k, c = cfg["anchors_per_cell"], cfg["num_classes"]
    for s in cfg["feature_stages"]:
        fh, fw, fc = ends[s]
        total += mn.conv_flops(fh, fw, fc, k * 4, 3, 1)[0]
        total += mn.conv_flops(fh, fw, fc, k * c, 3, 1)[0]
    return total
