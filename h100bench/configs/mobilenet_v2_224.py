"""The port's side of ``mobilenet_v2_224``: the caps of its source and
the seeded frames it is fed, its ``MobileNetV2`` module holding the
benchmark's weights, the launch string's model segment
(kernel B1's transform, the filter, the image_labeling decoder), the
answers a sink buffer carries, and the FLOPs of a frame."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from h100bench.reference import mobilenet as mn

#: the kernels whose roofline the benchmark reads, and the launch's
#: elements a frame: ``{kernel: elements(cfg)}``
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
    """The port's module, its parameters and statistics the benchmark's
    (made on the device; nothing drawn on the host)."""
    from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2

    with torch.device("meta"):
        m = MobileNetV2(num_classes=cfg["num_classes"],
                        width=cfg["width_multiplier"])
    m = m.to_empty(device=device).to(
        dtype=getattr(torch, cfg["dtype"]), memory_format=torch.channels_last)
    m.load_state_dict(weights)
    return m.eval()


def transform(cfg) -> str:
    pre = cfg["preprocess"]
    return ("tensor_transform mode=arithmetic "
            f"option=typecast:float32,add:{pre['add']},div:{pre['div']}")


def segment(cfg, model: str, batch: int, inflight: int) -> str:
    """transform ! filter ! decoder, one fused region on the card."""
    batched = "option2=batched " if batch > 1 else ""
    return (f"{transform(cfg)} ! "
            f"tensor_filter framework=torch model={model} "
            f"inflight={inflight} ! "
            f"tensor_decoder mode=image_labeling {batched}")


def answers(buf) -> List[Tuple[int, float]]:
    """A sink buffer's frames: ``(label index, score)`` each."""
    idx, score = buf.meta["label_index"], buf.meta["score"]
    if isinstance(idx, list):
        return list(zip(idx, score))
    return [(idx, score)]


def served(answers: List[Tuple[int, float]], index: List[int]):
    """Answers in the form the reference's judge takes."""
    return {"index": torch.tensor(index, dtype=torch.long),
            "label": torch.tensor([a[0] for a in answers], dtype=torch.long),
            "score": torch.tensor([a[1] for a in answers],
                                  dtype=torch.float32)}


def flops(cfg) -> float:
    """FLOPs of one frame's forward pass: the convolutions and the dense
    layer, two a multiply-add (BatchNorm, ReLU6, the residual adds and the
    pool left out, as is usual)."""
    width = float(cfg["width_multiplier"])
    h = w = cfg["image_size"]
    ch = mn.make_divisible(cfg["stem_channels"] * width)
    total, h, w = mn.conv_flops(h, w, cfg["channels"], ch, 3, 2)
    stages = [[e, mn.make_divisible(c * width), r, s]
              for e, c, r, s in cfg["stages"]]
    f, h, w, ch, _ = mn.blocks_flops(stages, h, w, ch)
    total += f
    last = mn.make_divisible(cfg["last_channels"] * max(width, 1.0))
    total += mn.conv_flops(h, w, ch, last, 1, 1)[0]
    return total + 2.0 * last * cfg["num_classes"]
