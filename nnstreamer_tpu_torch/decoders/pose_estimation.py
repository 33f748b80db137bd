"""pose_estimation decoder — keypoint heatmaps → skeleton keypoints.

Port of ``nnstreamer_tpu/decoders/pose_estimation.py``. Reference:
``ext/nnstreamer/tensor_decoder/tensordec-pose.c``: consumes PoseNet
heatmaps (+offsets), finds per-keypoint argmax, refines with offsets,
outputs either an overlay or keypoint metadata.

Options: option1 = video WIDTH:HEIGHT (overlay size), option2 = "meta"
for structured output only, option3 = score threshold.

Batched heatmaps ``[B, H, W, K]`` with ``B > 1`` (a muxed multi-stream
invoke) give one keypoint list a frame. The device half (per-keypoint
argmax, the first maximum as ``np.argmax``, and the offset refinement)
runs where the tensors lie and leaves ``[K, 3]`` (or ``[B, K, 3]``) rows
``(y, x, score)``.
"""

from __future__ import annotations

import numpy as np
import torch

from nnstreamer_tpu_torch.pipeline.caps import Caps
from nnstreamer_tpu_torch.registry import DECODER, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer, host_float32

# COCO keypoint skeleton edges (for overlay drawing)
EDGES = [(0, 1), (0, 2), (1, 3), (2, 4), (5, 6), (5, 7), (7, 9), (6, 8),
         (8, 10), (5, 11), (6, 12), (11, 12), (11, 13), (13, 15), (12, 14),
         (14, 16)]


def decode_pose(heatmaps: np.ndarray, offsets=None, threshold: float = 0.3):
    """heatmaps [H, W, K] (+optional offsets [H, W, 2K]) → list of
    {keypoint, y, x, score} with y/x normalized to [0,1]."""
    H, W, K = heatmaps.shape
    out = []
    for k in range(K):
        hm = heatmaps[:, :, k]
        idx = np.unravel_index(np.argmax(hm), hm.shape)
        score = float(hm[idx])
        y, x = float(idx[0]), float(idx[1])
        if offsets is not None:
            y += float(offsets[idx[0], idx[1], k])
            x += float(offsets[idx[0], idx[1], K + k])
        out.append({
            "keypoint": k,
            "y": y / max(H - 1, 1),
            "x": x / max(W - 1, 1),
            "score": score,
            "visible": score >= threshold,
        })
    return out


def draw_pose(width: int, height: int, keypoints) -> np.ndarray:
    img = np.zeros((height, width, 4), np.uint8)
    pts = {}
    for kp in keypoints:
        if not kp["visible"]:
            continue
        xi = int(np.clip(kp["x"] * (width - 1), 0, width - 1))
        yi = int(np.clip(kp["y"] * (height - 1), 0, height - 1))
        pts[kp["keypoint"]] = (yi, xi)
        img[max(0, yi - 1):yi + 2, max(0, xi - 1):xi + 2] = \
            [255, 0, 0, 255]
    for a, b in EDGES:
        if a in pts and b in pts:
            (y1, x1), (y2, x2) = pts[a], pts[b]
            n = max(abs(y2 - y1), abs(x2 - x1), 1)
            ys = np.linspace(y1, y2, n + 1).astype(int)
            xs = np.linspace(x1, x2, n + 1).astype(int)
            img[ys, xs] = [0, 255, 0, 255]
    return img


def device_keypoints(heat: torch.Tensor, offs=None) -> torch.Tensor:
    """[B, H, W, K] heatmaps (+[B, H, W, 2K] offsets) → [B, K, 3] rows
    ``(y, x, score)``, y and x normalized to [0, 1]."""
    B, H, W, K = heat.shape
    flat = heat.reshape(B, H * W, K)
    j = torch.argmax(flat, dim=1)                           # [B, K]
    score = flat.gather(1, j[:, None, :])[:, 0, :]
    ys = torch.div(j, W, rounding_mode="floor").float()
    xs = (j % W).float()
    if offs is not None:
        offs_flat = offs.reshape(B, H * W, 2 * K)
        ys = ys + offs_flat[:, :, :K].gather(1, j[:, None, :])[:, 0, :]
        xs = xs + offs_flat[:, :, K:].gather(1, j[:, None, :])[:, 0, :]
    y = ys / max(H - 1, 1)
    x = xs / max(W - 1, 1)
    return torch.stack([y, x, score], dim=2)


@subplugin(DECODER, "pose_estimation")
class PoseEstimation:
    def _opts(self, options):
        size = (options.get("option1") or "257:257").split(":")
        return dict(width=int(size[0]), height=int(size[1]),
                    meta_only=(options.get("option2") == "meta"),
                    threshold=float(options.get("option3") or 0.3))

    def out_caps(self, config, options) -> Caps:
        o = self._opts(options)
        if o["meta_only"]:
            return Caps("other/tensors", {"format": "flexible"})
        return Caps("video/x-raw", {"format": "RGBA", "width": o["width"],
                                    "height": o["height"]})

    def decode(self, buf: TensorBuffer, config, options) -> TensorBuffer:
        o = self._opts(options)
        heat = host_float32(buf[0])
        offs = host_float32(buf[1]) if buf.num_tensors > 1 else None
        if heat.ndim == 4 and heat.shape[0] > 1:
            # batched heatmaps (mux'd multi-stream invoke): per-frame
            # keypoint lists — nothing silently dropped
            kps = [decode_pose(heat[b],
                               None if offs is None else offs[b],
                               o["threshold"])
                   for b in range(heat.shape[0])]
        else:
            if heat.ndim == 4:
                heat = heat[0]
            if offs is not None and offs.ndim == 4:
                offs = offs[0]
            kps = decode_pose(heat, offs, o["threshold"])
        return self._emit(buf, kps, o)

    def _emit(self, buf: TensorBuffer, kps, o) -> TensorBuffer:
        meta = {**buf.meta, "keypoints": kps}
        batched = bool(kps) and isinstance(kps[0], list)
        if o["meta_only"]:
            frames = kps if batched else [kps]
            flat = np.asarray(
                [[[kp["y"], kp["x"], kp["score"]] for kp in fr]
                 for fr in frames], np.float32)
            if not batched:
                flat = flat[0]
            return buf.with_tensors([flat]).replace(meta=meta)
        if batched:
            # overlay caps declare ONE video frame; a batched overlay
            # needs a demux upstream — refuse rather than emit frames a
            # caps-respecting consumer would silently drop
            raise ValueError(
                "pose_estimation: batched heatmaps require option2=meta "
                "(overlay output is single-frame; demux the stream first)")
        return buf.with_tensors(
            [draw_pose(o["width"], o["height"], kps)]
        ).replace(meta=meta)

    # -- device/host split (elements/decoder.py, pipeline/fuse.py) -----------
    def device_kernel(self, options):
        """Device half of decode(): per-keypoint heatmap argmax (+offset
        refinement) where the tensors lie — [K, 3] (y, x, score) rows (one
        block a frame when batched) leave the device instead of full
        heatmaps."""

        def fn(consts, tensors):
            heat = tensors[0].float()
            offs = tensors[1].float() if len(tensors) > 1 else None
            if heat.ndim == 4 and heat.shape[0] > 1:
                # batched heatmaps (mux'd multi-stream invoke): one [K,3]
                # block per frame — nothing silently dropped
                return [device_keypoints(heat, offs)]
            if heat.ndim == 4:  # B==1: squeeze, matching the host path
                heat = heat[0]
                offs = None if offs is None else offs[0]
            return [device_keypoints(
                heat[None], None if offs is None else offs[None])[0]]

        return None, fn

    def host_finalize(self, host_buf: TensorBuffer, config, options
                      ) -> TensorBuffer:
        o = self._opts(options)
        arr = host_float32(host_buf[0])

        def to_kps(rows):
            return [{
                "keypoint": k,
                "y": float(r[0]),
                "x": float(r[1]),
                "score": float(r[2]),
                "visible": float(r[2]) >= o["threshold"],
            } for k, r in enumerate(rows)]

        if arr.ndim == 3:  # batched: per-frame keypoint lists
            kps = [to_kps(frame) for frame in arr]
        else:
            kps = to_kps(arr.reshape(-1, 3))
        return self._emit(host_buf, kps, o)
