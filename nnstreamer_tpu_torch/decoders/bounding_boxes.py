"""bounding_boxes decoder — detection tensors → boxes (+ overlay video).

Port of ``nnstreamer_tpu/decoders/bounding_boxes.py``. Reference:
``ext/nnstreamer/tensor_decoder/tensordec-boundingbox.c`` — modes
mobilenet-ssd (anchor decode + NMS), -postprocess (pre-decoded boxes),
yolov5, ov-person-detection. Output: either RGBA overlay video (reference
behavior) or, with ``option7=meta``, the box list in buffer meta plus a
``[n, 6]`` float32 row tensor ``(y1, x1, y2, x2, class, score)``.

Options (mirroring the reference's option1..N):
  option1: mode — mobilenet-ssd | mobilenet-ssd-postprocess | yolov5 |
           ov-person-detection (and the aliases in ``MODE_ALIASES``)
  option2: labels file
  option3: score threshold (default 0.5; ov-person-detection 0.8)
  option4: video WIDTH:HEIGHT for overlay scaling (default 300:300)
  option5: iou threshold for NMS (default 0.5)
  option7: "meta" → no overlay, boxes in meta only

The device half (:meth:`BoundingBoxes.device_kernel`, for every mode but
ov-person-detection) runs on the tensors where they lie and is capturable
as the last stage of a fused region's CUDA graph: greedy NMS is a fixed
loop of ``DEVICE_K_PER_CLASS`` steps over all classes at once (``argmax``,
``gather``, ``where``; no host synchronisation and no shape that depends
on the data), and the global top ``DEVICE_K_TOTAL`` is a stable
descending sort, whose order among equal scores — the ``PAD_SCORE``
padding rows included — is ``lax.top_k``'s: the lower index first. Only
the ``[DEVICE_K_TOTAL, 6]`` rows cross to the host, where
:meth:`BoundingBoxes.host_finalize` drops the padding.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.pipeline.caps import Caps
from nnstreamer_tpu_torch.registry import DECODER, subplugin
from nnstreamer_tpu_torch.tensors.buffer import (
    TensorBuffer,
    host_array,
    host_float32,
)

log = get_logger("decoders.bounding_boxes")


def nms(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float = 0.5,
        max_out: int = 100) -> List[int]:
    """Greedy non-max suppression; boxes [N,4] as (y1,x1,y2,x2)."""
    order = np.argsort(-scores)
    keep: List[int] = []
    while order.size and len(keep) < max_out:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        yy1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        xx1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        yy2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        xx2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(0, yy2 - yy1) * np.maximum(0, xx2 - xx1)
        area_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        area_r = (boxes[rest, 2] - boxes[rest, 0]) * \
            (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / np.maximum(area_i + area_r - inter, 1e-9)
        order = rest[iou <= iou_thresh]
    return keep


def decode_ssd(box_enc: np.ndarray, scores: np.ndarray,
               anchors: np.ndarray, score_thresh: float,
               iou_thresh: float) -> List[dict]:
    """Anchor-relative SSD decode (reference mobilenet-ssd mode math):
    box_enc [A,4] as (ty,tx,th,tw) vs anchors [A,4] (cy,cx,h,w)."""
    cy = box_enc[:, 0] / 10.0 * anchors[:, 2] + anchors[:, 0]
    cx = box_enc[:, 1] / 10.0 * anchors[:, 3] + anchors[:, 1]
    h = np.exp(box_enc[:, 2] / 5.0) * anchors[:, 2]
    w = np.exp(box_enc[:, 3] / 5.0) * anchors[:, 3]
    boxes = np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], axis=1)
    probs = 1.0 / (1.0 + np.exp(-scores))  # sigmoid scores
    out = []
    for cls in range(1, probs.shape[1]):  # class 0 = background
        mask = probs[:, cls] >= score_thresh
        if not mask.any():
            continue
        cls_boxes, cls_scores = boxes[mask], probs[mask, cls]
        for i in nms(cls_boxes, cls_scores, iou_thresh):
            out.append({
                "class": cls,
                "score": float(cls_scores[i]),
                "box": [float(v) for v in cls_boxes[i]],  # y1,x1,y2,x2 ∈[0,1]
            })
    out.sort(key=lambda d: -d["score"])
    return out


def draw_boxes(width: int, height: int, detections: List[dict]
               ) -> np.ndarray:
    """RGBA overlay frame (transparent except box outlines) — the
    reference's output form for compositing over video."""
    img = np.zeros((height, width, 4), np.uint8)
    for det in detections:
        y1, x1, y2, x2 = det["box"]
        xi1, yi1 = int(np.clip(x1 * width, 0, width - 1)), \
            int(np.clip(y1 * height, 0, height - 1))
        xi2, yi2 = int(np.clip(x2 * width, 0, width - 1)), \
            int(np.clip(y2 * height, 0, height - 1))
        color = np.array([0, 255, 0, 255], np.uint8)
        img[yi1:yi2 + 1, xi1] = color
        img[yi1:yi2 + 1, xi2] = color
        img[yi1, xi1:xi2 + 1] = color
        img[yi2, xi1:xi2 + 1] = color
        label = det.get("label")
        if label:
            from nnstreamer_tpu_torch.decoders.overlay import draw_text

            draw_text(img, xi1 + 2, max(yi1 - 9, 0), str(label),
                      color=(0, 255, 0, 255))
    return img


#: device-path caps: greedy NMS keeps at most this many boxes per class /
#: in total (fixed shapes for a CUDA graph; the host path is unbounded)
DEVICE_K_PER_CLASS = 32
DEVICE_K_TOTAL = 100

#: padding sentinel in device-path score slots. Distinct from a legitimate
#: score of exactly 0 (possible in -postprocess mode with option3=0);
#: sigmoid-derived scores are always > 0 so any value < 0 is safe.
PAD_SCORE = -1.0


def device_nms(boxes: torch.Tensor, scores: torch.Tensor,
               iou_thresh: float, k: int):
    """Greedy NMS of every row of ``scores`` [C, A] (invalid entries
    already ``PAD_SCORE``) over the shared ``boxes`` [A, 4], with a static
    output size: (indices [C, k] int64, scores [C, k]).

    The JAX package's ``_jax_nms`` (a ``fori_loop``) vmapped over the
    rows, as a fixed loop of ``k`` steps on [C, A] tensors: each step keeps
    a row's first maximum (``argmax``), then drops every box whose IoU with
    it exceeds the threshold, and the kept box itself. A row whose pool is
    exhausted keeps ``PAD_SCORE`` padding."""
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    left = scores
    keep_i, keep_s = [], []
    for _ in range(k):
        j = torch.argmax(left, dim=1)                       # [C]
        s = left.gather(1, j[:, None])[:, 0]
        keep_i.append(j)
        keep_s.append(torch.where(s > PAD_SCORE / 2, s,
                                  torch.full_like(s, PAD_SCORE)))
        b = boxes[j]                                        # [C, 4]
        yy1 = torch.maximum(b[:, 0:1], boxes[None, :, 0])
        xx1 = torch.maximum(b[:, 1:2], boxes[None, :, 1])
        yy2 = torch.minimum(b[:, 2:3], boxes[None, :, 2])
        xx2 = torch.minimum(b[:, 3:4], boxes[None, :, 3])
        inter = torch.clamp_min(yy2 - yy1, 0.0) * \
            torch.clamp_min(xx2 - xx1, 0.0)
        area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        iou = inter / torch.clamp_min(area_b[:, None] + areas[None, :] -
                                      inter, 1e-9)
        left = torch.where(iou > iou_thresh, PAD_SCORE, left)
        left = left.scatter(1, j[:, None], PAD_SCORE)
    return torch.stack(keep_i, dim=1), torch.stack(keep_s, dim=1)


def stable_topk_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest of 1-D ``scores`` in ``lax.top_k``'s
    order: descending, the lower index first among equal values."""
    return torch.sort(scores, descending=True, stable=True).indices[:k]


def _rows_topk(boxes, cls_ids, scores, k_total):
    """Select the k_total highest-scoring (box, class, score) rows and pack
    them as [k_total, 6] = (y1,x1,y2,x2,class,score); score==PAD_SCORE is
    padding."""
    top_i = stable_topk_indices(scores, min(k_total, scores.shape[0]))
    return torch.cat([boxes[top_i], cls_ids[top_i].float()[:, None],
                      scores[top_i][:, None]], dim=1)


@subplugin(DECODER, "bounding_boxes")
class BoundingBoxes:
    def __init__(self):
        self._labels = None
        self._anchors = None
        #: the device half's anchor grids by (width, device), made on the
        #: first (eager) call on each device and kept for the decoder's
        #: life: a CUDA-graph capture reads them where they are, and the
        #: CPU one's address is the fused stage's storage pin
        self._anchor_tensors: Dict[tuple, torch.Tensor] = {}
        self._warned_saturated = False

    #: legacy names and same-format aliases (reference bb_modes[],
    #: tensordec-boundingbox.c:157-166: tflite-ssd/tf-ssd are the old names;
    #: ov-face-detection shares the ov-person row format end to end)
    MODE_ALIASES = {
        "tflite-ssd": "mobilenet-ssd",
        "tf-ssd": "mobilenet-ssd-postprocess",
        "ov-face-detection": "ov-person-detection",
    }

    def _opts(self, options: Dict[str, str]) -> dict:
        size = (options.get("option4") or "300:300").split(":")
        mode = options.get("option1", "mobilenet-ssd")
        return dict(
            mode=self.MODE_ALIASES.get(mode, mode),
            labels_path=options.get("option2"),
            score_thresh=float(options.get("option3") or 0.5),
            width=int(size[0]), height=int(size[1]),
            iou_thresh=float(options.get("option5") or 0.5),
            meta_only=(options.get("option7") == "meta"),
        )

    def out_caps(self, config, options) -> Caps:
        o = self._opts(options)
        if o["meta_only"]:
            return Caps("other/tensors", {"format": "flexible"})
        return Caps("video/x-raw", {"format": "RGBA", "width": o["width"],
                                    "height": o["height"]})

    def _get_anchors(self, num_anchors: int, image_size: int) -> np.ndarray:
        if self._anchors is None or self._anchors.shape[0] != num_anchors:
            from nnstreamer_tpu_torch.models.ssd_mobilenet import anchor_grid

            self._anchors = anchor_grid(image_size)
            if self._anchors.shape[0] != num_anchors:
                raise ValueError(
                    f"bounding_boxes: anchor grid {self._anchors.shape[0]} "
                    f"!= model anchors {num_anchors}"
                )
        return self._anchors

    def decode(self, buf: TensorBuffer, config, options) -> TensorBuffer:
        o = self._opts(options)
        mode = o["mode"]
        if mode == "mobilenet-ssd":
            box_enc = host_float32(buf[0])
            scores = host_float32(buf[1])
            if box_enc.ndim == 3:  # [N, A, 4] batch of 1
                box_enc, scores = box_enc[0], scores[0]
            anchors = self._get_anchors(box_enc.shape[0], o["width"])
            dets = decode_ssd(box_enc, scores, anchors,
                              o["score_thresh"], o["iou_thresh"])
        elif mode == "mobilenet-ssd-postprocess":
            # already-decoded boxes [A,4] + scores [A] + classes [A]
            boxes = host_float32(buf[0]).reshape(-1, 4)
            scores = host_float32(buf[1]).reshape(-1)
            classes = (np.asarray(host_array(buf[2])).reshape(-1).astype(int)
                       if buf.num_tensors > 2 else np.ones(len(scores), int))
            mask = scores >= o["score_thresh"]
            dets = [{"class": int(c), "score": float(s),
                     "box": [float(v) for v in b]}
                    for b, s, c in zip(boxes[mask], scores[mask],
                                       classes[mask])]
        elif mode == "yolov5":
            # [A, 5+classes]: cx,cy,w,h,objectness,class-scores
            pred = host_float32(buf[0])
            if pred.ndim == 3:
                pred = pred[0]
            obj = 1 / (1 + np.exp(-pred[:, 4]))
            cls_p = 1 / (1 + np.exp(-pred[:, 5:])) * obj[:, None]
            best = cls_p.argmax(axis=1)
            score = cls_p[np.arange(len(best)), best]
            mask = score >= o["score_thresh"]
            cx, cy, w, h = (pred[mask, i] for i in range(4))
            boxes = np.stack([cy - h / 2, cx - w / 2, cy + h / 2,
                              cx + w / 2], axis=1)
            keep = nms(boxes, score[mask], o["iou_thresh"])
            ci = best[mask]
            dets = [{"class": int(ci[i]), "score": float(score[mask][i]),
                     "box": [float(v) for v in boxes[i]]} for i in keep]
        elif mode == "ov-person-detection":
            # OpenVINO person-detection-retail: [1,1,N,7] rows of
            # (image_id, label, conf, x_min, y_min, x_max, y_max),
            # normalized corners; stream ends at image_id < 0
            # (reference tensordec-boundingbox.c OV_PERSON_DETECTION_*,
            # default threshold 0.8)
            rows = host_float32(buf[0]).reshape(-1, 7)
            thresh = float(options.get("option3") or 0.8)
            dets = []
            for r in rows:
                if r[0] < 0:
                    break
                if r[2] < thresh:
                    continue
                dets.append({"class": int(r[1]), "score": float(r[2]),
                             "box": [float(r[4]), float(r[3]),
                                     float(r[6]), float(r[5])]})
        else:
            raise ValueError(f"bounding_boxes: unknown mode {mode!r}")

        return self._emit(buf, dets, o)

    def _emit(self, buf: TensorBuffer, dets: List[dict], o: dict
              ) -> TensorBuffer:
        if self._labels is None and o["labels_path"]:
            from nnstreamer_tpu_torch.decoders.image_labeling import (
                load_labels,
            )

            self._labels = load_labels(o["labels_path"])
        if self._labels:
            for d in dets:
                if d["class"] < len(self._labels):
                    d["label"] = self._labels[d["class"]]

        meta = {**buf.meta, "detections": dets}
        if o["meta_only"]:
            flat = np.asarray(
                [[d["box"][0], d["box"][1], d["box"][2], d["box"][3],
                  d["class"], d["score"]] for d in dets], np.float32
            ).reshape(-1, 6) if dets else np.zeros((0, 6), np.float32)
            return buf.with_tensors([flat]).replace(meta=meta)
        overlay = draw_boxes(o["width"], o["height"], dets)
        return buf.with_tensors([overlay]).replace(meta=meta)

    # -- device/host split (elements/decoder.py, pipeline/fuse.py) -----------
    def _anchors_on(self, width: int, device) -> torch.Tensor:
        key = (width, str(device))
        if key not in self._anchor_tensors:
            from nnstreamer_tpu_torch.models.ssd_mobilenet import anchor_grid

            self._anchor_tensors[key] = torch.from_numpy(  # nns-lint: disable=NNS113 -- a model constant, uploaded once per width and device and cached
                anchor_grid(width)).to(device)
        return self._anchor_tensors[key]

    def device_kernel(self, options):
        """Device half of decode(): anchor decode + sigmoid + per-class
        greedy NMS + global top-k where the tensors lie — only
        [DEVICE_K_TOTAL, 6] rows leave the device. The host path (decode())
        is unbounded; the device path caps detections at
        DEVICE_K_PER_CLASS per class / DEVICE_K_TOTAL total. None for
        ov-person-detection, which decodes on the host only."""
        o = self._opts(options)
        mode = o["mode"]
        thresh, iou_t = o["score_thresh"], o["iou_thresh"]

        if mode == "mobilenet-ssd":
            width = o["width"]

            def fn(consts, tensors):
                box_enc = tensors[0].float()
                scores = tensors[1].float()
                anc = self._anchors_on(width, box_enc.device)
                if box_enc.ndim == 3:  # [N,A,4] batch — host uses image 0
                    box_enc, scores = box_enc[0], scores[0]
                box_enc = box_enc.reshape(-1, 4)
                scores = scores.reshape(box_enc.shape[0], -1)
                cy = box_enc[:, 0] / 10.0 * anc[:, 2] + anc[:, 0]
                cx = box_enc[:, 1] / 10.0 * anc[:, 3] + anc[:, 1]
                h = torch.exp(box_enc[:, 2] / 5.0) * anc[:, 2]
                w = torch.exp(box_enc[:, 3] / 5.0) * anc[:, 3]
                boxes = torch.stack([cy - h / 2, cx - w / 2,
                                     cy + h / 2, cx + w / 2], dim=1)
                # class 0 = background (host decode_ssd skips it too)
                probs = torch.sigmoid(scores[:, 1:]).t()      # [C-1, A]
                masked = torch.where(probs >= thresh, probs,
                                     torch.full_like(probs, PAD_SCORE))
                idx, sc = device_nms(boxes, masked, iou_t,
                                     DEVICE_K_PER_CLASS)
                cls_ids = torch.arange(1, idx.shape[0] + 1,
                                       device=idx.device)[:, None]
                cls_ids = cls_ids.expand(idx.shape)
                return [_rows_topk(boxes[idx.reshape(-1)],
                                   cls_ids.reshape(-1), sc.reshape(-1),
                                   DEVICE_K_TOTAL)]

            return self._anchors_on(width, "cpu"), fn

        if mode == "yolov5":
            def fn(consts, tensors):
                pred = tensors[0].float()
                if pred.ndim == 3:  # [N,A,C] batch — host uses image 0
                    pred = pred[0]
                pred = pred.reshape(-1, pred.shape[-1])
                obj = torch.sigmoid(pred[:, 4])
                cls_p = torch.sigmoid(pred[:, 5:]) * obj[:, None]
                best = torch.argmax(cls_p, dim=1)
                score = cls_p.gather(1, best[:, None])[:, 0]
                score = torch.where(score >= thresh, score,
                                    torch.full_like(score, PAD_SCORE))
                cx, cy, w, h = (pred[:, i] for i in range(4))
                boxes = torch.stack([cy - h / 2, cx - w / 2,
                                     cy + h / 2, cx + w / 2], dim=1)
                idx, sc = device_nms(boxes, score[None, :], iou_t,
                                     DEVICE_K_TOTAL)
                idx, sc = idx[0], sc[0]
                return [torch.cat([boxes[idx], best[idx].float()[:, None],
                                   sc[:, None]], dim=1)]

            return None, fn

        if mode == "mobilenet-ssd-postprocess":
            def fn(consts, tensors):
                boxes = tensors[0].reshape(-1, 4).float()
                scores = tensors[1].reshape(-1).float()
                if len(tensors) > 2:
                    classes = tensors[2].reshape(-1).float()
                else:
                    classes = torch.ones_like(scores)
                masked = torch.where(scores >= thresh, scores,
                                     torch.full_like(scores, PAD_SCORE))
                k = min(DEVICE_K_TOTAL, masked.shape[0])
                # host path emits in anchor order — restore it
                top_i = torch.sort(stable_topk_indices(masked, k)).values
                return [torch.cat([boxes[top_i], classes[top_i][:, None],
                                   masked[top_i][:, None]], dim=1)]

            return None, fn

        return None  # ov-person-detection: host-only semantics

    def host_finalize(self, host_buf: TensorBuffer, config, options
                      ) -> TensorBuffer:
        o = self._opts(options)
        rows = host_float32(host_buf[0]).reshape(-1, 6)
        dets = [{"class": int(r[4]), "score": float(r[5]),
                 "box": [float(r[0]), float(r[1]), float(r[2]), float(r[3])]}
                for r in rows if r[5] > PAD_SCORE / 2]
        if len(dets) >= DEVICE_K_TOTAL and not self._warned_saturated:
            self._warned_saturated = True
            log.warning(
                "device top-k saturated (all %d rows valid): dense scenes "
                "may be truncated vs the unbounded host path — raise "
                "DEVICE_K_TOTAL or disable fusion for exact results",
                DEVICE_K_TOTAL)
        return self._emit(host_buf, dets, o)
