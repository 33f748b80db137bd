"""image_labeling decoder — classification scores → text label.

Reference: ``ext/nnstreamer/tensor_decoder/tensordec-imagelabel.c``:
argmax over the score tensor, label looked up from the option1 labels
file, output ``text/x-raw``. The device half (int32 argmax and f32 max per
row) runs on the card; only those scalars cross to the host, where
``host_finalize`` looks up the label.
"""

from __future__ import annotations

import numpy as np
import torch

from nnstreamer_tpu_torch.pipeline.caps import Caps
from nnstreamer_tpu_torch.registry import DECODER, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer, host_array


def load_labels(path: str):
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


@subplugin(DECODER, "image_labeling")
class ImageLabeling:
    def __init__(self):
        self._labels = None
        self._labels_path = None

    def _get_labels(self, options):
        path = options.get("option1")
        if path and path != self._labels_path:
            self._labels = load_labels(path)
            self._labels_path = path
        return self._labels

    def out_caps(self, config, options) -> Caps:
        return Caps("text/x-raw", {"format": "utf8"})

    @staticmethod
    def _batched(options) -> bool:
        """option2=batched: rows of tensor[0] are separate frames — one
        label per row. The default keeps reference semantics: argmax over
        the whole tensor (a 2-D score tensor is ONE frame)."""
        return str(options.get("option2", "")).strip().lower() in (
            "batched", "batch", "per-row")

    def decode(self, buf: TensorBuffer, config, options) -> TensorBuffer:
        scores = host_array(buf[0])
        if isinstance(scores, torch.Tensor):  # bfloat16 scores
            scores = scores.float().numpy()
        if self._batched(options) and scores.ndim >= 2:
            flat = scores.reshape(scores.shape[0], -1)
            idxs = np.argmax(flat, axis=-1)
            tops = flat[np.arange(flat.shape[0]), idxs]
            return self._emit(buf, idxs.tolist(), tops.tolist(), options)
        flat = scores.reshape(-1)
        idx = int(np.argmax(flat))
        return self._emit(buf, idx, float(flat[idx]), options)

    def _emit(self, buf, idx, score, options) -> TensorBuffer:
        labels = self._get_labels(options)

        def name(i):
            return labels[i] if labels and i < len(labels) else str(i)

        if isinstance(idx, list):
            texts = [name(int(i)) for i in idx]
            out = np.frombuffer("\n".join(texts).encode("utf-8"), np.uint8)
            return buf.with_tensors([out]).replace(
                meta={**buf.meta, "label_index": [int(i) for i in idx],
                      "label": texts, "score": [float(s) for s in score]}
            )
        text = name(int(idx))
        out = np.frombuffer(text.encode("utf-8"), np.uint8)
        return buf.with_tensors([out]).replace(
            meta={**buf.meta, "label_index": int(idx), "label": text,
                  "score": float(score)}
        )

    # -- device/host split (elements/decoder.py) -----------------------------
    def device_kernel(self, options):
        """Device half: argmax + top score per row stay on the device, so
        only per-frame scalars cross to the host instead of the full score
        tensor (one pair per batch row with option2=batched)."""
        batched = self._batched(options)

        def fn(consts, tensors):
            s = tensors[0]
            rows = s.reshape(s.shape[0], -1) if batched and s.ndim >= 2 \
                else s.reshape(1, -1)
            idx = torch.argmax(rows, dim=-1)  # first maximum, as np.argmax
            top = rows.gather(-1, idx[:, None])[:, 0]
            return [idx.to(torch.int32), top.to(torch.float32)]

        return None, fn

    def host_finalize(self, host_buf: TensorBuffer, config, options
                      ) -> TensorBuffer:
        idxs = np.asarray(host_buf[0]).reshape(-1)
        scores = np.asarray(host_buf[1]).reshape(-1)
        if idxs.size > 1:
            return self._emit(host_buf, idxs.tolist(), scores.tolist(),
                              options)
        return self._emit(host_buf, int(idxs[0]), float(scores[0]), options)
