"""Source elements: test video and application push.

Reference equivalents: gst core ``videotestsrc`` and ``appsrc`` (used
throughout the reference's SSAT pipelines). Frames are host numpy arrays,
byte-identical to the JAX package's ``videotestsrc`` for every pattern
(``ball`` frames come from the staging pool, ``tensors/pool.py``); the
elements downstream move them to the device.
"""

from __future__ import annotations

import queue as _queue
import time
from typing import Optional

import numpy as np

from nnstreamer_tpu_torch.pipeline.caps import Caps
from nnstreamer_tpu_torch.pipeline.pipeline import SourceElement
from nnstreamer_tpu_torch.registry import ELEMENT, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensors.types import Fraction, TensorsConfig

_VIDEO_CHANNELS = {"RGB": 3, "BGR": 3, "RGBA": 4, "BGRA": 4, "GRAY8": 1}


@subplugin(ELEMENT, "videotestsrc")
class VideoTestSrc(SourceElement):
    """Deterministic synthetic video source (gst videotestsrc equivalent).

    Patterns: ``smpte`` (deterministic color bars), ``ball`` (moving dot,
    frame-dependent), ``gradient``, ``black``. Frames are reproducible
    functions of (pattern, frame index) so golden tests can byte-compare.
    """

    ELEMENT_NAME = "videotestsrc"
    PROPERTIES = {
        **SourceElement.PROPERTIES,
        "num_buffers": -1,
        "pattern": "smpte",
        "width": 320,
        "height": 240,
        "format": "RGB",
        "framerate": "30/1",
        "is_live": False,
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.i = 0
        self._live_t0 = None
        self._static_frame = (None, None)

    def start(self):
        super().start()
        # restart semantics (gst NULL→PLAYING): frame count and the
        # live-pacing epoch reset
        self.i = 0
        self._live_t0 = None

    def _caps(self) -> Caps:
        return Caps(
            "video/x-raw",
            {
                "format": self.get_property("format"),
                "width": int(self.get_property("width")),
                "height": int(self.get_property("height")),
                "framerate": str(self.get_property("framerate")),
            },
        )

    def negotiate(self):
        self.srcpad.set_caps(self._caps())

    def _frame(self, i: int) -> np.ndarray:
        pattern = self.get_property("pattern")
        if pattern == "ball":
            return self._synthesize(i)
        # every other pattern is frame-independent: synthesize once per
        # (pattern, size, format) and share the read-only array (buffers
        # are immutable once pushed)
        key = (pattern, self.get_property("width"),
               self.get_property("height"), self.get_property("format"))
        cached_key, cached = self._static_frame
        if cached is not None and cached_key == key:
            return cached
        img = self._synthesize(i)
        img.setflags(write=False)
        self._static_frame = (key, img)
        return img

    def _synthesize(self, i: int) -> np.ndarray:
        w = int(self.get_property("width"))
        h = int(self.get_property("height"))
        fmt = self.get_property("format")
        ch = _VIDEO_CHANNELS[fmt]
        pattern = self.get_property("pattern")
        if pattern == "black":
            img = np.zeros((h, w, ch), np.uint8)
        elif pattern == "gradient":
            row = np.linspace(0, 255, w, dtype=np.uint8)
            img = np.broadcast_to(row[None, :, None], (h, w, ch)).copy()
        elif pattern == "ball":
            # the one frame-dependent pattern synthesizes per frame: into
            # a recycled staging slab (tensors/pool.py), which returns to
            # the pool when the last downstream reference dies
            from nnstreamer_tpu_torch.tensors.pool import get_pool

            img = get_pool().acquire((h, w, ch), np.uint8)
            img[:] = 0
            cx = (i * 7) % w
            cy = (i * 5) % h
            y, x = np.ogrid[:h, :w]
            mask = (x - cx) ** 2 + (y - cy) ** 2 <= (min(h, w) // 8) ** 2
            img[mask] = 255
        else:  # smpte bars
            bars = np.array(
                [[255, 255, 255], [255, 255, 0], [0, 255, 255], [0, 255, 0],
                 [255, 0, 255], [255, 0, 0], [0, 0, 255]], np.uint8
            )
            idx = (np.arange(w) * 7 // max(w, 1)).clip(0, 6)
            rgb = bars[idx]
            img = np.broadcast_to(rgb[None, :, :], (h, w, 3)).copy()
            if ch == 1:
                img = img.mean(axis=2, keepdims=True).astype(np.uint8)
            elif ch == 4:
                img = np.concatenate(
                    [img, np.full((h, w, 1), 255, np.uint8)], axis=2
                )
        if img.shape[2] != ch:  # gray/alpha adjust for non-smpte patterns
            if ch == 1:
                img = img[:, :, :1]
            elif ch == 4 and img.shape[2] == 3:
                img = np.concatenate(
                    [img, np.full((h, w, 1), 255, np.uint8)], axis=2
                )
        return img

    def create(self) -> Optional[TensorBuffer]:
        n = int(self.get_property("num_buffers"))
        if 0 <= n <= self.i:
            return None
        rate = Fraction.parse(self.get_property("framerate"))
        dur = rate.frame_duration_ns or 0
        buf = TensorBuffer([self._frame(self.i)], pts=self.i * dur,
                           duration=dur)
        if self.get_property("is_live") and dur:
            # pace against the wall clock (gst live-source semantics): a
            # source stalled downstream catches back up to schedule
            if self._live_t0 is None:
                self._live_t0 = time.monotonic()
            target = self._live_t0 + (self.i + 1) * dur / 1e9
            delay = target - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        self.i += 1
        return buf


@subplugin(ELEMENT, "appsrc")
class AppSrc(SourceElement):
    """Application push source (gst appsrc): the app calls :meth:`push` /
    :meth:`end_of_stream`; the streaming thread forwards in order."""

    ELEMENT_NAME = "appsrc"
    PROPERTIES = {**SourceElement.PROPERTIES, "caps": None,
                  "max_buffers": 64, "block": True}

    _EOS = object()

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._q = _queue.Queue(maxsize=int(self.get_property("max_buffers")))

    def set_caps(self, caps: Caps):
        self.set_property("caps", caps)

    def push(self, buf_or_arrays, pts: Optional[int] = None) -> bool:
        """Push a TensorBuffer (or a list of arrays/tensors, one per tensor
        of the frame) into the stream. With ``block=false`` a full queue
        drops the buffer and returns False instead of blocking."""
        if not isinstance(buf_or_arrays, TensorBuffer):
            buf_or_arrays = TensorBuffer.from_arrays(buf_or_arrays, pts=pts)
        if self.get_property("block"):
            self._q.put(buf_or_arrays)
            return True
        try:
            self._q.put_nowait(buf_or_arrays)
            return True
        except _queue.Full:
            return False

    def end_of_stream(self) -> None:
        self._q.put(self._EOS)

    def negotiate(self):
        caps = self.get_property("caps")
        if isinstance(caps, str):
            from nnstreamer_tpu_torch.pipeline.parse import parse_caps_string

            caps = parse_caps_string(caps)
        if caps is not None:
            self.srcpad.set_caps(caps)

    def create(self):
        while not self._stop_evt.is_set():
            try:
                item = self._q.get(timeout=0.1)
            except _queue.Empty:
                continue
            if item is self._EOS:
                return None
            # announce caps from the first buffer if none were set
            if self.srcpad.caps is None:
                self.srcpad.set_caps(
                    TensorsConfig.from_arrays(item.tensors).to_caps())
            return item
        return None
