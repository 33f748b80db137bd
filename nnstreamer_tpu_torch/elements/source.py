"""Source elements: test video and audio, files, application push, and
sensor capture.

Port of ``nnstreamer_tpu/elements/source.py``. Reference equivalents: gst
core ``videotestsrc``/``audiotestsrc``/``filesrc``/``multifilesrc``/
``appsrc`` (used throughout the reference's SSAT pipelines) and
``tensor_src_iio`` (``gst/nnstreamer/elements/gsttensorsrciio.c``, Linux
Industrial-I/O sensor capture). Every source makes host numpy arrays,
byte-identical to the JAX package's for the same properties
(``videotestsrc`` ``ball`` frames come from the staging pool,
``tensors/pool.py``); the elements downstream move them to the device.
``videotestsrc``, ``audiotestsrc`` and ``multifilesrc`` are
``REORDER_SAFE`` (ingest lanes, ``pipeline/lanes.py``, may run their
frames out of order), as is ``tensor_src_iio`` in mock mode; the pipeline
stamps each created frame's trace seq when a timeline is active.
"""

from __future__ import annotations

import glob
import os
import queue as _queue
import time
from typing import Optional

import numpy as np

from nnstreamer_tpu_torch.pipeline.caps import Caps
from nnstreamer_tpu_torch.pipeline.pipeline import SourceElement
from nnstreamer_tpu_torch.registry import ELEMENT, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensors.types import (
    Fraction,
    TensorsConfig,
    TensorsInfo,
)

_VIDEO_CHANNELS = {"RGB": 3, "BGR": 3, "RGBA": 4, "BGRA": 4, "GRAY8": 1}


@subplugin(ELEMENT, "videotestsrc")
class VideoTestSrc(SourceElement):
    """Deterministic synthetic video source (gst videotestsrc equivalent).

    Patterns: ``smpte`` (deterministic color bars), ``ball`` (moving dot,
    frame-dependent), ``gradient``, ``black``. Frames are reproducible
    functions of (pattern, frame index) so golden tests can byte-compare.
    """

    ELEMENT_NAME = "videotestsrc"
    # frames are pure functions of (pattern, frame index) and pts is
    # stamped at create() — lane workers may process them out of order
    REORDER_SAFE = True
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


@subplugin(ELEMENT, "audiotestsrc")
class AudioTestSrc(SourceElement):
    """Deterministic sine-wave audio source (gst audiotestsrc equivalent)."""

    ELEMENT_NAME = "audiotestsrc"
    # each window is sample-index-addressed (phase derived from buffer
    # index), so generation order never changes the bytes
    REORDER_SAFE = True
    PROPERTIES = {
        **SourceElement.PROPERTIES,
        "num_buffers": -1,
        "samplesperbuffer": 1024,
        "freq": 440.0,
        "rate": 44100,
        "channels": 1,
        "format": "S16LE",
    }

    _DTYPES = {"S16LE": np.int16, "S8": np.int8, "F32LE": np.float32,
               "U8": np.uint8}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.i = 0

    def negotiate(self):
        self.srcpad.set_caps(Caps("audio/x-raw", {
            "format": self.get_property("format"),
            "rate": int(self.get_property("rate")),
            "channels": int(self.get_property("channels")),
        }))

    def create(self):
        n = int(self.get_property("num_buffers"))
        if 0 <= n <= self.i:
            return None
        spb = int(self.get_property("samplesperbuffer"))
        rate = int(self.get_property("rate"))
        ch = int(self.get_property("channels"))
        t0 = self.i * spb
        t = (np.arange(t0, t0 + spb) / rate)
        wave = np.sin(2 * np.pi * float(self.get_property("freq")) * t)
        dtype = self._DTYPES[self.get_property("format")]
        if np.issubdtype(dtype, np.integer):
            amp = np.iinfo(dtype).max * 0.8
            samples = (wave * amp).astype(dtype)
        else:
            samples = wave.astype(dtype)
        samples = np.repeat(samples[:, None], ch, axis=1)
        pts = int(t0 / rate * 1e9)
        self.i += 1
        return TensorBuffer([samples], pts=pts,
                            duration=int(spb / rate * 1e9))


@subplugin(ELEMENT, "filesrc")
class FileSrc(SourceElement):
    """Whole-file source (gst filesrc): one buffer of raw bytes, caps
    ``application/octet-stream`` (downstream converter interprets)."""

    ELEMENT_NAME = "filesrc"
    PROPERTIES = {**SourceElement.PROPERTIES, "location": None,
                  "blocksize": -1}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._fh = None
        self._done = False

    def negotiate(self):
        self.srcpad.set_caps(Caps("application/octet-stream", {}))

    def create(self):
        loc = self.get_property("location")
        if loc is None or not os.path.isfile(loc):
            raise FileNotFoundError(f"filesrc: no such file {loc!r}")
        bs = int(self.get_property("blocksize"))
        if self._fh is None:
            self._fh = open(loc, "rb")
        if bs <= 0:
            if self._done:
                return None
            data = self._fh.read()
            self._done = True
        else:
            data = self._fh.read(bs)
            if not data:
                return None
        return TensorBuffer([np.frombuffer(data, np.uint8)])

    def stop(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self._done = False
        super().stop()


@subplugin(ELEMENT, "multifilesrc")
class MultiFileSrc(SourceElement):
    """Sequence-of-files source (gst multifilesrc): ``location`` is a printf
    pattern (``img_%03d.raw``) or glob; one buffer per file."""

    ELEMENT_NAME = "multifilesrc"
    # one file per buffer, pts stamped with the file index at create()
    REORDER_SAFE = True
    PROPERTIES = {**SourceElement.PROPERTIES, "location": None,
                  "start_index": 0, "stop_index": -1, "caps": None}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.i = None
        self._listing = None  # cached sorted glob listing

    def negotiate(self):
        caps = self.get_property("caps")
        if isinstance(caps, str):
            from nnstreamer_tpu_torch.pipeline.parse import parse_caps_string

            caps = parse_caps_string(caps)
        self.srcpad.set_caps(caps or Caps("application/octet-stream", {}))

    def _path(self, i: int) -> Optional[str]:
        loc = self.get_property("location")
        if "%" in loc:
            return loc % i
        if self._listing is None:
            self._listing = sorted(glob.glob(loc))  # scan once per run
        return self._listing[i] if i < len(self._listing) else None

    def create(self):
        if self.i is None:
            self.i = int(self.get_property("start_index"))
        stop = int(self.get_property("stop_index"))
        if 0 <= stop < self.i:
            return None
        path = self._path(self.i)
        if path is None or not os.path.isfile(path):
            return None
        with open(path, "rb") as f:
            data = f.read()
        buf = TensorBuffer([np.frombuffer(data, np.uint8)], pts=self.i)
        self.i += 1
        return buf

    def stop(self):
        self.i = None
        self._listing = None
        super().stop()


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

    def property_changed(self, key: str) -> None:
        # a launch string sets properties after construction: the queue
        # takes the new bound (the JAX package's keeps 64, ROADMAP C.31)
        if key == "max_buffers" and hasattr(self, "_q"):
            if not self._q.empty():
                raise ValueError(f"{self.name}: max-buffers changed while "
                                 "buffers are queued")
            self._q = _queue.Queue(
                maxsize=int(self.get_property("max_buffers")))

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


class IIOChannel:
    """One scan element: name, index and packed-sample format.

    The format descriptor mirrors the kernel's ``in_*_type`` files,
    ``[be|le]:[s|u]BITS/STORAGE>>SHIFT`` (the reference parses these in
    gsttensorsrciio.c's channel probe): STORAGE bits on the wire, BITS of
    real data after right-shifting by SHIFT, signed or unsigned.
    """

    def __init__(self, name: str, index: int, fmt: str,
                 scale: float = 1.0, offset: float = 0.0):
        self.name = name
        self.index = index
        self.scale = scale
        self.offset = offset
        try:
            endian, rest = fmt.strip().split(":")
            if endian not in ("be", "le") or rest[0] not in ("s", "u"):
                raise ValueError(f"bad endian/sign token")
            self.big_endian = endian == "be"
            self.signed = rest[0] == "s"
            bits, rest = rest[1:].split("/")
            storage, shift = (rest.split(">>") + ["0"])[:2]
            self.bits = int(bits)
            self.storage_bits = int(storage)
            self.shift = int(shift)
        except (ValueError, IndexError) as e:
            raise ValueError(
                f"iio: malformed type descriptor {fmt!r} for channel "
                f"{name!r} (expected [be|le]:[s|u]BITS/STORAGE>>SHIFT, "
                "the kernel in_*_type format)") from e
        if self.storage_bits % 8 or self.storage_bits not in (8, 16, 32, 64):
            raise ValueError(f"iio: unsupported storage {fmt!r}")
        if not (0 < self.bits <= self.storage_bits and
                0 <= self.shift < self.storage_bits and
                self.bits + self.shift <= self.storage_bits):
            # bits/shift outside the storage word would decode silently
            # wrong (sign bit unreachable, or data shifted away)
            raise ValueError(
                f"iio: inconsistent type descriptor {fmt!r} for channel "
                f"{name!r}: BITS+SHIFT must fit in STORAGE")

    @property
    def storage_bytes(self) -> int:
        return self.storage_bits // 8

    def extract(self, raw: np.ndarray) -> np.ndarray:
        """Packed storage words → scaled float32 values."""
        dt = np.dtype(f"{'>' if self.big_endian else '<'}u"
                      f"{self.storage_bytes}")
        words = raw.view(dt).astype(np.uint64) >> np.uint64(self.shift)
        vals = words & np.uint64((1 << self.bits) - 1)
        if self.signed:
            if self.bits == 64:  # e.g. the kernel timestamp channel s64/64
                vals = vals.view(np.int64)
            else:
                # branchless sign-extend: (v XOR sign) - sign
                sign = np.int64(1) << np.int64(self.bits - 1)
                vals = (vals.astype(np.int64) ^ sign) - sign
        return ((vals.astype(np.float64) + self.offset) *
                self.scale).astype(np.float32)


@subplugin(ELEMENT, "tensor_src_iio")
class TensorSrcIIO(SourceElement):
    """Linux Industrial-I/O sensor source (reference ``tensor_src_iio``,
    gst/nnstreamer/elements/gsttensorsrciio.c, 2604 LoC).

    ``mode=device`` follows the reference's buffered-capture flow: probe
    ``<base-dir>/iio:deviceN`` sysfs (scan_elements ``in_*_{en,index,type}``
    plus per-channel scale/offset), enable channels, set
    ``sampling_frequency`` and ``buffer/length``, then read packed scans
    from ``<dev-dir>/iio:deviceN`` and demux each enabled channel by its
    type descriptor into a [channels, buffer_capacity] float32 tensor.
    ``base-dir``/``dev-dir`` default to the real kernel paths and are
    test-overridable (a mock sysfs tree replaces real hardware, the
    reference's dummy-device pattern). ``mode=mock`` needs no filesystem
    at all and synthesizes deterministic sine channels.
    """

    ELEMENT_NAME = "tensor_src_iio"
    # mock mode synthesizes index-addressed sines with pts stamped at
    # create(); device mode reads a live devnode, where the acquisition
    # snapshot depends on read timing — keep that serial
    PROPERTIES = {
        **SourceElement.PROPERTIES,
        "mode": "mock",  # "device" reads sysfs+devnode; "mock" synthesizes
        "device": None,            # device name (resolved to a number)
        "device_number": -1,
        "base_dir": "/sys/bus/iio/devices",
        "dev_dir": "/dev",
        "frequency": 100,
        "buffer_capacity": 1,
        "channels": "auto",        # "auto"|comma list of channel names
        "num_buffers": -1,
        "poll_timeout_ms": 1000,
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.i = 0
        self._chans: list[IIOChannel] = []
        self._chan_offsets: list[int] = []
        self._scan_bytes = 0
        self._fh = None

    def reorder_safe(self):
        return self.get_property("mode") == "mock"

    # -- sysfs probing -------------------------------------------------------
    def _device_dir(self) -> str:
        base = self.get_property("base_dir")
        num = int(self.get_property("device_number"))
        want = self.get_property("device")
        if num < 0 and want:
            for d in sorted(glob.glob(os.path.join(base, "iio:device*"))):
                try:
                    with open(os.path.join(d, "name")) as f:
                        if f.read().strip() == want:
                            return d
                except OSError:
                    continue
            raise FileNotFoundError(f"tensor_src_iio: no device named "
                                    f"{want!r} under {base}")
        d = os.path.join(base, f"iio:device{max(num, 0)}")
        if not os.path.isdir(d):
            raise FileNotFoundError(
                f"tensor_src_iio: {d} not found (use mode=mock on hosts "
                f"without IIO hardware)")
        return d

    @staticmethod
    def _read_sysfs(path: str, default: Optional[str] = None) -> str:
        try:
            with open(path) as f:
                return f.read().strip()
        except OSError:
            if default is None:
                raise
            return default

    @staticmethod
    def _write_sysfs(path: str, value) -> None:
        try:
            with open(path, "w") as f:
                f.write(str(value))
        except OSError:
            pass  # read-only attribute (fixed-rate sensors)

    def _probe_channels(self, dev_dir: str) -> list[IIOChannel]:
        scan = os.path.join(dev_dir, "scan_elements")
        sel = self.get_property("channels")
        # "auto" → all; an integer → first N by scan index (the element's
        # original numeric contract); otherwise a comma list of names
        wanted = None
        limit = None
        if sel not in (None, "auto"):
            if str(sel).isdigit():
                limit = int(sel)
            else:
                wanted = {c.strip() for c in str(sel).split(",")}
        probed = []
        for en_path in sorted(glob.glob(os.path.join(scan, "in_*_en"))):
            cname = os.path.basename(en_path)[len("in_"):-len("_en")]
            idx = int(self._read_sysfs(
                os.path.join(scan, f"in_{cname}_index"), "0"))
            fmt = self._read_sysfs(os.path.join(scan, f"in_{cname}_type"))
            scale = float(self._read_sysfs(
                os.path.join(dev_dir, f"in_{cname}_scale"), "1.0"))
            offset = float(self._read_sysfs(
                os.path.join(dev_dir, f"in_{cname}_offset"), "0.0"))
            probed.append((en_path, IIOChannel(cname, idx, fmt, scale,
                                               offset)))
        probed.sort(key=lambda pair: pair[1].index)
        chans = []
        for pos, (en_path, ch) in enumerate(probed):
            enable = ((wanted is None or ch.name in wanted) and
                      (limit is None or pos < limit))
            self._write_sysfs(en_path, 1 if enable else 0)
            if enable:
                chans.append(ch)
        if not chans:
            raise ValueError(f"tensor_src_iio: no scan channels enabled "
                             f"under {scan}")
        return chans

    def start(self):
        super().start()
        self.i = 0
        if self.get_property("mode") != "device":
            return
        dev_dir = self._device_dir()
        self._chans = self._probe_channels(dev_dir)
        # kernel scan layout: each element sits at an offset aligned to its
        # own storage size (index order); the whole scan pads to the widest
        # element's alignment
        off = 0
        self._chan_offsets = []
        for c in self._chans:
            sb = c.storage_bytes
            off = (off + sb - 1) // sb * sb
            self._chan_offsets.append(off)
            off += sb
        widest = max(c.storage_bytes for c in self._chans)
        self._scan_bytes = (off + widest - 1) // widest * widest
        cap = int(self.get_property("buffer_capacity"))
        self._write_sysfs(os.path.join(dev_dir, "sampling_frequency"),
                          int(self.get_property("frequency")))
        self._write_sysfs(os.path.join(dev_dir, "buffer", "length"), cap)
        self._write_sysfs(os.path.join(dev_dir, "buffer", "enable"), 1)
        node = os.path.join(self.get_property("dev_dir"),
                            os.path.basename(dev_dir))
        self._fh = open(node, "rb", buffering=0)

    def stop(self):
        # signal the streaming thread FIRST so _read_scans exits its loop
        # before the handle goes away
        self._stop_evt.set()
        if self._fh is not None:
            fh, self._fh = self._fh, None
            fh.close()
            if self.get_property("mode") == "device":
                try:
                    self._write_sysfs(
                        os.path.join(self._device_dir(), "buffer", "enable"),
                        0)
                except FileNotFoundError:
                    pass
        super().stop()

    # -- negotiation ---------------------------------------------------------
    def _num_channels(self) -> int:
        if self.get_property("mode") == "device":
            return len(self._chans)
        sel = self.get_property("channels")
        return 2 if sel in (None, "auto") else (
            int(sel) if str(sel).isdigit() else len(str(sel).split(",")))

    def negotiate(self):
        ch = self._num_channels()
        cap = int(self.get_property("buffer_capacity"))
        info = TensorsInfo.from_str(f"{ch}:{cap}", "float32")
        cfg = TensorsConfig(
            info=info,
            rate=Fraction(int(self.get_property("frequency")), 1))
        self.srcpad.set_caps(cfg.to_caps())

    # -- capture -------------------------------------------------------------
    def _read_scans(self, cap: int) -> Optional[np.ndarray]:
        """Read ``cap`` packed scans and demux → [cap, channels] f32.

        ``poll-timeout-ms`` bounds the wait for each buffer (reference
        poll() on the char device); a quiet sensor ends the stream instead
        of hanging stop() forever.
        """
        import select

        need = self._scan_bytes * cap
        deadline = time.monotonic() + \
            max(1, int(self.get_property("poll_timeout_ms"))) / 1e3
        data = b""
        while len(data) < need and not self._stop_evt.is_set():
            fh = self._fh
            if fh is None:
                return None
            left = deadline - time.monotonic()
            if left <= 0:
                self.log.warning("poll timeout (%d bytes of %d)",
                                 len(data), need)
                return None
            try:
                ready, _, _ = select.select([fh], [], [], min(0.1, left))
            except (OSError, ValueError):
                return None  # handle closed during stop
            if not ready:
                continue
            try:
                chunk = fh.read(need - len(data))
            except (OSError, ValueError):
                return None
            if chunk is None:
                continue  # non-blocking node, nothing buffered
            if not chunk:
                return None  # EOF (mock trees use finite files)
            data += chunk
        if len(data) < need:
            return None
        raw = np.frombuffer(data, np.uint8).reshape(cap, self._scan_bytes)
        cols = []
        for c, off in zip(self._chans, self._chan_offsets):
            sl = np.ascontiguousarray(
                raw[:, off:off + c.storage_bytes]).reshape(-1)
            cols.append(c.extract(sl))
        return np.stack(cols, axis=1)

    def create(self):
        n = int(self.get_property("num_buffers"))
        if 0 <= n <= self.i:
            return None
        freq = max(1, int(self.get_property("frequency")))
        cap = int(self.get_property("buffer_capacity"))
        if self.get_property("mode") == "device":
            vals = self._read_scans(cap)
            if vals is None:
                return None
        else:
            ch = self._num_channels()
            t = self.i * cap + np.arange(cap)
            vals = np.stack(
                [np.sin(2 * np.pi * (c + 1) * t / freq) for c in range(ch)],
                axis=1,
            ).astype(np.float32)
            time.sleep(cap / freq / 100.0)  # mock pacing, 100x realtime
        buf = TensorBuffer([vals], pts=int(self.i * 1e9 / freq))
        self.i += 1
        return buf
