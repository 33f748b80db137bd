"""tensor_repo — named global slots enabling cycles (RNN/LSTM recurrence).

Port of ``nnstreamer_tpu/elements/repo.py``. Reference:
``gst/nnstreamer/tensor_repo/`` — ``GstTensorRepo`` (hash of slots with
GCond push/pull, tensor_repo.h:36-60) + ``tensor_reposink`` /
``tensor_reposrc`` elements: a DAG-only pipeline gains feedback loops by
writing each frame's state to a slot and reading it back at the top of the
next iteration (tests/nnstreamer_repo_rnn).

Slot payloads stay where the producer left them: a CUDA tensor written by
``tensor_reposink`` (which forwards device buffers untouched, as a tee
does) is the tensor ``tensor_reposrc`` hands the next iteration, so
recurrent state (an LSTM's hidden and cell) stays on the card between
iterations with no host round trip. Only the first frame, made from
``initial-*``, is a host array. Slots can be snapshotted to the host and
restored for stateful-stream checkpointing.

The port's own :data:`GLOBAL_REPO`: the JAX package's slots are not shared.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import numpy as np

from nnstreamer_tpu_torch.pipeline.element import Element, FlowError, FlowReturn
from nnstreamer_tpu_torch.pipeline.pipeline import SourceElement
from nnstreamer_tpu_torch.registry import ELEMENT, subplugin
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer, as_torch, host_array
from nnstreamer_tpu_torch.tensors.types import (
    TensorInfo,
    TensorsConfig,
    TensorsInfo,
)


class TensorRepo:
    """Process-global named slots with blocking get (GCond semantics)."""

    def __init__(self):
        self._slots: Dict[str, Any] = {}
        self._cv = threading.Condition()

    def set(self, slot: str, buf: TensorBuffer) -> None:
        with self._cv:
            self._slots[slot] = buf
            self._cv.notify_all()

    def get(self, slot: str, timeout: Optional[float] = None,
            consume: bool = False,
            cancel: Optional[threading.Event] = None
            ) -> Optional[TensorBuffer]:
        """The slot's buffer (taken out of the repo with ``consume``).
        With ``timeout``, waits up to that long for the slot to fill and
        returns None when it does not, or as soon as ``cancel`` is set
        (:meth:`wake` makes a waiter look)."""
        with self._cv:
            if timeout is not None:
                deadline = time.monotonic() + timeout
                while slot not in self._slots:
                    left = deadline - time.monotonic()
                    if left <= 0 or (cancel is not None and cancel.is_set()):
                        return None
                    self._cv.wait(timeout=left)
            buf = self._slots.get(slot)
            if consume and slot in self._slots:
                del self._slots[slot]
            return buf

    def wake(self) -> None:
        """Make every waiting :meth:`get` re-check its slot and cancel."""
        with self._cv:
            self._cv.notify_all()

    def peek(self, slot: str) -> Optional[TensorBuffer]:
        with self._cv:
            return self._slots.get(slot)

    def remove(self, slot: str) -> bool:
        with self._cv:
            return self._slots.pop(slot, None) is not None

    def snapshot(self) -> Dict[str, list]:
        """Host-side snapshot of all slots (checkpoint of stream state):
        numpy arrays, or CPU tensors for ``bfloat16``."""
        with self._cv:
            items = list(self._slots.items())
        return {k: [host_array(t) for t in v.tensors] for k, v in items}

    def restore(self, state: Dict[str, list], device=None) -> None:
        """Put a :meth:`snapshot` back: host arrays, or tensors on
        ``device`` (a checkpoint restored onto the package device)."""
        if device is not None:
            state = {k: [as_torch(a, device) for a in arrays]
                     for k, arrays in state.items()}
        with self._cv:
            for k, arrays in state.items():
                self._slots[k] = TensorBuffer(list(arrays))
            self._cv.notify_all()


#: the process-global repo (reference: one static GstTensorRepo)
GLOBAL_REPO = TensorRepo()


@subplugin(ELEMENT, "tensor_reposink")
class TensorRepoSink(Element):
    """Writes each buffer into a repo slot (reference tensor_reposink.c)."""

    ELEMENT_NAME = "tensor_reposink"
    #: the slot holds the buffer by reference: a device payload stays on
    #: the device for the next iteration's reposrc
    DEVICE_PASSTHROUGH = True
    PROPERTIES = {**Element.PROPERTIES, "slot_index": 0, "slot": None}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")

    def _slot(self) -> str:
        return str(self.get_property("slot") or
                   self.get_property("slot_index"))

    def chain(self, pad, buf):
        GLOBAL_REPO.set(self._slot(), buf)
        return FlowReturn.OK


@subplugin(ELEMENT, "tensor_reposrc")
class TensorRepoSrc(SourceElement):
    """Reads a repo slot each iteration (reference tensor_reposrc.c).

    ``initial-dim``/``initial-type``/``initial-value`` provide the frame
    pushed before the loop produces its first state (the reference reads a
    caps-sized zero frame)."""

    ELEMENT_NAME = "tensor_reposrc"
    PROPERTIES = {
        **SourceElement.PROPERTIES,
        "slot_index": 0,
        "slot": None,
        "num_buffers": -1,
        "initial_dim": None,
        "initial_type": "float32",
        "initial_value": 0.0,
        "timeout": 10.0,
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.i = 0

    def _slot(self) -> str:
        return str(self.get_property("slot") or
                   self.get_property("slot_index"))

    def negotiate(self):
        dim = self.get_property("initial_dim")
        if dim:
            info = TensorsInfo.from_str(str(dim),
                                        str(self.get_property("initial_type")))
            self.srcpad.set_caps(TensorsConfig(info=info).to_caps())

    def create(self):
        n = int(self.get_property("num_buffers"))
        if 0 <= n <= self.i:
            return None
        if self.i == 0 and self.get_property("initial_dim"):
            info = TensorInfo.from_str(
                str(self.get_property("initial_dim")),
                str(self.get_property("initial_type")),
            )
            arr = np.full(info.shape, float(self.get_property("initial_value")),
                          info.type.np_dtype)
            self.i += 1
            return TensorBuffer([arr], pts=0)
        t = float(self.get_property("timeout"))
        buf = GLOBAL_REPO.get(self._slot(), timeout=t, consume=True,
                              cancel=self._stop_evt)
        if buf is None:
            # (the guard at the top already returned for i >= n)
            if n >= 0 and not self._stop_evt.is_set():
                # the pipeline promised n iterations and the loop state
                # vanished mid-count: that is a WEDGED loop (producer
                # died / reposink unlinked), not a drain — fail loudly
                # so failure detection sees it instead of a clean EOS.
                # A deliberate stop() mid-wait is NOT a wedge.
                raise FlowError(
                    f"tensor_reposrc: slot {self._slot()!r} starved "
                    f"after {self.i}/{n} iterations (timeout {t}s) — "
                    "repo loop wedged")
            return None  # endless loop drained / pipeline stopping → EOS
        self.i += 1
        return buf.replace(pts=self.i)

    def start(self):
        super().start()
        # restart semantics (gst NULL→PLAYING), as videotestsrc's: the
        # iteration count resets, so a restarted loop runs its
        # num-buffers again from the initial frame
        self.i = 0

    def stop(self):
        super().stop()
        GLOBAL_REPO.wake()  # a create() waiting on the slot sees the stop
