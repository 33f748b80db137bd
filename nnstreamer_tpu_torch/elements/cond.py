"""tensor_if — conditional stream branching on tensor values.

Port of ``nnstreamer_tpu/elements/cond.py``. Reference: ``gst/nnstreamer/elements/gsttensorif.c`` (1161 LoC,
tensor_if/README.md): evaluates a condition on incoming tensors —
compared-value ``A_VALUE`` (scalar at an index) or ``TENSOR_AVERAGE_VALUE``,
or a registered CUSTOM callback (include/tensor_if.h) — against
``supplied-value`` with one of 10 operators, then routes the buffer
according to ``then``/``else`` actions: PASSTHROUGH, SKIP, or TENSORPICK.

Two src pads: ``src_true`` (then) and ``src_false`` (else); with
``action=SKIP`` the corresponding branch simply receives nothing.

The condition is evaluated on the host, as in the JAX package: the
element is not ``DEVICE_PASSTHROUGH``, so a device payload arrives
fetched (one counted D2H, ``TensorBuffer.to_host``) and the branches get
that host buffer.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict

from nnstreamer_tpu_torch.pipeline.element import CapsEvent, Element, FlowReturn
from nnstreamer_tpu_torch.registry import ELEMENT, subplugin
from nnstreamer_tpu_torch.tensors import data as tdata
from nnstreamer_tpu_torch.tensors.buffer import is_device_array

_custom_conds: Dict[str, Callable] = {}
_lock = threading.Lock()


def register_if_condition(name: str, fn: Callable) -> None:
    """Register a custom condition ``fn(buf) -> bool`` (reference
    nnstreamer_if_custom_register, include/tensor_if.h)."""
    with _lock:
        _custom_conds[name] = fn


_OPS = {
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "range_inclusive": lambda a, b: b[0] <= a <= b[1],
    "range_exclusive": lambda a, b: b[0] < a < b[1],
    "not_in_range_inclusive": lambda a, b: not (b[0] <= a <= b[1]),
    "not_in_range_exclusive": lambda a, b: not (b[0] < a < b[1]),
}


@subplugin(ELEMENT, "tensor_if")
class TensorIf(Element):
    ELEMENT_NAME = "tensor_if"
    PROPERTIES = {
        **Element.PROPERTIES,
        "compared_value": "A_VALUE",         # A_VALUE | TENSOR_AVERAGE_VALUE | CUSTOM
        "compared_value_option": "0:0:0:0,0",  # coords,tensor-idx (A_VALUE) / tensor idx / custom name
        "operator": "gt",
        "supplied_value": "0",
        "then": "PASSTHROUGH",
        "then_option": None,
        "else": "SKIP",
        "else_option": None,
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.add_src_pad("src_true")
        self.add_src_pad("src_false")

    # second pad alias for parse/link ergonomics
    @property
    def src_true(self):
        return self.srcpads[0]

    @property
    def src_false(self):
        return self.srcpads[1]

    def _compared_value(self, buf) -> float:
        cv = str(self.get_property("compared_value")).upper()
        opt = str(self.get_property("compared_value_option") or "")
        if cv == "A_VALUE":
            coords_part, _, tidx_part = opt.partition(",")
            tidx = int(tidx_part) if tidx_part else 0
            arr = tdata.host_numpy(buf.tensors[tidx])
            coords = [int(c) for c in coords_part.split(":") if c != ""]
            # coords are innermost-first dims → numpy index is reversed
            idx = tuple(reversed(coords))[-arr.ndim:] if arr.ndim else ()
            idx = tuple(0 for _ in range(arr.ndim - len(idx))) + idx
            return float(arr[idx])
        if cv == "TENSOR_AVERAGE_VALUE":
            tidx = int(opt) if opt else 0
            return tdata.average(buf.tensors[tidx])
        raise ValueError(f"tensor_if: unknown compared_value {cv!r}")

    def _supplied(self):
        sv = str(self.get_property("supplied_value"))
        if ":" in sv:
            return tuple(float(x) for x in sv.split(":")[:2])
        return float(sv)

    def _evaluate(self, buf) -> bool:
        cv = str(self.get_property("compared_value")).upper()
        if cv == "CUSTOM":
            name = str(self.get_property("compared_value_option") or "")
            with _lock:
                fn = _custom_conds.get(name)
            if fn is None:
                raise ValueError(f"tensor_if: no custom condition {name!r}")
            return bool(fn(buf))
        op = str(self.get_property("operator")).lower()
        if op not in _OPS:
            raise ValueError(f"tensor_if: unknown operator {op!r}")
        return bool(_OPS[op](self._compared_value(buf), self._supplied()))

    def _route(self, buf, branch: str):
        action = str(self.get_property(branch) or "SKIP").upper()
        pad = self.src_true if branch == "then" else self.src_false
        if action == "SKIP":
            return FlowReturn.OK
        if action == "PASSTHROUGH":
            return pad.push(buf)
        if action == "TENSORPICK":
            opt = str(self.get_property(f"{branch}_option") or "0")
            idxs = [int(i) for i in opt.split(",")]
            return pad.push(buf.with_tensors([buf.tensors[i] for i in idxs]))
        raise ValueError(f"tensor_if: unknown action {action!r}")

    def chain(self, pad, buf):
        if any(is_device_array(t) for t in buf.tensors):
            # a device payload no resident wrapper carried (a resident one
            # was fetched at pad entry): the same one counted fetch
            buf = buf.to_host()
        return self._route(buf, "then" if self._evaluate(buf) else "else")

    def sink_event(self, pad, event):
        if isinstance(event, CapsEvent):
            # both branches may get full or picked tensors; forward caps only
            # for PASSTHROUGH branches (TENSORPICK caps derive per-buffer)
            for branch, sp in (("then", self.src_true),
                               ("else", self.src_false)):
                if str(self.get_property(branch)).upper() == "PASSTHROUGH":
                    sp.set_caps(event.caps)
            return
        super().sink_event(pad, event)
