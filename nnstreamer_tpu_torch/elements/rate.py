"""tensor_rate — framerate adjustment + QoS throttling.

A copy of the JAX package's ``elements/rate.py`` (no JAX in it).
Reference: ``gst/nnstreamer/elements/gsttensorrate.c``: converts stream
framerate by dropping/duplicating frames and, with ``throttle=true``,
propagates QoS so upstream inference skips work for frames that would be
dropped. Here the QoS rides a :class:`QosEvent` upstream (posted at caps
time and whenever the target rate changes); ``tensor_filter`` honors it
in its invoke drop check, and a fused region holding the filter at its
dispatch.

``silent`` (reference gsttensorrate "silent" property) gates per-drop /
per-duplicate debug logging; counters are always kept.
"""

from __future__ import annotations

from typing import Optional

from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.pipeline.element import Element, QosEvent
from nnstreamer_tpu_torch.registry import ELEMENT, subplugin
from nnstreamer_tpu_torch.tensors.types import Fraction, TensorsConfig


@subplugin(ELEMENT, "tensor_rate")
class TensorRate(Element):
    ELEMENT_NAME = "tensor_rate"
    DEVICE_PASSTHROUGH = True  # drops/duplicates whole buffers only
    PROPERTIES = {**Element.PROPERTIES, "framerate": None, "throttle": True,
                  "silent_drop": None}  # deprecated alias of `silent`

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        self._in_rate: Optional[Fraction] = None
        self._next_ts: Optional[float] = None  # set from first buffer's pts
        self._posted_interval: Optional[int] = None
        self.dropped = 0
        self.duplicated = 0
        self.out_count = 0
        self._m_dropped = None     # registry counters, created lazily so
        self._m_duplicated = None  # labels carry the owning pipeline name

    def _obs_counters(self):
        if self._m_dropped is None:
            reg = get_registry()
            labels = self._obs_labels()
            self._m_dropped = reg.counter(
                "nns_tensor_rate_dropped_total",
                "Frames dropped by framerate conversion", **labels)
            self._m_duplicated = reg.counter(
                "nns_tensor_rate_duplicated_total",
                "Frames duplicated by framerate conversion", **labels)
        return self._m_dropped, self._m_duplicated

    def obs_snapshot(self):
        out = super().obs_snapshot()
        out["drops"] = self.dropped
        out["duplicates"] = self.duplicated
        return out

    def _out_rate(self) -> Optional[Fraction]:
        spec = self.get_property("framerate")
        return Fraction.parse(spec) if spec else None

    def _post_qos(self) -> None:
        """Tell upstream the target inter-frame interval (0 lifts it)."""
        out = self._out_rate()
        interval = 0
        if bool(self.get_property("throttle")) and out is not None \
                and out.num > 0:
            interval = out.frame_duration_ns or 0
        # initial None counts as 0: a rate with no throttle to announce
        # must stay silent, not post a lift that cancels an upstream
        # rate's throttle mid-negotiation
        if interval != (self._posted_interval or 0):
            self.sinkpads[0].push_upstream_event(
                QosEvent(target_interval_ns=interval))
        self._posted_interval = interval

    def property_changed(self, key):
        if key == "silent_drop":  # deprecated alias, kept for old strings
            v = self.get_property("silent_drop")
            if v is not None:  # launch strings deliver str, API bool
                self.set_property("silent", str(v).strip().lower()
                                  in ("1", "true", "yes", "on"))
            return
        # guard: set_property runs from __init__ before our fields exist
        if key in ("framerate", "throttle") and \
                getattr(self, "_posted_interval", None) is not None:
            self._post_qos()

    def transform_caps(self, pad, caps):
        try:
            cfg = TensorsConfig.from_caps(caps)
            self._in_rate = cfg.rate
            out = self._out_rate()
            self._post_qos()
            if out is not None:
                cfg.rate = out
                return cfg.to_caps()
        except ValueError:
            pass
        return caps

    def chain(self, pad, buf):
        out_rate = self._out_rate()
        if out_rate is None or out_rate.num <= 0 or buf.pts is None:
            return self.srcpad.push(buf)
        period_ns = 1e9 * out_rate.den / out_rate.num
        if self._next_ts is None:
            self._next_ts = float(buf.pts)  # clock starts at the stream's
            # first timestamp (streams may carry wall-clock pts)
        ret = None
        pushed = False
        m_drop, m_dup = self._obs_counters()
        # emit one output per elapsed output period; duplicate if input is
        # slower, drop if faster
        while buf.pts >= self._next_ts:
            out = buf.replace(pts=int(self._next_ts),
                              duration=int(period_ns))
            ret = self.srcpad.push(out)
            self._next_ts += period_ns
            self.out_count += 1
            if pushed:
                self.duplicated += 1
                m_dup.inc()
                if not self.get_property("silent"):
                    self.log.debug("duplicated frame at pts %d", out.pts)
            pushed = True
        if not pushed:
            self.dropped += 1
            m_drop.inc()
            if not self.get_property("silent"):
                self.log.debug("dropped frame at pts %d (total %d)",
                               buf.pts, self.dropped)
        return ret
