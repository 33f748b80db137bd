"""tensor_decoder — tensors → media, via decoder subplugins.

Reference: ``gst/nnstreamer/elements/gsttensordecoder.c`` with the
subplugin API ``GstTensorDecoderDef``. A decoder subplugin is an object
(or class) with ``out_caps(config, options) -> Caps`` and
``decode(buf, config, options) -> TensorBuffer``, where ``options`` is the
dict of ``option1..option9`` strings.

A subplugin may also split itself in two, as the JAX package's fused
regions split it: ``device_kernel(options) -> (consts, fn)`` (or None for
a mode that only decodes on the host) computes on the device and
``host_finalize(buf, config, options)`` completes on the host. The port runs the device half where a tensor payload lies (the
card, or the CPU when asked for) as soon as it arrives, and attaches the host half as the buffer's deferred
``finalize``: only the device half's small results cross to the host, at
the sink's (or a ``materialize-host`` queue's) fetch point. The same two
halves make the decoder a fused-region stage (``pipeline/fuse.py``) that
ends its region. With a timeline active the host part — the chain's
decode, or the deferred finalize wherever it runs — is the frame's
``decode`` span.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from nnstreamer_tpu_torch.obs import timeline as _timeline
from nnstreamer_tpu_torch.pipeline.element import Element
from nnstreamer_tpu_torch.registry import DECODER, ELEMENT, get_subplugin, subplugin
from nnstreamer_tpu_torch.tensors.types import TensorsConfig


def _decode_span(fn, buf, *args):
    """``fn(buf, *args)``, recorded as ``buf``'s ``decode`` span when a
    timeline is active: from the sender's hand-off reading where it left
    one, to a reading the output carries on as its own hand-off."""
    tl = _timeline.ACTIVE
    if tl is None:
        return fn(buf, *args)
    t0 = buf.meta.pop(_timeline.HANDOFF_META, None) or time.monotonic()
    out = fn(buf, *args)
    seq = buf.meta.get(_timeline.TRACE_SEQ_META)
    if seq is not None:
        t1 = time.monotonic()
        tl.span("decode", seq, t0, t1, track="decode")
        out.meta[_timeline.HANDOFF_META] = t1
    return out


@subplugin(ELEMENT, "tensor_decoder")
class TensorDecoder(Element):
    ELEMENT_NAME = "tensor_decoder"
    #: device payloads enter as they are: the chain below runs the device
    #: half on them or owns their materialization
    DEVICE_PASSTHROUGH = True
    PROPERTIES = {
        **Element.PROPERTIES,
        "mode": None,
        **{f"option{i}": None for i in range(1, 10)},
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        self._dec = None
        self._config: Optional[TensorsConfig] = None

    def _options(self) -> Dict[str, str]:
        return {
            f"option{i}": self.get_property(f"option{i}")
            for i in range(1, 10)
            if self.get_property(f"option{i}") is not None
        }

    def _get_decoder(self):
        mode = self.get_property("mode")
        if mode is None:
            raise ValueError(f"{self.name}: mode not set")
        if self._dec is None:
            impl = get_subplugin(DECODER, mode)
            if impl is None:
                raise ValueError(f"{self.name}: no decoder subplugin {mode!r}")
            self._dec = impl() if isinstance(impl, type) else impl
        return self._dec

    def transform_caps(self, pad, caps):
        self._config = TensorsConfig.from_caps(caps)
        dec = self._get_decoder()
        return dec.out_caps(self._config, self._options())

    # -- region fusion (pipeline/fuse.py) ------------------------------------
    def device_stage(self):
        """The device half as a region stage, the host half as its
        ``finalize``; a subplugin without both halves stays unfused. The
        stage runs where its inputs lie, so it names no device."""
        dec = self._get_decoder()
        kernel = getattr(dec, "device_kernel", None)
        host_finalize = getattr(dec, "host_finalize", None)
        if kernel is None or host_finalize is None:
            return None
        from nnstreamer_tpu_torch.pipeline.fuse import DeviceStage

        options = self._options()
        split = kernel(options)
        if split is None:  # a mode with host-only semantics
            return None
        consts, fn = split

        def finalize(host_buf):
            return _decode_span(host_finalize, host_buf, self._config,
                                options)

        return DeviceStage(
            consts=consts, fn=fn,
            key=("decoder", self.get_property("mode"),
                 tuple(sorted(options.items()))),
            finalize=finalize)

    def chain(self, pad, buf):
        dec = self._get_decoder()
        options = self._options()
        kernel = getattr(dec, "device_kernel", None)
        finalize = getattr(dec, "host_finalize", None)
        split = None
        if kernel is not None and finalize is not None and buf.tensors and \
                all(isinstance(t, torch.Tensor) for t in buf.tensors):
            split = kernel(options)  # None: a mode with host-only semantics
        if split is not None:
            consts, fn = split
            config = self._config

            def complete(host_buf):
                return _decode_span(finalize, host_buf, config, options)

            out = buf.replace(tensors=fn(consts, list(buf.tensors)),
                              finalize=complete)
            return self.srcpad.push(out)
        # materialize FIRST so the d2h span (recorded inside to_host) is
        # not counted again under the decode span
        host = buf.to_host()
        return self.srcpad.push(_decode_span(dec.decode, host, self._config,
                                             options))
