"""tensor_decoder — tensors → media, via decoder subplugins.

Reference: ``gst/nnstreamer/elements/gsttensordecoder.c`` with the
subplugin API ``GstTensorDecoderDef``. A decoder subplugin is an object
(or class) with ``out_caps(config, options) -> Caps`` and
``decode(buf, config, options) -> TensorBuffer``, where ``options`` is the
dict of ``option1..option9`` strings.

A subplugin may also split itself in two, as the JAX package's fused
regions split it: ``device_kernel(options) -> (consts, fn)`` computes on
the device and ``host_finalize(buf, config, options)`` completes on the
host. The port runs the device half where a tensor payload lies (the
card, or the CPU when asked for) as soon as it arrives, and attaches the host half as the buffer's deferred
``finalize``: only the device half's small results cross to the host, at
the sink's (or a ``materialize-host`` queue's) fetch point. The same two
halves make the decoder a fused-region stage (``pipeline/fuse.py``) that
ends its region.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from nnstreamer_tpu_torch.pipeline.element import Element
from nnstreamer_tpu_torch.registry import DECODER, ELEMENT, get_subplugin, subplugin
from nnstreamer_tpu_torch.tensors.types import TensorsConfig


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
        consts, fn = kernel(options)

        def finalize(host_buf):
            return host_finalize(host_buf, self._config, options)

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
        if kernel is not None and finalize is not None and buf.tensors and \
                all(isinstance(t, torch.Tensor) for t in buf.tensors):
            consts, fn = kernel(options)
            config = self._config

            def complete(host_buf):
                return finalize(host_buf, config, options)

            out = buf.replace(tensors=fn(consts, list(buf.tensors)),
                              finalize=complete)
            return self.srcpad.push(out)
        return self.srcpad.push(dec.decode(buf.to_host(), self._config,
                                           options))
