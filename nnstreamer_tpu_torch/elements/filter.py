"""tensor_filter — THE inference element.

Reference: ``gst/nnstreamer/elements/gsttensorfilter.c`` +
``tensor_filter_common.c``. Wraps a FilterFramework backend; negotiates
caps from the model's tensor info; per frame it invokes the backend and
records latency/throughput statistics. Supported:

- ``framework=auto`` — detect the backend from the model's extension;
- ``input``/``inputtype``/``output``/``outputtype`` — forced model shapes;
- ``input-combination``/``output-combination`` — route a subset of input
  tensors to the model and merge model outputs with passthrough inputs.

Backends with ``KEEP_ON_DEVICE`` (the torch backend) receive whatever
arrived, host array or device tensor, and return device tensors, so a
converter→transform→filter→decoder chain keeps payloads on the card;
CUDA launches are asynchronous, so pipeline stages overlap naturally.
A backend that offers a ``device_stage()`` makes the filter fusible into a
region (``pipeline/fuse.py``), with its input and output combinations.

``inflight`` (default 2) bounds the batches dispatched past this filter
and not yet complete (``pipeline/dispatch.py``): the streaming thread
fences the oldest when more are outstanding, and the pooled staging
arrays of a batch go back to the pool at its fence; 0 fences every batch.
The window drains at EOS and at stop. Model sharing, hot reload,
throttling and mesh sharding of the JAX package are not ported yet.
"""

from __future__ import annotations

import time as _time
from typing import List, Optional

from nnstreamer_tpu_torch.config import get_conf
from nnstreamer_tpu_torch.filters.api import FilterFramework, FilterProperties
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.pipeline.dispatch import (
    POOL_STASH_META,
    DispatchWindow,
)
from nnstreamer_tpu_torch.pipeline.element import (
    Element,
    peer_device_capable,
)
from nnstreamer_tpu_torch.registry import ELEMENT, FILTER, get_subplugin, subplugin
from nnstreamer_tpu_torch.tensors.buffer import (
    DeviceBuffer,
    as_device_buffer,
    host_array,
)
from nnstreamer_tpu_torch.tensors.types import TensorsConfig, TensorsInfo

_MULTI = "A.24 multi-GPU serving"
_CONTINUITY = "A.20 serving continuity"


def detect_framework(model: str) -> Optional[str]:
    """framework=auto: first loadable backend for this model's extension
    (reference gst_tensor_filter_detect_framework)."""
    for cand in get_conf().framework_priority(model):
        if get_subplugin(FILTER, cand) is not None:
            return cand
    return None


def _parse_combination(spec: Optional[str]) -> Optional[List[tuple]]:
    """Parse "i0,i2" / "o0,i1" into [(kind, idx), ...]."""
    if not spec:
        return None
    out = []
    for item in str(spec).split(","):
        item = item.strip().lower()
        if not item:
            continue
        kind, idx = item[0], item[1:]
        if kind not in ("i", "o") or not idx.isdigit():
            raise ValueError(f"bad combination item {item!r}")
        out.append((kind, int(idx)))
    return out


@subplugin(ELEMENT, "tensor_filter")
class TensorFilter(Element):
    ELEMENT_NAME = "tensor_filter"
    #: device backends consume device tensors as-is; for host-only
    #: backends chain() below materializes via the cached to_host
    DEVICE_PASSTHROUGH = True
    PROPERTIES = {
        **Element.PROPERTIES,
        "framework": "auto",
        "model": None,
        "custom": None,
        "accelerator": None,
        "input": None,            # forced input dims "3:224:224:1"
        "inputtype": None,
        "output": None,
        "outputtype": None,
        "input_combination": None,
        "output_combination": None,
        # max device batches outstanding past this filter before the
        # streaming thread fences the oldest; 0 fences every batch
        "inflight": 2,
    }
    UNPORTED_PROPERTIES = {
        "mesh": _MULTI,
        "shard": _MULTI,
        "throttle": "A.11 supervision hooks, tracing and scheduling",
        "is_updatable": _CONTINUITY,
        "shared_tensor_filter_key": _CONTINUITY,
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        self.fw: Optional[FilterFramework] = None
        self._in_model_info: Optional[TensorsInfo] = None
        self._in_full_info: Optional[TensorsInfo] = None
        self._out_model_info: Optional[TensorsInfo] = None
        self._comb_cache: dict = {}
        self._m_invoke = None  # created lazily: labels need pipeline name
        self._window = DispatchWindow(self)

    def _obs_invoke(self):
        """``nns_tensor_filter_invoke_seconds`` times only the backend
        invoke (the element-level chain histogram includes the downstream
        push); on the card it is the enqueue time of the model's kernels."""
        if self._m_invoke is None:
            self._m_invoke = get_registry().histogram(
                "nns_tensor_filter_invoke_seconds",
                "Backend invoke() latency (dispatch->result handle)",
                pipeline=getattr(self.pipeline, "name", "") or "",
                element=self.name)
        return self._m_invoke

    def obs_snapshot(self):
        out = super().obs_snapshot()
        h = self._m_invoke
        if h is not None and h.count:
            out["invoke_p50_ms"] = round(h.percentile(50) * 1e3, 3)
            out["invoke_p99_ms"] = round(h.percentile(99) * 1e3, 3)
        out.update(self._window.snapshot())
        return out

    def _combination(self, key: str):
        """Parsed input/output combination, cached off the hot path."""
        if key not in self._comb_cache:
            self._comb_cache[key] = _parse_combination(self.get_property(key))
        return self._comb_cache[key]

    def property_changed(self, key):
        if key in ("input_combination", "output_combination"):
            self._comb_cache.pop(key, None)

    # -- backend lifecycle ---------------------------------------------------
    def _open_fw(self) -> FilterFramework:
        """Open the backend once (reference
        gst_tensor_filter_common_open_fw)."""
        if self.fw is not None:
            return self.fw
        fw_name = self.get_property("framework") or "auto"
        model = self.get_property("model")
        if fw_name == "auto":
            if model is None:
                raise ValueError(f"{self.name}: framework=auto needs a model")
            fw_name = detect_framework(model)
            if fw_name is None:
                raise ValueError(
                    f"{self.name}: cannot detect framework for {model!r}")
        factory = get_subplugin(FILTER, fw_name)
        if factory is None:
            raise ValueError(f"{self.name}: no filter backend {fw_name!r}")
        fw = factory()
        fw.open(FilterProperties(
            model=model,
            custom=self.get_property("custom"),
            accelerator=self.get_property("accelerator"),
            input_info=self._forced_info("input", "inputtype"),
            output_info=self._forced_info("output", "outputtype"),
        ))
        self.fw = fw
        return fw

    def _forced_info(self, dim_key: str, type_key: str
                     ) -> Optional[TensorsInfo]:
        dims = self.get_property(dim_key)
        types = self.get_property(type_key)
        if dims is None or types is None:
            return None
        return TensorsInfo.from_str(str(dims), str(types))

    def start(self):
        super().start()
        self._open_fw()

    def stop(self):
        self._window.drain(on_error="log")
        if self.fw is not None:
            self.fw.close()
            self.fw = None
        super().stop()

    def handle_eos(self):
        # every outstanding dispatch fences before EOS crosses downstream
        self._window.drain()

    # -- negotiation ---------------------------------------------------------
    def transform_caps(self, pad, caps):
        cfg = TensorsConfig.from_caps(caps)
        fw = self._open_fw()
        in_info, out_info = fw.get_model_info()
        # the model sees the combination-selected subset, so compare that
        in_comb = self._combination("input_combination")
        model_in_cfg_info = cfg.info
        if in_comb is not None and cfg.info.is_valid():
            model_in_cfg_info = TensorsInfo(
                [cfg.info[i] for _, i in in_comb])
        if model_in_cfg_info.is_valid() and in_info is not None and \
                not model_in_cfg_info.is_equal(in_info):
            raise ValueError(
                f"{self.name}: incoming tensors {model_in_cfg_info!r} do "
                f"not match model input {in_info!r}")
        self._in_model_info = in_info or (
            model_in_cfg_info if model_in_cfg_info.is_valid() else None)
        self._in_full_info = cfg.info if cfg.info.is_valid() else None
        if out_info is None:
            if self._in_model_info is None:
                raise ValueError(f"{self.name}: input caps carry no shapes "
                                 "and the model declares none")
            out_info = fw.set_input_info(self._in_model_info)
        self._out_model_info = out_info
        final = self._combined_out_info(out_info)
        return TensorsConfig(info=final, rate=cfg.rate).to_caps()

    def _combined_out_info(self, out_info: TensorsInfo) -> TensorsInfo:
        comb = self._combination("output_combination")
        if comb is None:
            return out_info
        in_info = self._in_full_info or self._in_model_info
        return TensorsInfo([out_info[idx] if kind == "o" else in_info[idx]
                            for kind, idx in comb])

    # -- hot path ------------------------------------------------------------
    def chain(self, pad, buf):
        fw = self.fw or self._open_fw()
        if not fw.KEEP_ON_DEVICE and isinstance(buf, DeviceBuffer):
            # host-only backend consuming a resident buffer: one cached
            # materialization up front
            buf = buf.to_host()
        in_comb = self._combination("input_combination")
        if in_comb is not None:
            model_inputs = [buf.tensors[i] for _, i in in_comb]
        else:
            model_inputs = buf.tensors
        if not fw.KEEP_ON_DEVICE:
            model_inputs = [host_array(x) for x in model_inputs]

        stash = buf.meta.pop(POOL_STASH_META, None)
        t0 = _time.monotonic()
        outputs = fw.invoke(model_inputs)
        self._obs_invoke().observe(_time.monotonic() - t0)

        out_comb = self._combination("output_combination")
        if out_comb is not None:
            final = [outputs[i] if k == "o" else buf.tensors[i]
                     for k, i in out_comb]
        else:
            final = list(outputs)
        # bounded asynchronous dispatch: the oldest outstanding batch
        # fences only when more than `inflight` are in flight, and the
        # staging arrays this dispatch read recycle at that fence
        self._window.admit(final, stash)
        out_buf = buf.with_tensors(final)
        if peer_device_capable(self.srcpad):
            # device-capable downstream: keep the result resident
            out_buf = as_device_buffer(out_buf)
        return self.srcpad.push(out_buf)

    # -- region fusion (pipeline/fuse.py) ------------------------------------
    def device_stage(self):
        """Fusible when the backend hands over a stage; the combinations
        route tensors around it as :meth:`chain` does."""
        fw = self.fw
        stage_getter = getattr(fw, "device_stage", None)
        if fw is None or stage_getter is None:
            return None
        backend_stage = stage_getter()
        if backend_stage is None:
            return None
        from nnstreamer_tpu_torch.pipeline.fuse import DeviceStage

        in_comb = self._combination("input_combination")
        out_comb = self._combination("output_combination")
        inner = backend_stage.fn

        def fn(consts, tensors):
            model_in = [tensors[i] for _, i in in_comb] if in_comb \
                else tensors
            outs = inner(consts, model_in)
            if out_comb:
                return [outs[i] if k == "o" else tensors[i]
                        for k, i in out_comb]
            return list(outs)

        key = None if backend_stage.key is None else (
            "tensor_filter", backend_stage.key,
            tuple(in_comb or ()), tuple(out_comb or ()),
        )
        return DeviceStage(consts=backend_stage.consts, fn=fn, key=key,
                           device=backend_stage.device)
