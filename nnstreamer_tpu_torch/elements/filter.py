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
The window drains at EOS and at stop. Under ``error-policy=degrade``
(``pipeline/supervise.py``) a failing backend is reloaded, then reopened
with ``accelerator=true:cpu``. With a timeline active each invoke is the
frame's ``device`` span: on the card that is the host's enqueue of the
model's kernels, not their run time. The ``filter.open`` and
``filter.invoke`` fault hooks fire before the backend's open and invoke.

``throttle`` (max invokes a second) and a downstream QoS event
(``tensor_rate throttle=true``) skip invokes that come too soon
(``nns_tensor_filter_qos_drops_total``); a filter with ``throttle > 0``
is not fusible, and a QoS interval that reaches a fused region makes the
region run its members eagerly (``pipeline/fuse.py``). In a pipeline with
an SLO budget each invoke's time feeds the scheduler's service estimate
(``serving/scheduler.py``).

``shared-tensor-filter-key``: filters with one key share one opened
backend, so the weights sit on the device once (the last filter to stop
closes it). ``is-updatable=true`` lets a ``reload_model`` custom event (or
:meth:`TensorFilter.reload_model`) reopen the backend on a new model
(``nns_tensor_filter_reloads_total``); a fused region over the filter is
invalidated and captures anew. ``Pipeline.swap_model`` builds on it
(``pipeline/continuity.py``). Mesh sharding of the JAX package is not
ported yet.
"""

from __future__ import annotations

import contextlib
import time as _time
from typing import List, Optional

from nnstreamer_tpu_torch.config import get_conf
from nnstreamer_tpu_torch.filters.api import (
    FilterFramework,
    FilterProperties,
    shared_backend_acquire,
    shared_backend_release,
)
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.obs import timeline as _timeline
from nnstreamer_tpu_torch.pipeline import faults as _faults
from nnstreamer_tpu_torch.pipeline.dispatch import (
    POOL_STASH_META,
    DispatchWindow,
    release_shed_payload,
)
from nnstreamer_tpu_torch.pipeline.element import (
    CustomEvent,
    Element,
    QosEvent,
    peer_device_capable,
)
from nnstreamer_tpu_torch.registry import ELEMENT, FILTER, get_subplugin, subplugin
from nnstreamer_tpu_torch.tensors.buffer import (
    as_device_buffer,
    host_array,
    is_device_array,
)
from nnstreamer_tpu_torch.tensors.types import TensorsConfig, TensorsInfo

_MULTI = "A.24 multi-GPU serving"


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
        "throttle": 0,            # max invokes/sec; 0 = unthrottled
        # max device batches outstanding past this filter before the
        # streaming thread fences the oldest; 0 fences every batch
        "inflight": 2,
        "is_updatable": False,    # reload_model allowed
        "shared_tensor_filter_key": None,
    }
    UNPORTED_PROPERTIES = {
        "mesh": _MULTI,
        "shard": _MULTI,
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
        self._m_qos = None
        self._m_reloads = None
        self._shared_key: Optional[str] = None
        self._last_invoke_t = 0.0
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

    def _obs_reloads(self):
        """``nns_tensor_filter_reloads_total``: hot model reloads."""
        if self._m_reloads is None:
            self._m_reloads = get_registry().counter(
                "nns_tensor_filter_reloads_total",
                "Hot model reloads (RELOAD_MODEL)", **self._obs_labels())
        return self._m_reloads

    def _obs_qos(self):
        """``nns_tensor_filter_qos_drops_total``: invokes skipped by the
        throttle or a downstream QoS interval."""
        if self._m_qos is None:
            self._m_qos = get_registry().counter(
                "nns_tensor_filter_qos_drops_total",
                "Invokes skipped by throttle/QoS", **self._obs_labels())
        return self._m_qos

    def obs_snapshot(self):
        out = super().obs_snapshot()
        h = self._m_invoke
        if h is not None and h.count:
            out["invoke_p50_ms"] = round(h.percentile(50) * 1e3, 3)
            out["invoke_p99_ms"] = round(h.percentile(99) * 1e3, 3)
        if self._m_qos is not None:
            out["qos_drops"] = int(self._m_qos.value)
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
        fi = _faults.ACTIVE
        if fi is not None:
            # chaos hook: an injected open / weight-load failure
            fi.check("filter.open")
        shared_key = self.get_property("shared_tensor_filter_key")
        props = FilterProperties(
            model=model,
            custom=self.get_property("custom"),
            accelerator=self.get_property("accelerator"),
            input_info=self._forced_info("input", "inputtype"),
            output_info=self._forced_info("output", "outputtype"),
            is_updatable=bool(self.get_property("is_updatable")),
            shared_key=shared_key,
        )

        def open_backend():
            fw = factory()
            fw.open(props)
            return fw

        if shared_key:
            self.fw = shared_backend_acquire(str(shared_key), open_backend)
            self._shared_key = str(shared_key)
        else:
            self.fw = open_backend()
        return self.fw

    def _close_fw(self) -> None:
        """Close (or, when shared, let go of) the backend."""
        fw, self.fw = self.fw, None
        if fw is None:
            return
        key, self._shared_key = self._shared_key, None
        if key is not None:
            shared_backend_release(key, fw)
        else:
            fw.close()

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
        self._close_fw()
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

    # -- hot reload (reference RELOAD_MODEL) ---------------------------------
    def sink_event(self, pad, event):
        if isinstance(event, CustomEvent) and event.name == "reload_model":
            if self.fw is not None:
                self.reload_model((event.data or {}).get("model"))
            return  # consumed
        super().sink_event(pad, event)

    def reload_model(self, model: Optional[str] = None) -> None:
        """Hot reload (reference RELOAD_MODEL): reopen the backend, on
        ``model`` when given (the backend raises unless
        ``is-updatable=true``), count it and invalidate a fused region
        over the filter, which captures anew."""
        if model:
            self._props["model"] = model
        if self.fw is None:
            return
        self._window.drain()
        self.fw.handle_event("reload_model", {"model": model} if model
                             else {})
        self._obs_reloads().inc()
        self.log.info("model reloaded")
        region = getattr(self, "_fused_region", None)
        if region is not None:
            region.invalidate()

    def src_event(self, pad, event):
        """Throttle QoS from downstream (``tensor_rate throttle=true``):
        adopt the target interval and consume the event — the filter is
        the expensive element the QoS targets."""
        if isinstance(event, QosEvent):
            self._qos_interval_s = event.target_interval_ns / 1e9
            return
        super().src_event(pad, event)

    # -- hot path ------------------------------------------------------------
    def chain(self, pad, buf):
        throttle = int(self.get_property("throttle"))
        # min invoke interval: the filter's own throttle and a downstream
        # QoS interval combine; a dropped frame never reaches a fence
        if self._qos_throttled(1.0 / throttle if throttle > 0 else 0.0):
            self._obs_qos().inc()
            release_shed_payload(buf)
            return None
        fw = self.fw or self._open_fw()
        if not fw.KEEP_ON_DEVICE and any(is_device_array(t)
                                         for t in buf.tensors):
            # host-only backend consuming a device payload: one counted
            # materialization up front (cached on a resident buffer)
            buf = buf.to_host()
        in_comb = self._combination("input_combination")
        if in_comb is not None:
            model_inputs = [buf.tensors[i] for _, i in in_comb]
        else:
            model_inputs = buf.tensors
        if not fw.KEEP_ON_DEVICE:
            model_inputs = [host_array(x) for x in model_inputs]

        seq = buf.meta.get(_timeline.TRACE_SEQ_META)
        fi = _faults.ACTIVE
        if fi is not None:
            # chaos hook, BEFORE the stash pop: a retrying error policy
            # re-enters chain with the buffer's meta intact
            fi.check("filter.invoke", seq=seq)
        # a swap or reload of the weights (Pipeline.swap_model) waits for
        # this dispatch and its admission, and fences this window itself
        lock = getattr(fw, "dispatch_lock", None)
        with lock.dispatch() if lock is not None else \
                contextlib.nullcontext():
            stash = buf.meta.pop(POOL_STASH_META, None)
            t0 = _time.monotonic()
            try:
                outputs = fw.invoke(model_inputs)
            except Exception:
                if stash:
                    # a retrying error policy (or the next consumer) must
                    # still release the staging arrays at a fence
                    buf.meta[POOL_STASH_META] = stash
                raise
            t1 = _time.monotonic()
            self._obs_invoke().observe(t1 - t0)
            sched = getattr(self.pipeline, "_slo_scheduler", None)
            if sched is not None:
                # the scheduler's service-rate EWMA; the leading dim of a
                # batched input is its frame count. On the card this is the
                # enqueue time, and the scheduler takes the slower of it and
                # the sink's completion spacing
                shape = getattr(model_inputs[0], "shape", None) \
                    if model_inputs else None
                sched.observe_service(t1 - t0,
                                      frames=int(shape[0]) if shape else 1)
            tl = _timeline.ACTIVE
            if tl is not None and seq is not None:
                # from the sender's hand-off: the unfused preprocessing ahead
                # of the filter is device work too
                tl.span("device", seq,
                        buf.meta.pop(_timeline.HANDOFF_META, None) or t0, t1,
                        track=self.name)
            else:
                t1 = None

            out_comb = self._combination("output_combination")
            if out_comb is not None:
                final = [outputs[i] if k == "o" else buf.tensors[i]
                         for k, i in out_comb]
            else:
                final = list(outputs)
            # bounded asynchronous dispatch: the oldest outstanding batch
            # fences only when more than `inflight` are in flight, and the
            # staging arrays this dispatch read recycle at that fence
            self._window.admit(final, stash, frame=seq)
        out_buf = buf.with_tensors(final)
        if t1 is not None:
            out_buf.meta[_timeline.HANDOFF_META] = t1
        if peer_device_capable(self.srcpad):
            # device-capable downstream: keep the result resident
            out_buf = as_device_buffer(out_buf)
        return self.srcpad.push(out_buf)

    # -- region fusion (pipeline/fuse.py) ------------------------------------
    def device_stage(self):
        """Fusible when the backend hands over a stage and no throttle is
        configured (throttle drops are time-dependent host decisions); the
        combinations route tensors around the stage as :meth:`chain`
        does."""
        if int(self.get_property("throttle")) > 0:
            return None
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
                           device=backend_stage.device,
                           hold=backend_stage.hold)
