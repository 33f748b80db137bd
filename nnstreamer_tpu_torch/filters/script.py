"""Inline-script filter backend (reference ``tensor_filter_lua.cc``:
filters defined by a script string or file, no compiled model needed).

Port of ``nnstreamer_tpu/filters/script.py``. The script is a tiny Python
program in the numpy idiom; the same text runs on both packages::

    tensor_filter framework=script model="y = jnp.tanh(x) * 2.0"
    tensor_filter framework=script model=my_filter.jaxs   # same, from file

Inputs are bound as ``x0..xN`` (and ``x`` = ``x0``, ``n_inputs``);
outputs are whatever the script assigns to ``y0..yN`` (or ``y``).

- **Device mode** (default): the script runs eagerly on the filter's
  device, once a frame. ``jnp`` and ``np`` are ``torch._numpy``, a numpy
  surface over torch tensors, so ``jnp.mean(x)`` or ``x.astype(
  jnp.float32)`` launch torch ops on the card; ``torch`` is bound too.
  Outputs leave the filter as torch tensors on the device, 64-bit results
  narrowed to the 32-bit widths the JAX package gives (it runs with x64
  off). The structured ops are bound as ``cond``, ``switch``, ``select``,
  ``while_loop``, ``fori_loop`` (and under ``lax.`` / ``jax.lax.``):
  ``cond`` and ``switch`` with an array predicate evaluate every branch
  and select the result on the device (the branches must agree in shape
  and dtype, as ``lax.cond`` requires), so no frame reads the host;
  ``select`` is ``where``; ``while_loop`` and ``fori_loop`` read their
  bounds on the host each step. Any other ``jax.*`` or ``lax.*`` name
  raises ``NameError``. The JAX package instead traces the script once
  under ``jax.jit``, so a script there obeys the tracer's rules, which
  eager torch does not impose (ROADMAP C.47). ``torch._numpy`` has no
  bfloat16 (numpy has none), so a bfloat16 input raises.
- ``custom=mode:host``: interpreted per frame on the host over numpy
  arrays, the reference's lua semantics — a copy of the JAX package's host
  mode: the same shims, the same narrowing, and each frame's outputs held
  to the shapes and dtypes negotiation announced.

Negotiation runs a device-mode script on the meta device (no data, no
kernels); a script that reads a value there (a ``while_loop``'s
condition, a ``float(...)``) runs once on an all-ones probe on the
filter's device instead, as host mode always does. The filter is not
fusible, as the JAX package's offers no fused stage.
"""

from __future__ import annotations

import os
import re
import types
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from nnstreamer_tpu_torch.device import resolve_device
from nnstreamer_tpu_torch.filters.api import (
    FilterFramework,
    FilterProperties,
    parse_custom,
)
from nnstreamer_tpu_torch.registry import FILTER, subplugin
from nnstreamer_tpu_torch.tensors.buffer import as_torch
from nnstreamer_tpu_torch.tensors.types import TensorInfo, TensorsInfo, TensorType

_Y_RE = re.compile(r"^y(\d+)$")
_DELTA = "ROADMAP.md C.47"


def _host_cond(pred, true_fn, false_fn, *operands):
    return true_fn(*operands) if pred else false_fn(*operands)


def _host_while(cond_fn, body_fn, init):
    val = init
    while cond_fn(val):
        val = body_fn(val)
    return val


def _host_fori(lo, hi, body_fn, init):
    val = init
    for i in range(int(lo), int(hi)):
        val = body_fn(i, val)
    return val


def _host_switch(index, branches, *operands):
    i = min(max(int(index), 0), len(branches) - 1)  # lax.switch clamps
    return branches[i](*operands)


_HOST_OPS = dict(cond=_host_cond, while_loop=_host_while,
                 fori_loop=_host_fori, switch=_host_switch,
                 select=np.where)


def _host_lax():
    """Fresh `lax.*` shim namespace per filter open: a script that
    rebinds a shim must not leak the mutation into every other
    host-mode filter in the process."""
    return types.SimpleNamespace(**_HOST_OPS)

#: numpy promotes to 64-bit where jax (x64 disabled) stays 32-bit; host
#: outputs are narrowed to the device-mode widths so one script
#: negotiates the SAME output dtypes in both modes
_HOST_DTYPE_NARROW = {np.dtype(np.float64): np.float32,
                      np.dtype(np.int64): np.int32,
                      np.dtype(np.uint64): np.uint32,
                      np.dtype(np.complex128): np.complex64}


def _narrow_host(arr: np.ndarray) -> np.ndarray:
    tgt = _HOST_DTYPE_NARROW.get(arr.dtype)
    return arr.astype(tgt) if tgt is not None else arr


#: the device mode's 64-bit results, narrowed as the host mode's
_DEVICE_DTYPE_NARROW = {torch.float64: torch.float32,
                        torch.int64: torch.int32,
                        torch.complex128: torch.complex64}
#: the input types ``torch._numpy`` takes (numpy's; no bfloat16)
_DEVICE_INPUT_TYPES = (torch.bool, torch.uint8, torch.int8, torch.int16,
                       torch.int32, torch.int64, torch.float16,
                       torch.float32, torch.float64, torch.complex64,
                       torch.complex128)


class _Namespace(types.SimpleNamespace):
    """``lax`` or ``jax`` in a device-mode script: the names the port
    binds, and a ``NameError`` naming the delta for any other."""

    def __init__(self, prefix: str, **names):
        super().__init__(**names)
        self._prefix = prefix

    def __getattr__(self, name):  # only for names not bound
        if name.startswith("_"):
            raise AttributeError(name)
        raise NameError(
            f"script: {self._prefix}.{name} is not available in the port's "
            f"device mode ({_DELTA}: the script runs eagerly over torch; "
            "bound are jnp/np, cond, switch, select, while_loop and "
            "fori_loop)")


def _device_ops(tnp) -> Dict[str, Any]:
    """The structured ops of device mode over ``torch._numpy`` arrays."""

    def is_array(v) -> bool:
        return isinstance(v, (tnp.ndarray, torch.Tensor))

    def merge(pred, a, b):
        if isinstance(a, (tuple, list)):
            if not isinstance(b, (tuple, list)) or len(a) != len(b):
                raise TypeError("cond/switch: branches must return the "
                                "same structure")
            return type(a)(merge(pred, x, y) for x, y in zip(a, b))
        a, b = tnp.asarray(a), tnp.asarray(b)
        if a.shape != b.shape or a.dtype != b.dtype:
            raise TypeError(
                f"cond/switch: branches must agree in shape and dtype, got "
                f"{tuple(a.shape)}:{a.dtype} and {tuple(b.shape)}:{b.dtype}")
        return tnp.where(pred, a, b)

    def cond(pred, true_fn, false_fn, *operands):
        if not is_array(pred):
            return _host_cond(pred, true_fn, false_fn, *operands)
        return merge(tnp.asarray(pred), true_fn(*operands),
                     false_fn(*operands))

    def switch(index, branches, *operands):
        if not is_array(index):
            return _host_switch(index, branches, *operands)
        i = tnp.clip(tnp.asarray(index), 0, len(branches) - 1)
        outs = [br(*operands) for br in branches]
        out = outs[-1]
        for k in range(len(outs) - 2, -1, -1):
            out = merge(i == k, outs[k], out)
        return out

    return dict(cond=cond, while_loop=_host_while, fori_loop=_host_fori,
                switch=switch, select=tnp.where)


@subplugin(FILTER, "script")
class ScriptFilter(FilterFramework):
    """Script filters: eager torch on the filter's device, or
    ``custom=mode:host`` for per-frame interpreted numpy (lua-parity
    semantics)."""

    NAME = "script"
    KEEP_ON_DEVICE = True

    def __init__(self):
        super().__init__()
        self._src: Optional[str] = None
        self._code = None
        self._host_mode = False
        self._device: Optional[torch.device] = None
        self._in_info: Optional[TensorsInfo] = None
        #: host mode: negotiated output (shape, dtype) pairs — the
        #: interpreter has no tracer to freeze shapes, so invoke()
        #: validates each frame's outputs against what negotiation
        #: announced (a data-dependent shape fails HERE, loudly, not in
        #: a downstream element sized off stale caps)
        self._out_spec = None

    # -- vtable --------------------------------------------------------------
    def open(self, props: FilterProperties) -> None:
        super().open(props)
        src = props.model or ""
        if os.path.isfile(src):
            with open(src, "r", encoding="utf-8") as f:
                src = f.read()
        if not src.strip():
            raise ValueError("script: empty script (model property)")
        mode = parse_custom(props.custom).get("mode", "device")
        if mode not in ("device", "host"):
            raise ValueError(
                f"script: mode must be 'device' or 'host', got {mode!r}")
        self._host_mode = mode == "host"
        # reset per open(): a reused instance must not validate frames
        # against a PREVIOUS script's negotiated output spec
        self._out_spec = None
        # set on BOTH branches: a reused instance re-opened in device
        # mode must win back the on-device path
        self.KEEP_ON_DEVICE = not self._host_mode
        self._device = None if self._host_mode else \
            resolve_device(props.accelerator)
        self._src = src
        self._code = compile(src, "<tensor_filter_script>", "exec")
        if self._host_mode:
            host_lax = _host_lax()
            # jnp aliases numpy and `lax` exposes the same shims, so
            # device-flavored scripts (lax.cond spelling included) run
            # unchanged
            self._namespace = lambda: {
                "np": np, "jnp": np, "lax": host_lax, **_HOST_OPS}
        else:
            import torch._numpy as tnp

            self._tnp = tnp
            ops = _device_ops(tnp)
            lax = _Namespace("lax", **ops)
            jax = _Namespace("jax", lax=lax, numpy=tnp)
            self._namespace = lambda: {
                "jnp": tnp, "np": tnp, "torch": torch, "lax": lax,
                "jax": jax, **ops}

    def close(self) -> None:
        self._src = self._code = None
        super().close()

    def _run(self, *inputs) -> list:
        """One run of the script: inputs bound, outputs in ``y`` order."""
        ns = self._namespace()
        for i, x in enumerate(inputs):
            ns[f"x{i}"] = x
        ns["x"] = inputs[0]
        ns["n_inputs"] = len(inputs)
        exec(self._code, ns)
        if "y" in ns and not any(_Y_RE.match(k) for k in ns):
            return [ns["y"]]
        outs = sorted(
            ((int(_Y_RE.match(k).group(1)), v) for k, v in ns.items()
             if _Y_RE.match(k)),
            key=lambda kv: kv[0],
        )
        if not outs:
            raise ValueError("script: script must assign y (or y0..yN)")
        return [v for _, v in outs]

    def _run_host(self, *inputs) -> List[np.ndarray]:
        return [_narrow_host(np.asarray(v)) for v in self._run(*inputs)]

    def _run_device(self, tensors: Sequence[torch.Tensor],
                    device: torch.device) -> List[torch.Tensor]:
        """The script over ``torch._numpy`` views of ``tensors``; outputs
        unwrapped to torch tensors on ``device``, 64-bit narrowed."""
        tnp = self._tnp
        for t in tensors:
            if t.dtype not in _DEVICE_INPUT_TYPES:
                raise TypeError(
                    f"script: device mode takes no {t.dtype} input "
                    f"({_DELTA}: its numpy surface has numpy's types; "
                    "typecast first, or use custom=mode:host)")
        with torch.inference_mode():
            outs = self._run(*[tnp.asarray(t) for t in tensors])
            result = []
            for v in outs:
                t = v.tensor if isinstance(v, tnp.ndarray) else \
                    torch.as_tensor(v)
                t = t.to(device, _DEVICE_DTYPE_NARROW.get(t.dtype, t.dtype))  # nns-lint: disable=NNS113 -- a script result on the frame's device: a no-op for device results, a host scalar otherwise
                result.append(t)
        return result

    def set_input_info(self, in_info: TensorsInfo) -> TensorsInfo:
        self._in_info = in_info
        if self._host_mode:
            # the interpreter has no tracer: probe shapes with one real
            # execution. Ones, not zeros — value-dependent loops whose
            # progress rides on nonzero data (doubling until a bound,
            # mean-gated branches) must not spin forever on an all-zero
            # probe. Negotiation DOES run the script once in this mode.
            dummies = [np.ones(t.shape, t.type.np_dtype) for t in in_info]
            outs = self._run_host(*dummies)
            self._out_spec = [(tuple(o.shape), np.dtype(o.dtype))
                              for o in outs]
        else:
            def probe(device, fill):
                return self._run_device(
                    [fill(t.shape, dtype=t.type.torch_dtype, device=device)
                     for t in in_info], device)

            meta = torch.device("meta")
            try:
                outs = probe(meta, torch.empty)
            except (RuntimeError, NotImplementedError):
                # the script reads a value (Tensor.item) or makes a
                # data-dependent shape (nonzero) there: run it once
                outs = probe(self._device, torch.ones)
        return TensorsInfo([
            TensorInfo(dim=tuple(reversed(tuple(o.shape))),
                       type=TensorType.from_any(o.dtype))
            for o in outs
        ])

    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        with self.global_stats().measure():
            if not self._host_mode:
                return self._run_device(
                    [as_torch(x, self._device) for x in inputs],
                    self._device)
            outs = self._run_host(*[np.asarray(x) for x in inputs])
            if self._out_spec is not None:
                if len(outs) != len(self._out_spec):
                    raise ValueError(
                        f"script: host script produced {len(outs)} "
                        f"outputs, negotiated {len(self._out_spec)}")
                for i, (o, (shape, dt)) in enumerate(
                        zip(outs, self._out_spec)):
                    if tuple(o.shape) != shape or o.dtype != dt:
                        raise ValueError(
                            f"script: host output {i} is "
                            f"{tuple(o.shape)}:{o.dtype}, caps "
                            f"negotiated {shape}:{dt} — "
                            f"data-dependent output shapes are not "
                            f"streamable")
            return list(outs)
