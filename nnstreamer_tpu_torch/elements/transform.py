"""tensor_transform — elementwise ops on tensor streams.

Reference: ``gst/nnstreamer/elements/gsttensortransform.c`` with modes
``dimchg, typecast, arithmetic, transpose, stand, clamp``
(tensor_transform.h:57-84). The JAX package runs each mode as jnp math
that XLA fuses into the model; the port runs it on the package device:

- with ``acceleration=true`` (the default) the input moves to the package
  device first. There an ``arithmetic`` chain of the form
  ``typecast:float32``, up to 8 ``add/sub/mul/div`` scalars, and an
  optional trailing ``typecast:bfloat16|float16``, on an input of any
  numeric type, goes through the normalize kernel (``ops/preprocess.py``,
  kernel B1) and nothing else — the flagship's
  ``typecast:float32,add:-127.5,div:127.5`` is one launch per frame;
- every other mode and chain is a different function and runs as torch
  ops, as the JAX transform runs them as jnp ops;
- with ``acceleration=false`` the same torch ops run on the host.

With ``acceleration=true`` the transform offers a fused-region stage
(``pipeline/fuse.py``): the same per-tensor function, so inside a region
on the card kernel B1 runs in the captured graph.

Option grammars follow the reference:
  mode=typecast   option=float32
  mode=arithmetic option=typecast:float32,add:-127.5,div:127.5
  mode=transpose  option=1:0:2:3          (dim-index permutation)
  mode=dimchg     option=0:2              (move dim position 0 → 2)
  mode=stand      option=default[:per-channel] | dc-average[:per-channel]
  mode=clamp      option=min:max
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from nnstreamer_tpu_torch.device import resolve_device
from nnstreamer_tpu_torch.ops.preprocess import (
    CHAIN_MAX,
    IN_CODES,
    normalize_chain,
)
from nnstreamer_tpu_torch.pipeline.element import Element
from nnstreamer_tpu_torch.registry import ELEMENT, subplugin
from nnstreamer_tpu_torch.tensors.buffer import as_torch, host_array
from nnstreamer_tpu_torch.tensors.types import (
    TensorInfo,
    TensorsConfig,
    TensorsInfo,
    TensorType,
)

_KERNEL_TRAILING = ("bfloat16", "float16")


def _parse_arith(option: str) -> List[Tuple[str, Optional[float],
                                            Optional[str]]]:
    """Parse the arithmetic op chain: [(op, value|None, dtype|None), ...]."""
    ops = []
    for part in option.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ValueError(f"arithmetic option item needs ':': {part!r}")
        op, val = part.split(":", 1)
        op = op.strip().lower()
        if op == "typecast":
            ops.append((op, None, val.strip()))
        elif op in ("add", "sub", "mul", "div"):
            ops.append((op, float(val), None))
        else:
            raise ValueError(f"unknown arithmetic op {op!r}")
    return ops


def kernel_chain(mode: str, option: str
                 ) -> Optional[Tuple[List[Tuple[str, float]], torch.dtype]]:
    """The ``(ops, out_dtype)`` the normalize kernel computes for this
    transform, or None when the transform is not such a chain."""
    if mode != "arithmetic":
        return None
    parsed = _parse_arith(option)
    if not parsed or parsed[0] != ("typecast", None, "float32"):
        return None
    body = parsed[1:]
    out = torch.float32
    if body and body[-1][0] == "typecast" and \
            body[-1][2] in _KERNEL_TRAILING:
        out = getattr(torch, body[-1][2])
        body = body[:-1]
    if len(body) > CHAIN_MAX or any(op == "typecast" for op, _, _ in body):
        return None
    return [(op, val) for op, val, _ in body], out


class _TransformSpec:
    """Parsed (mode, option) → function on one torch tensor."""

    def __init__(self, mode: str, option: str):
        self.mode = mode
        self.option = option
        self.chain = kernel_chain(mode, option)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """The mode as torch ops (any device, including ``meta``)."""
        mode, option = self.mode, self.option
        if mode == "typecast":
            return x.to(TensorType.from_any(option).torch_dtype)
        if mode == "arithmetic":
            for op, val, dtype in _parse_arith(option):
                if op == "typecast":
                    x = x.to(TensorType.from_any(dtype).torch_dtype)
                elif op == "add":
                    x = x + val
                elif op == "sub":
                    x = x - val
                elif op == "mul":
                    x = x * val
                elif op == "div":
                    x = x / val
            return x
        if mode == "transpose":
            # option indexes dims (innermost-first); torch axes are reversed
            perm_dim = [int(p) for p in option.split(":")]
            rank = x.ndim
            perm_dim = perm_dim[:rank] + list(range(len(perm_dim), rank))
            axes = [rank - 1 - p for p in reversed(perm_dim)]
            return x.permute(axes).contiguous()
        if mode == "dimchg":
            frm, to = (int(p) for p in option.split(":"))
            rank = x.ndim
            return torch.movedim(x, rank - 1 - frm, rank - 1 - to
                                 ).contiguous()
        if mode == "stand":
            parts = option.split(":")
            kind = parts[0] or "default"
            per_ch = len(parts) > 1 and parts[1] == "per-channel"
            # channel = innermost dim == last torch axis
            dims = tuple(range(x.ndim - 1)) if per_ch else None
            xf = x.to(torch.float32)
            mean = xf.mean(dim=dims, keepdim=per_ch) if per_ch else xf.mean()
            if kind == "default":
                std = xf.std(dim=dims, keepdim=True, correction=0) \
                    if per_ch else xf.std(correction=0)
                return (xf - mean) / (std + 1e-10)
            if kind == "dc-average":
                return xf - mean
            raise ValueError(f"unknown stand option {kind!r}")
        if mode == "clamp":
            lo, hi = (float(p) for p in option.split(":"))
            if x.dtype.is_floating_point:
                return torch.clamp(x, lo, hi)
            # typed clamp: bounds saturate into the tensor's own dtype so
            # the output dtype is preserved
            info = torch.iinfo(x.dtype)
            lo_i = info.min if lo <= info.min else min(int(lo), info.max)
            hi_i = info.max if hi >= info.max else max(int(hi), info.min)
            return torch.clamp(x, lo_i, hi_i)
        raise ValueError(f"unknown transform mode {mode!r}")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.chain is not None and x.dtype in IN_CODES:
            ops, out_dtype = self.chain
            return normalize_chain(x.contiguous(), ops, out_dtype)
        return self.apply(x)

    def out_info(self, info: TensorInfo) -> TensorInfo:
        """Static shape/type inference for caps negotiation, on the meta
        device (no data, no kernels)."""
        shaped = self.apply(torch.empty(info.shape,
                                        dtype=info.type.torch_dtype,
                                        device="meta"))
        return TensorInfo(dim=tuple(reversed(tuple(shaped.shape))),
                          type=TensorType.from_any(shaped.dtype))


@subplugin(ELEMENT, "tensor_transform")
class TensorTransform(Element):
    ELEMENT_NAME = "tensor_transform"
    DEVICE_PASSTHROUGH = True  # device inputs stay on the device
    PROPERTIES = {
        **Element.PROPERTIES,
        "mode": None,
        "option": "",
        "acceleration": True,
        "apply": None,  # comma list of tensor indices; default all
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        self._spec: Optional[_TransformSpec] = None
        self._device: Optional[torch.device] = None

    def start(self):
        super().start()
        if self.get_property("acceleration"):
            self._device = resolve_device()

    def _get_spec(self) -> _TransformSpec:
        mode = self.get_property("mode")
        if mode is None:
            raise ValueError("tensor_transform: mode not set")
        if self._spec is None or (self._spec.mode, self._spec.option) != (
            mode, self.get_property("option")
        ):
            self._spec = _TransformSpec(mode, self.get_property("option"))
        return self._spec

    def _apply_indices(self, n: int) -> List[int]:
        sel = self.get_property("apply")
        if not sel:
            return list(range(n))
        return [int(i) for i in str(sel).split(",")]

    def transform_caps(self, pad, caps):
        try:
            cfg = TensorsConfig.from_caps(caps)
        except ValueError:
            return caps
        if not cfg.info.is_valid():
            return caps
        spec = self._get_spec()
        idx = set(self._apply_indices(len(cfg.info)))
        new_infos = [
            spec.out_info(info) if i in idx else info
            for i, info in enumerate(cfg.info)
        ]
        out = TensorsConfig(info=TensorsInfo(new_infos), format=cfg.format,
                            rate=cfg.rate)
        return out.to_caps()

    def _one(self, spec: _TransformSpec, t):
        if not self.get_property("acceleration"):  # host torch ops
            return host_array(spec.apply(as_torch(t, torch.device("cpu"))))
        if self._device is None:
            self._device = resolve_device()
        return spec(as_torch(t, self._device, non_blocking=True))

    def chain(self, pad, buf):
        spec = self._get_spec()
        idx = set(self._apply_indices(buf.num_tensors))
        out = [self._one(spec, t) if i in idx else t
               for i, t in enumerate(buf.tensors)]
        return self.srcpad.push(buf.with_tensors(out))

    # -- region fusion (pipeline/fuse.py) ------------------------------------
    def device_stage(self):
        """Every mode is elementwise or layout math on the device: fusible
        whenever acceleration is on."""
        if not self.get_property("acceleration"):
            return None
        from nnstreamer_tpu_torch.pipeline.fuse import DeviceStage

        if self._device is None:
            self._device = resolve_device()
        spec = self._get_spec()

        def fn(consts, tensors):
            sel = set(self._apply_indices(len(tensors)))
            return [self._one(spec, t) if i in sel else t
                    for i, t in enumerate(tensors)]

        key = ("tensor_transform", spec.mode, spec.option,
               str(self.get_property("apply") or ""))
        return DeviceStage(consts=None, fn=fn, key=key, device=self._device)
