"""The PyTorch filter backend — the port's inference path on the card.

The counterpart of the JAX package's ``filters/jax_backend.py``: it
implements the FilterFramework vtable with an ``nn.Module`` on the
package device. It registers as ``framework=torch`` and also answers to
``framework=jax``, so launch strings written for the JAX package run
unchanged.

- **Weights live on the device once.** ``open()`` moves the module to its
  device; every invoke reuses it.
- **Under an HBM budget** (``tensors/memory.py``) the weights are an
  evictable residency unit, one a backend (filters that share a
  ``shared-tensor-filter-key`` share the backend): the backend serves a
  private copy of the module whose parameters and buffers are loaded from
  a host copy of the state dict and, when evicted, swapped for meta
  tensors so their device storage is freed. Every dispatch holds the unit
  (``ResidencyManager.hold``): an evicted model loads back on its next
  frame, and a fused region that sees the load count change drops its
  CUDA graphs, which read the old storage, and captures again.
- **Weights-only swaps** (:meth:`TorchFilter.install_weights`, for
  ``Pipeline.swap_model``) copy the new values into the existing
  parameters when shapes and dtypes match, so a region's graphs replay
  the new weights with no capture. The weights swapped are the filter's
  own: an ``is-updatable=true`` filter serves a copy of the registered
  module from ``open()``; any other filter copies the module at its first
  swap (new storage: its region captures once).
- **Device tensors in, device tensors out.** Inputs move to the module's
  device (a no-op for tensors already there); outputs stay there, computed
  under ``torch.inference_mode()``. CUDA launches are asynchronous, so
  ``invoke()`` returns before the card finishes.
- **Shapes are probed on the meta device**: no data, no kernels.
- ``accelerator=true:cpu`` (or ``false``) runs the same code on the CPU.
- **Serving mesh** (``mesh=dp4``, ``parallel/serve.py``; ``NNSTPU_MESH=0``
  ignores it): the module is replicated on every mesh device (one served
  copy each; under an HBM budget one residency unit per shard, loaded,
  evicted and retired as a group) and each invoke places its batch over
  ``dp`` with ``serve.place_batch`` (a matched sharded input moves no
  byte) and runs each device's shard on its copy. The outputs are
  ``parallel.mesh.ShardedTensor``s. ``custom=sharding:<axis>`` shards the
  batch over a one-axis mesh of every device the same way (not fusible).
- **Fusible.** :meth:`TorchFilter.device_stage` hands the module to a
  fused region (``pipeline/fuse.py``), which on the card replays it inside
  one CUDA graph with the elements around it.

Model forms accepted (``model`` property): a name registered with
:func:`register_torch_model`; a ``<file>.py`` whose ``get_model()``
returns an ``nn.Module`` or a callable on tensors, or ``(callable,
params)``; a ``<file>.msgpack`` of the JAX package's flax weights with
``custom=module:<factory>`` naming a model of ``models.FACTORIES`` (the
factory's arguments follow the file's shapes); a ``.pt``/``.pth`` file
holding TorchScript or a pickled ``nn.Module`` (reference
``tensor_filter_pytorch.cc``); or a ``.pt2`` ``torch.export`` artifact
(``filters/artifact.py``), loaded onto the chosen device. Under a
``mesh=`` plan a ``.pt2`` serves each device's shard when its batch is
dynamic (``--export`` marks it so); a static batch that the plan would
split raises at ``open()`` (ROADMAP C.58). A frozen ``.pb`` GraphDef or
a SavedModel directory goes to the TensorFlow backend
(``filters/tf_backend.py``), which runs it on the host, as the JAX
backend sends them to its TF staging. The JAX package's StableHLO
artifacts raise naming ROADMAP C.24.
"""

from __future__ import annotations

import contextlib
import copy
import importlib.util
import os
import sys
import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence

import torch

from nnstreamer_tpu_torch.config import FOREIGN_MODEL_EXTS
from nnstreamer_tpu_torch.device import resolve_device
from nnstreamer_tpu_torch.filters.api import FilterFramework, FilterProperties
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.filters.tf_backend import TensorFlowFilter, is_tf_model
from nnstreamer_tpu_torch.registry import FILTER, register_subplugin, subplugin
from nnstreamer_tpu_torch.tensors import memory as _memory
from nnstreamer_tpu_torch.tensors.buffer import as_torch
from nnstreamer_tpu_torch.tensors.types import TensorInfo, TensorsInfo, TensorType

log = get_logger("torch-backend")

_registered: Dict[str, dict] = {}
_reg_lock = threading.Lock()


def register_torch_model(name: str, module: torch.nn.Module,
                         in_info: Optional[TensorsInfo] = None,
                         out_info: Optional[TensorsInfo] = None) -> None:
    """Register ``module`` under ``name`` for ``tensor_filter model=name``.
    Shapes may be left None: they are then derived from the negotiated
    input caps on the meta device."""
    with _reg_lock:
        _registered[name] = dict(module=module, in_info=in_info,
                                 out_info=out_info)


def unregister_torch_model(name: str) -> bool:
    with _reg_lock:
        return _registered.pop(name, None) is not None


def _as_info(info) -> Optional[TensorsInfo]:
    """A model file's ``IN_INFO``/``OUT_INFO``: the port's TensorsInfo, or
    any object with the caps strings (``dims_str()``/``types_str()``)."""
    if info is None or isinstance(info, TensorsInfo):
        return info
    return TensorsInfo.from_str(info.dims_str(), info.types_str())


class PythonModel(torch.nn.Module):
    """A ``get_model()`` callable as a module, so it fuses, swaps and
    exports as any module: ``fn(*inputs)``, or ``fn(params, *inputs)``
    where each tensor (or numpy array) leaf of ``params`` is a buffer."""

    def __init__(self, fn, params: Any = None):
        super().__init__()
        self.fn = fn
        self._with_params = params is not None
        self._spec = None
        self._consts: List[Any] = []
        if self._with_params:
            import numpy as np
            from torch.utils import _pytree

            leaves, self._spec = _pytree.tree_flatten(params)
            for i, leaf in enumerate(leaves):
                if isinstance(leaf, (torch.Tensor, np.ndarray)):
                    self.register_buffer(f"p{i}", torch.as_tensor(leaf))
                    leaf = None
                self._consts.append(leaf)

    def forward(self, *xs):
        if not self._with_params:
            return self.fn(*xs)
        from torch.utils import _pytree

        leaves = [getattr(self, f"p{i}") if c is None else c
                  for i, c in enumerate(self._consts)]
        return self.fn(_pytree.tree_unflatten(leaves, self._spec), *xs)


def _load_py_model(path: str) -> dict:
    """``<file>.py`` with ``get_model()`` (``jax_backend._load_py_model``):
    an ``nn.Module`` as it is, a plain callable wrapped in
    :class:`PythonModel`; module-level ``IN_INFO``/``OUT_INFO``."""
    spec = importlib.util.spec_from_file_location(
        f"nnstreamer_tpu_torch_model_"
        f"{os.path.basename(path).replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    if not hasattr(mod, "get_model"):
        raise ValueError(f"torch: model file {path!r} must define "
                         "get_model()")
    got = mod.get_model()
    fn, params = got if isinstance(got, tuple) else (got, None)
    module = fn if isinstance(fn, torch.nn.Module) and params is None \
        else PythonModel(fn, params)
    return dict(module=module, in_info=_as_info(getattr(mod, "IN_INFO", None)),
                out_info=_as_info(getattr(mod, "OUT_INFO", None)))


def _custom_option(custom: Optional[str], key: str) -> Optional[str]:
    """The value of ``key:<value>`` in a comma-separated ``custom``."""
    value = None
    for part in (custom or "").split(","):
        if part.startswith(f"{key}:"):
            value = part.split(":", 1)[1]
    return value


def _load_msgpack_model(path: str, custom: Optional[str]) -> dict:
    """The JAX package's flax ``.msgpack`` weights with
    ``custom=module:<factory>`` (``jax_backend._load_msgpack_model``):
    the zoo model built at the file's shapes, loaded with its values."""
    from nnstreamer_tpu_torch.models import from_jax
    from nnstreamer_tpu_torch.utils.flax_msgpack import from_bytes

    name = _custom_option(custom, "module")
    if name is None:
        raise ValueError(
            "torch: .msgpack model needs custom=module:<models factory> "
            "(e.g. custom=module:mobilenet_v2)")
    with open(path, "rb") as f:
        variables = from_bytes(f.read())
    module, in_info, out_info = from_jax(name, variables)
    return dict(module=module, in_info=in_info, out_info=out_info)


def resolve_python_model(model: str, custom: Optional[str]
                         ) -> Optional[dict]:
    """The Python-authored model forms (a registered name, ``.py`` with
    ``get_model()``, ``.msgpack`` with a zoo factory) as a backend entry,
    or None when ``model`` is none of them. The filter and the exporter
    (``filters/artifact.export_model``) share it, so ``--export`` takes
    what the filter loads."""
    name = model.split(":", 1)[1] if model.startswith("registered:") \
        else model
    with _reg_lock:
        if name in _registered:
            return dict(_registered[name])
    if model.endswith(".py") and os.path.isfile(model):
        return _load_py_model(model)
    if model.endswith(".msgpack") and os.path.isfile(model):
        return _load_msgpack_model(model, custom)
    return None


def _load_file(path: str, device: torch.device) -> dict:
    """A backend entry (module, in_info, out_info) for a model file."""
    ext = os.path.splitext(path)[1].lower()
    if ext in FOREIGN_MODEL_EXTS:
        raise ValueError(
            f"torch: {path!r} is a StableHLO artifact of the JAX package, "
            "which the port does not run (ROADMAP.md C.24); export the "
            "model to a .pt2 file")
    if ext == ".pt2":
        from nnstreamer_tpu_torch.filters.artifact import artifact_entry

        return artifact_entry(path, device)
    if not os.path.isfile(path):
        raise ValueError(f"torch: cannot load model {path!r} (not "
                         "registered, not a .py/.msgpack/.pt/.pth/.pt2 "
                         "file)")
    return dict(module=_load_module(path, device), in_info=None,
                out_info=None)


def _load_module(path: str, device: torch.device) -> torch.nn.Module:
    try:
        return torch.jit.load(path, map_location=device)
    except (RuntimeError, ValueError):  # not TorchScript
        loaded = torch.load(path, map_location=device, weights_only=False)
    if not isinstance(loaded, torch.nn.Module):
        raise ValueError(
            f"torch: {path!r} is neither TorchScript nor an nn.Module")
    return loaded


#: output shapes probed on a meta twin, per module: {(input shapes and
#: types, the module's weight shapes and types): output info}. The probe
#: is a pure function of those, and a meta forward of a whole model costs
#: every pipeline that names the module its start-up time.
_probed: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_probed_lock = threading.Lock()


def _meta_twin(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``module`` whose parameters and buffers are meta tensors of
    the same shapes and dtypes: shapes probe on it without data, and
    without touching ``module``, which other threads may be running (a
    registered module serves every pipeline that names it)."""
    memo = {}
    for p in module.parameters():
        memo[id(p)] = torch.nn.Parameter(torch.empty_like(p, device="meta"),
                                         requires_grad=p.requires_grad)
    for b in module.buffers():
        memo[id(b)] = torch.empty_like(b, device="meta")
    return copy.deepcopy(module, memo)


def _eval(module: torch.nn.Module) -> torch.nn.Module:
    """``module`` in inference mode; an exported program's module (a
    ``.pt2``) is traced in that mode already and refuses ``eval()``."""
    if isinstance(module, torch.fx.GraphModule):
        return module
    return module.eval()


def _named_tensors(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of ``module`` by name (a tied tensor
    once): what a graph over the module reads."""
    out = dict(module.named_parameters())
    out.update(module.named_buffers())
    return out


def _rebind(module: torch.nn.Module, tensors: Dict[str, torch.Tensor]
            ) -> None:
    """Point each named parameter and buffer of ``module`` at the tensor
    of the same name (a ``.data`` swap: the objects the module and its
    graphs hold stay the same)."""
    with torch.no_grad():
        for name, t in _named_tensors(module).items():
            t.data = tensors[name]


def _check_shards(ep, sharding, model: str) -> None:
    """ROADMAP C.58: a ``.pt2`` is traced at one batch. Under a mesh each
    device runs its shard of the rows (the batch over ``dp``, or the whole
    batch where it does not split), so the program's batch dimension must
    admit the shard size: a dynamic batch whose range holds it, or a
    static batch equal to it. Anything else raises here, not as a guard
    failure inside the stream."""
    from nnstreamer_tpu_torch.filters.artifact import program_batches

    dp = getattr(sharding, "dp_size", sharding.num_devices)
    for i, (batch, low, high) in enumerate(program_batches(ep)):
        shard = batch // dp if batch % dp == 0 else batch
        if not low <= shard <= high:
            kind = "static" if low == high else f"dynamic [{low}, {high}]"
            raise ValueError(
                f"torch: {model!r} input {i} is exported at a {kind} batch "
                f"of {batch}, and the mesh gives each device a shard of "
                f"{shard} rows; export it with a dynamic batch "
                "(nns-launch-torch --export marks the batch dynamic) "
                "(ROADMAP C.58)")


class DispatchLock:
    """The lock between a backend's dispatches, which read its weights,
    and a swap or reload, which writes them. Re-entrant. A dispatch takes
    it with :meth:`dispatch`; a writer with ``with lock:``. A writer that
    waits goes ahead of the dispatches that come after it: a stream at
    full rate releases and takes a plain lock back frame after frame, and
    a swap could wait out the whole stream."""

    def __init__(self):
        self._lock = threading.RLock()
        self._mutex = threading.Lock()
        self._no_writer = threading.Event()
        self._no_writer.set()
        self._writers = 0
        self._owner: Optional[int] = None
        self._depth = 0

    def _acquire(self) -> None:
        self._lock.acquire()
        self._owner = threading.get_ident()
        self._depth += 1

    def _release(self) -> None:
        self._depth -= 1
        if not self._depth:
            self._owner = None
        self._lock.release()

    @contextlib.contextmanager
    def dispatch(self):
        if self._owner != threading.get_ident():
            # the owner's own nested dispatch must not wait for itself
            self._no_writer.wait()  # nns-lint: disable=NNS110 -- waits out one install_weights swap, a bounded in-place copy that always clears the flag
        self._acquire()
        try:
            yield
        finally:
            self._release()

    def _writer_done(self) -> None:
        with self._mutex:
            self._writers -= 1
            if not self._writers:
                self._no_writer.set()

    def __enter__(self) -> "DispatchLock":
        with self._mutex:
            self._writers += 1
            self._no_writer.clear()
        try:
            self._acquire()
        except BaseException:
            self._writer_done()
            raise
        return self

    def __exit__(self, *exc) -> None:
        self._release()
        self._writer_done()


@subplugin(FILTER, "torch")
class TorchFilter(FilterFramework):
    NAME = "torch"
    KEEP_ON_DEVICE = True

    def __init__(self):
        super().__init__()
        self._module: Optional[torch.nn.Module] = None
        self._device: Optional[torch.device] = None
        self._in_info: Optional[TensorsInfo] = None
        self._out_info: Optional[TensorsInfo] = None
        #: the weights' residency unit under an HBM budget, else None;
        #: under a mesh the primary of a per-shard group whose keys are
        #: ``_resident_keys``
        self._resident = None
        self._resident_keys: List[str] = []
        #: ``custom=sharding:<axis>`` (a BatchSharding) or the ``mesh=``
        #: plan (a MeshPlan, parallel/serve.py); None on one device
        self._sharding = None
        self._mesh_plan = None
        #: the served module on each mesh device (its first is
        #: ``_module``); None on one device
        self._replicas: Optional[List[torch.nn.Module]] = None
        #: the (possibly shared) module ``open()`` loaded, when it serves
        #: that object itself
        self._opened_from = None
        #: the TensorFlow backend a .pb or SavedModel model is served by
        self._tf: Optional[TensorFlowFilter] = None
        #: held by every dispatch that reads the weights (:meth:`_hold`)
        #: and by a swap or reload that writes them, so no frame reads a
        #: half-installed set; ``Pipeline.swap_model`` holds it across
        #: the install and the region's rebuild
        self.dispatch_lock = DispatchLock()

    # -- lifecycle -----------------------------------------------------------
    def open(self, props: FilterProperties) -> None:
        super().open(props)
        model = props.model
        # a TF model is served on the host by the TF backend (C.46)
        self.KEEP_ON_DEVICE = not is_tf_model(model)
        if not self.KEEP_ON_DEVICE:
            self._tf = TensorFlowFilter()
            self._tf.open(props)
            return
        self._device = resolve_device(props.accelerator)
        if not model:
            raise ValueError("torch: model not set")
        self._open_sharding(props)
        entry = resolve_python_model(model, props.custom)
        if entry is None:
            entry = _load_file(model, self._device)
        exported = entry.get("exported")  # a .pt2's program, else None
        if self._sharding is not None and exported is not None:
            _check_shards(exported, self._sharding, model)
        acct = _memory.ACTIVE
        self._opened_from = None
        if acct is not None and not isinstance(entry["module"],
                                                torch.jit.ScriptModule):
            self._module = self._register_resident(  # nns-lint: disable=NNS201 -- open() runs before start() or inside reload() under the dispatch lock: no dispatch reads the module meanwhile
                acct, entry["module"], f"torch:{id(self)}", str(model),
                exported=exported)
        else:
            self._module = self._opened_from = _eval(  # nns-lint: disable=NNS201 -- open() runs before start() or inside reload() under the dispatch lock: no dispatch reads the module meanwhile
                entry["module"].to(self._device))
            if props.is_updatable:
                # swaps write into the weights this filter serves: an
                # updatable filter serves its own copy from the start,
                # so a swap reaches no other user of the module and the
                # graphs captured over the copy stay valid
                self._module = copy.deepcopy(self._module)  # nns-lint: disable=NNS201 -- open() runs before start() or inside reload() under the dispatch lock: no dispatch reads the module meanwhile
            if self._sharding is not None:
                self._replicas = self._replicate(self._module, exported)  # nns-lint: disable=NNS201 -- open() runs before start() or inside reload() under the dispatch lock: no dispatch reads the module meanwhile
        self._in_info = props.input_info or entry["in_info"]
        self._out_info = props.output_info or entry["out_info"]

    # -- the serving mesh (parallel/) -----------------------------------------
    def _open_sharding(self, props: FilterProperties) -> None:
        """``custom=sharding:<axis>`` and the ``mesh=`` plan (the kill
        switch ``NNSTPU_MESH=0`` ignores the property). Under either, the
        backend computes on the mesh's devices; its first is the
        controller's."""
        from nnstreamer_tpu_torch.parallel import serve as _serve

        self._sharding = self._mesh_plan = None
        self._replicas = None  # nns-lint: disable=NNS201 -- called from open() only, before start() or inside reload() under the dispatch lock
        for part in (props.custom or "").split(","):
            if part.startswith("sharding:"):
                from nnstreamer_tpu_torch.parallel.mesh import batch_sharding

                self._sharding = batch_sharding(part.split(":", 1)[1])
        if props.mesh:
            if _serve.mesh_enabled():
                self._mesh_plan = _serve.get_mesh_plan(props.mesh)
                self._sharding = self._mesh_plan
            else:
                log.info("mesh=%s requested but NNSTPU_MESH=0: "
                         "single-device path", props.mesh)
        if self._sharding is not None:
            self._device = self._mesh_devices()[0]

    def _mesh_devices(self) -> List[torch.device]:
        return [d.device for d in self._sharding.mesh.device_list()]

    def _replicate(self, module: torch.nn.Module, exported=None
                   ) -> List[torch.nn.Module]:
        """One served copy of ``module`` on each mesh device: the first
        is ``module`` (on the first device already), the others copies
        of their own. For a ``.pt2`` the copies come from ``exported``,
        the program ``module`` was made from, moved whole to each device
        with the devices its graph burnt in, as ``artifact_entry`` moves
        it (the pass moves ``exported`` itself, device by device)."""
        if exported is not None:
            from torch.export.passes import move_to_device_pass

            return [module] + [_eval(move_to_device_pass(exported, dev)  # nns-lint: disable=NNS113 -- replicated weights: each mesh device holds a copy, as the JAX backend's replicated placement
                                     .module())
                               for dev in self._mesh_devices()[1:]]
        return [module] + [copy.deepcopy(module).to(dev)  # nns-lint: disable=NNS113 -- replicated weights: each mesh device holds a copy, as the JAX backend's replicated placement
                           for dev in self._mesh_devices()[1:]]

    # -- HBM residency (tensors/memory.py) -----------------------------------
    def _register_resident(self, acct, module: torch.nn.Module, key: str,
                           label: str, state: Optional[dict] = None,
                           exported=None) -> torch.nn.Module:
        """Make the weights an evictable residency unit and return the
        private module the backend serves: a twin of ``module`` whose
        tensors the unit's loader points at device copies of the host
        staging (``state``, default ``module``'s own tensors) and whose
        eviction points at empty tensors, freeing the storage. The unit
        loads now, under the budget.

        Under a mesh: ONE UNIT PER SHARD in a load/evict group — the
        replicated placement puts a full copy on every device, so each
        unit carries the full weight bytes and ``nns_mem_used_bytes``
        sums to the real footprint; one load fills every device's twin
        (``_replicas``), and ``_resident_keys`` lists every key so a swap
        or ``close()`` retires the whole group. The twins of a ``.pt2``
        (``exported``, its program) come from the program moved to each
        device (:meth:`_replicate`): its graph burns in the device it was
        moved to, which a copy of the first device's would keep."""
        devices = self._mesh_devices() if self._sharding is not None \
            else [self._device]

        def empty(t, dev):
            return torch.empty(0, dtype=t.dtype, device=dev)

        if state is None:
            bases = (self._replicate(module, exported)
                     if exported is not None and self._sharding is not None
                     else [module] * len(devices))
            served = []
            for base, dev in zip(bases, devices):
                m = _eval(_meta_twin(base))
                m._apply(lambda t, _d=dev: empty(t, _d))  # holding nothing yet
                served.append(m)
        else:
            served = self._replicas or [self._module]
        src = state if state is not None else _named_tensors(module)
        host = {n: t.detach().to("cpu", copy=True) for n, t in src.items()}

        def load(staged, _ms=served):
            for m, dev in zip(_ms, devices):
                _rebind(m, {n: t.to(dev) for n, t in staged.items()})
            return _ms

        def evict(_ms=served):
            if self._resident is not None and \
                    key not in (self._resident.key, self._resident.group):
                return  # a retired epoch's unit: the module is the new one's
            for m, dev in zip(_ms, devices):
                _rebind(m, {n: empty(t, dev)
                            for n, t in _named_tensors(m).items()})

        nbytes = _memory.nbytes_of(host)
        if self._mesh_plan is None:
            self._resident = acct.residency.register(
                key=key, host_value=host, nbytes=nbytes, loader=load,
                label=label, on_evict=evict)
            self._resident_keys = [key]
        else:
            units = [acct.residency.register(
                key=f"{key}:shard{k}", host_value=host, nbytes=nbytes,
                loader=load, label=f"{label}#shard{k}", group=key,
                on_evict=evict if k == 0 else None)
                for k in range(len(devices))]
            self._resident = units[0]
            self._resident_keys = [u.key for u in units]
        self._resident.value()
        if self._sharding is not None:
            self._replicas = served  # nns-lint: disable=NNS201 -- from open() (before start, or reload under the dispatch lock) or install_weights (under the dispatch lock)
        return served[0]

    @contextlib.contextmanager
    def _hold(self):
        """The weights, resident and unchanged for one dispatch (a swap
        waits for the dispatch lock); yields the unit's load count (0 with
        no budget)."""
        with self.dispatch_lock.dispatch():
            unit = self._resident
            acct = _memory.ACTIVE
            if unit is None or acct is None:
                yield 0
                return
            with acct.residency.hold(unit) as loads:
                yield loads

    def install_weights(self, state_dict: Dict[str, Any], epoch: int = 0
                        ) -> Dict[str, Any]:
        """Weights-only swap for ``Pipeline.swap_model``: the model is
        unchanged, so a fused region's stage key is too. The caller has
        drained the dispatch window (the cutover fence). The install runs
        under the dispatch lock, so no dispatch reads a half-installed
        set, and on the card it ends with the stream synchronised, so the
        next replay, on whatever stream, reads the new set whole. Each
        tensor whose shape and dtype match is copied into the existing
        parameter on the current stream (``copy_`` under ``no_grad``), so
        captured graphs replay the new weights; a tensor that changes
        shape or dtype is rebound, and the region's storage pin then
        captures anew, once.

        Under an HBM budget the new weights register as a NEW residency
        unit keyed by the swap epoch and the old epoch's unit retires
        first, so ``used_bytes`` nets out."""
        with self.dispatch_lock:
            out = self._install_weights(state_dict, epoch)
            if self._device is not None and self._device.type == "cuda":
                torch.cuda.current_stream(self._device).synchronize()
        return out

    def _install_weights(self, state_dict: Dict[str, Any], epoch: int
                         ) -> Dict[str, Any]:
        if self._module is None:
            raise RuntimeError("torch: install_weights before open()")
        current = _named_tensors(self._module)
        new = {k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(v))
               for k, v in state_dict.items()}
        missing = sorted(set(current) - set(new))
        extra = sorted(set(new) - set(current))
        if missing or extra:
            raise ValueError(f"torch: install_weights: state dict does not "
                             f"match the model (missing {missing[:4]}, "
                             f"unexpected {extra[:4]})")
        out: Dict[str, Any] = {"residency": None, "retired": None,
                               "rebound": 0}
        if self._resident is None and not self.props.is_updatable and \
                self._module is self._opened_from:
            # the module is the registered one, which other filters may
            # serve: swap a copy (new storage, so the region captures once)
            self._module = copy.deepcopy(self._module)
            if self._replicas:
                self._replicas[0] = self._module
        acct = _memory.ACTIVE
        if self._resident is not None and acct is not None:
            old = self._resident
            # retire the WHOLE previous epoch — under a mesh one unit per
            # shard; one left behind would leak a full weight copy
            for k in self._resident_keys or [old.key]:
                acct.residency.unregister(k)
            out["retired"] = old.group or old.key
            new_key = f"torch:{id(self)}:e{int(epoch)}"
            self._register_resident(acct, None, new_key,
                                    f"{self.props.model}@e{int(epoch)}",
                                    state=new)
            out["residency"] = new_key
            return out
        modules = self._replicas or [self._module]
        with torch.no_grad():
            for m in modules:
                for name, t in _named_tensors(m).items():
                    v = new[name]
                    if v.shape == t.shape and v.dtype == t.dtype:
                        t.copy_(v.to(t.device, non_blocking=True))
                    else:
                        t.data = v.to(t.device)
                        out["rebound"] += 1
        return out

    def reload(self) -> None:
        with self.dispatch_lock:  # no dispatch meets a half-reopened model
            super().reload()

    def close(self) -> None:
        if self._tf is not None:
            self._tf.close()
            self._tf = None
        if self._resident is not None:
            acct = _memory.ACTIVE
            if acct is not None:
                for k in self._resident_keys or [self._resident.key]:
                    acct.residency.unregister(k)
            self._resident = None
            self._resident_keys = []
        self._module = None
        self._replicas = None
        super().close()

    # -- model info ----------------------------------------------------------
    def get_model_info(self):
        if self._tf is not None:
            return self._tf.get_model_info()
        return self._in_info, self._out_info

    def set_input_info(self, in_info: TensorsInfo) -> TensorsInfo:
        """Derive output shapes on the meta device (no data, no kernels);
        a TorchScript module, which cannot run on meta tensors, is probed
        with one zero forward pass on its device."""
        self._in_info = in_info
        with self._hold():  # an evicted module's tensors hold nothing
            return self._set_input_info(in_info)

    def _set_input_info(self, in_info: TensorsInfo) -> TensorsInfo:
        if isinstance(self._module, torch.jit.ScriptModule):
            dev = self._device
        else:
            dev = torch.device("meta")
        ins = [torch.zeros(i.shape, dtype=i.type.torch_dtype, device=dev)
               for i in in_info]
        key = None
        if dev.type == "meta":
            key = (tuple((tuple(i.shape), i.dtype) for i in ins),
                   tuple((k, tuple(v.shape), v.dtype) for k, v in
                         self._module.state_dict(keep_vars=True).items()))
            with _probed_lock:
                known = _probed.get(self._module, {}).get(key)
            if known is not None:
                self._out_info = known
                return known
        with torch.inference_mode():
            if dev.type == "meta":
                out = _meta_twin(self._module)(*ins)
            else:
                out = self._module(*ins)
        outs = [out] if isinstance(out, torch.Tensor) else list(out)
        self._out_info = TensorsInfo([
            TensorInfo(dim=tuple(reversed(tuple(o.shape))),
                       type=TensorType.from_any(o.dtype))
            for o in outs
        ])
        if key is not None:
            with _probed_lock:
                _probed.setdefault(self._module, {})[key] = self._out_info
        return self._out_info

    # -- region fusion (pipeline/fuse.py) ------------------------------------
    def device_stage(self):
        """The module as a fused-region stage: its consts are the module
        (the weights live in it), its key names the module object, and it
        computes on the backend's device. It waits for a swap or reload in
        progress (the dispatch lock), so a region never builds over a
        half-installed model."""
        with self.dispatch_lock.dispatch():
            return self._device_stage()

    def _device_stage(self):
        """Not fusible under ``custom=sharding:`` (the region would drop
        that placement). A ``mesh=`` plan IS fusible: the stage's consts
        are the per-device copies and it carries the mesh spec; the region
        runs each device's shard (``pipeline/fuse.py``)."""
        if self._module is None:  # not open, or a TF model on the host
            return None
        if self._sharding is not None and self._mesh_plan is None:
            return None
        from nnstreamer_tpu_torch.pipeline.fuse import DeviceStage

        device = self._device
        # under a mesh each device's copy computes on its device
        devices = {} if self._replicas is None else {
            id(m): d for m, d in zip(self._replicas, self._mesh_devices())}

        def fn(module, tensors):
            dev = devices.get(id(module), device)
            xs = [as_torch(x, dev, non_blocking=True) for x in tensors]
            with torch.inference_mode():
                out = module(*xs)
            return [out] if isinstance(out, torch.Tensor) else list(out)

        if self._mesh_plan is not None:
            return DeviceStage(consts=list(self._replicas), fn=fn,
                               key=("torch", tuple(self._replicas)),
                               hold=self._hold, mesh=self._mesh_plan.spec)
        return DeviceStage(consts=self._module, fn=fn,
                           key=("torch", self._module), device=self._device,
                           hold=self._hold)

    # -- hot path ------------------------------------------------------------
    def invoke(self, inputs: Sequence[Any]) -> List[Any]:
        if self._tf is not None:
            return self._tf.invoke(inputs)
        if self._sharding is not None:
            return self._invoke_sharded(inputs)
        xs = [as_torch(x, self._device, non_blocking=True) for x in inputs]
        with self._hold(), self.global_stats().measure(), \
                torch.inference_mode():
            out = self._module(*xs)
        return [out] if isinstance(out, torch.Tensor) else list(out)

    def _invoke_sharded(self, inputs: Sequence[Any]) -> List[Any]:
        """The batch placed over the mesh (``serve.place_batch`` for a
        ``mesh=`` plan: matched sharded inputs move no byte), each
        device's shard through its copy of the module; sharded outputs
        for a ``mesh=`` plan (the filter element gathers them unless they
        hand off), gathered ones under ``custom=sharding:``."""
        from nnstreamer_tpu_torch.parallel import serve as _serve

        plan = self._sharding
        if self._mesh_plan is not None:
            xs = [_serve.place_batch(x, plan) for x in inputs]
        else:
            xs = [_serve.place_on(x, plan, count=False) for x in inputs]
        per_device = []
        with self._hold(), self.global_stats().measure(), \
                torch.inference_mode():
            for i, module in enumerate(self._replicas):
                out = module(*(x.shards[i] for x in xs))
                per_device.append([out] if isinstance(out, torch.Tensor)
                                  else list(out))
        outs = _serve.shard_outputs(per_device, xs, plan.mesh)
        if self._mesh_plan is None:
            # custom=sharding: has no hand-off contract: gathered here
            outs = [_serve.gather(x) for x in outs]
        return outs


# reference launch strings name framework=jax
register_subplugin(FILTER, "jax", TorchFilter)
