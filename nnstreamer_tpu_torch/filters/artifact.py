"""Compiled-model artifacts for the torch filter backend.

Port of ``nnstreamer_tpu/filters/artifact.py``: the reference's core use
case — "load an opaque model *file* and run it on the accelerator" — with
``torch.export`` ``.pt2`` files in place of ``jax.export``'s serialized
StableHLO. A ``.pt2`` holds the traced program and its weights, and
carries its input and output shapes and types, so ``tensor_filter
model=x.pt2`` needs no ``input``/``output`` properties.

- :func:`save_artifact` traces a module on example inputs (or zeros of
  ``in_info``), with the batch dimension dynamic where the inputs have
  one, so the program serves each device's shard under ``mesh=``
  (ROADMAP C.58; :func:`program_batches` reads the range back), and
  writes the ``.pt2``;
- :func:`load_artifact` reads it (``torch.export.load``);
- :func:`artifact_entry` is the backend's entry for a ``.pt2`` file: the
  exported program's module on the requested device, with its info;
- :func:`export_model` exports what the backend loads — a registered
  model, a ``.py`` with ``get_model()``, a ``.msgpack`` with
  ``custom=module:<factory>``, a ``.pt``/``.pth`` file — (the CLI's
  ``--export``).

A model whose forward reaches a hand-written kernel's wrapper (B1
``normalize_chain``, B2 ``flash_attention``, B3 ``quantize_int8``)
exports with the wrapper's op (``nnstpu::normalize_chain``,
``nnstpu::flash_attention``, ``nnstpu::quantize_int8``) in its graph, not
the plain version's ATen ops. Importing this module registers the three
ops (it imports ``ops``), so a ``.pt2`` that holds them loads in a fresh
process; on the card the loaded program launches the kernels, each
counted in ``ops/_counts.LAUNCHES``. Raw StableHLO and StableHLO portable
artifacts stay with the JAX package: the torch backend raises naming
ROADMAP C.24 for them.
"""

from __future__ import annotations

import sys
from typing import Any, List, Optional, Sequence, Tuple

import torch
from torch.fx.experimental.symbolic_shapes import ConstraintViolationError

# registers nnstpu::normalize_chain, ::flash_attention and ::quantize_int8
# before any torch.export.load (the kernels build at their first CUDA call)
from nnstreamer_tpu_torch.ops import flash_attention, preprocess, quantize  # noqa: F401
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.tensors.types import TensorInfo, TensorsInfo, TensorType

log = get_logger("artifact")


def _example_inputs(in_info: Optional[TensorsInfo],
                    example_inputs: Optional[Sequence[Any]]) -> tuple:
    if example_inputs is not None:
        return tuple(torch.as_tensor(x) for x in example_inputs)
    if in_info is None:
        raise ValueError("save_artifact: need in_info or example_inputs")
    return tuple(torch.zeros(i.shape, dtype=i.type.torch_dtype)
                 for i in in_info)


def _batch_dims(args: tuple):
    """``dynamic_shapes`` with dimension 0 of every input one shared
    ``Dim`` (at least 1 row), or None when the inputs have no common
    batch of 2 or more rows to trace it at."""
    batches = {a.shape[0] if a.dim() else None for a in args}
    if len(batches) != 1 or None in batches or batches.pop() < 2:
        return None
    batch = torch.export.Dim("batch", min=1)
    dims = torch.export.ShapesCollection()  # keyed by tensor: any forward
    for a in args:
        dims[a] = {0: batch}
    return dims


def save_artifact(path: str, module: torch.nn.Module,
                  in_info: Optional[TensorsInfo] = None,
                  example_inputs: Optional[Sequence[Any]] = None):
    """Trace ``module`` (on the CPU, in eval mode, with its weights) with
    ``torch.export`` and write the program to ``path``. Input specs come
    from ``in_info`` (caps dims, reversed order) or ``example_inputs``.
    Dimension 0 of the inputs, where they share one of 2 or more rows, is
    traced as a dynamic size of at least 1, so the program serves each
    device's shard under ``mesh=`` (ROADMAP C.58); a module whose code
    fixes its batch is traced static instead, with a warning. Returns the
    ``ExportedProgram``."""
    args = _example_inputs(in_info, example_inputs)
    module = module.eval()
    dims = _batch_dims(args)
    with torch.no_grad():
        ep = None
        if dims is not None:
            try:
                ep = torch.export.export(module, args, dynamic_shapes=dims)
            except (torch._dynamo.exc.UserError,
                    ConstraintViolationError) as e:
                log.warning("export: the model fixes its batch of %d, "
                            "exported static (it serves under no mesh "
                            "that splits it): %s", args[0].shape[0],
                            str(e).splitlines()[0])
        if ep is None:
            ep = torch.export.export(module, args)
    torch.export.save(ep, path)
    return ep


def load_artifact(path: str):
    """Read a ``.pt2`` written by :func:`save_artifact` (or any
    ``torch.export.save``) → ``ExportedProgram``."""
    try:
        return torch.export.load(path)
    except Exception as e:
        raise ValueError(
            f"cannot load model artifact {path!r}: torch.export.load "
            f"failed: {e}") from e


def _size(d) -> int:
    """A traced size: an int, or a dynamic size's traced value."""
    return d if isinstance(d, int) else int(d.node.hint)


def _info_of(vals) -> TensorsInfo:
    return TensorsInfo([
        TensorInfo(dim=tuple(reversed(tuple(_size(d) for d in v.shape))) or
                   (1,), type=TensorType.from_any(v.dtype))
        for v in vals
    ])


def _user_inputs(ep) -> list:
    nodes = {n.name: n for n in ep.graph.nodes}
    return [nodes[name].meta["val"] for name in ep.graph_signature.user_inputs]


def program_batches(ep) -> List[Tuple[int, int, int]]:
    """``(traced batch, least, most)`` of dimension 0 of each user input
    of rank 1 or more: a static size gives ``(n, n, n)``, a dynamic one
    its range (``most`` a large int for an open range)."""
    out = []
    for v in _user_inputs(ep):
        if not v.dim():
            continue
        d = v.shape[0]
        if isinstance(d, int):
            out.append((d, d, d))
            continue
        rng = ep.range_constraints[d.node.expr]
        high = int(rng.upper) if rng.upper.is_Integer else sys.maxsize
        out.append((_size(d), int(rng.lower), high))
    return out


def artifact_tensors_info(ep) -> Tuple[TensorsInfo, TensorsInfo]:
    """(in_info, out_info) caps from an ``ExportedProgram``'s user inputs
    and outputs (artifacts are self-describing)."""
    sig = ep.graph_signature
    ins = _user_inputs(ep)
    out_node = next(n for n in ep.graph.nodes if n.op == "output")
    outs_all = out_node.args[0]
    outs_all = outs_all if isinstance(outs_all, (list, tuple)) \
        else [outs_all]
    user_outs = set(sig.user_outputs)
    outs = [o.meta["val"] for o in outs_all
            if getattr(o, "name", None) in user_outs]
    return _info_of(ins), _info_of(outs)


def artifact_entry(path: str, device: torch.device) -> dict:
    """Backend entry (module/in_info/out_info) for a ``.pt2`` file: the
    exported program moved to ``device`` — its weights, its lifted
    constants and the devices its graph burnt in (a ``.to(dtype)`` asserts
    the device it was traced on) — as a module. An op whose inputs then
    sit on the card runs its CUDA implementation."""
    from torch.export.passes import move_to_device_pass

    ep = load_artifact(path)
    in_info, out_info = artifact_tensors_info(ep)
    ep = move_to_device_pass(ep, device)
    return dict(module=ep.module(), in_info=in_info, out_info=out_info,
                exported=ep)


def export_model(model: str, out_path: str, custom: Optional[str] = None,
                 input_dims: Optional[str] = None,
                 input_types: Optional[str] = None) -> TensorsInfo:
    """Export a model the torch backend loads (a registered name, a
    ``.py`` with ``get_model()``, a ``.msgpack`` with ``custom=module:
    <factory>``, a ``.pt``/``.pth`` file) to a ``.pt2`` at ``out_path`` —
    the producer half of the opaque-file story (CLI: ``--export``).
    ``input_dims`` overrides the model's declared input info (e.g. to
    re-specialize the batch). The batch dimension is exported dynamic
    where the inputs share one of 2 or more rows (:func:`save_artifact`).
    Returns the artifact's output info."""
    from nnstreamer_tpu_torch.filters import torch_backend as tb

    entry = tb.resolve_python_model(model, custom)
    if entry is None:
        entry = tb._load_file(model, torch.device("cpu"))
    module = entry["module"]
    if isinstance(module, torch.jit.ScriptModule):
        raise ValueError(f"export: {model!r} is TorchScript, which "
                         "torch.export does not trace")
    in_info = entry.get("in_info")
    if input_dims:
        if input_types is None and in_info is not None:
            # dims-only override: keep the model's declared types
            input_types = ",".join(t.type.value for t in in_info)
        in_info = TensorsInfo.from_str(input_dims, input_types or "float32")
    if in_info is None:
        raise ValueError(
            "export: model has no input info; pass input_dims/input_types "
            "(caps grammar, e.g. '3:224:224:1' 'float32')")
    cpu = _cpu_copy(module)
    ep = save_artifact(out_path, cpu, in_info=in_info)
    return artifact_tensors_info(ep)[1]


def _cpu_copy(module: torch.nn.Module) -> torch.nn.Module:
    """``module`` with its weights on the CPU (a copy when they are on a
    card, so a module other pipelines serve is not moved)."""
    if all(t.device.type == "cpu" for t in
           list(module.parameters()) + list(module.buffers())):
        return module
    import copy

    return copy.deepcopy(module).to("cpu")
