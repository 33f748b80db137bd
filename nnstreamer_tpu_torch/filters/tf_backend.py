"""TensorFlow filter backend — SavedModel and frozen-GraphDef ingestion.

Port of ``nnstreamer_tpu/filters/tf_backend.py`` (reference
``tensor_filter_tensorflow.cc``, which runs TF graphs in-process through
libtensorflow). The JAX package stages the graph through TF's XLA bridge
to StableHLO at ``open()`` and runs it as a jitted, fusible JAX function.
The port has no StableHLO runtime, so it runs the graph in TensorFlow on
the host, as the reference does: a ``tf.function`` over the loaded
signature (variables frozen into constants, as the JAX package freezes
them), numpy in and numpy out. The filter keeps nothing on the card
(``KEEP_ON_DEVICE = False``) and joins no fused region (ROADMAP C.46).

``framework=tensorflow model=saved_model_dir`` (``custom=signature:NAME``,
default ``serving_default``), or ``model=frozen.pb`` with
``custom=inputname:x,outputname:y`` (``;`` between several names), the
reference's required input/output properties. Static input shapes are
needed, as in the JAX package: a dynamic dimension is pinned by the
filter's ``input``/``inputtype`` properties. The torch backend sends a
``.pb`` file or a SavedModel directory here too (``framework=torch`` or
``jax``), as the JAX package's ``jax`` backend sends them to its TF
staging. ``tensorflow`` is imported at ``open()``: importing the port
loads none of it.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence

import numpy as np

from nnstreamer_tpu_torch.filters.api import (
    FilterFramework,
    FilterProperties,
    parse_custom,
)
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.registry import FILTER, subplugin
from nnstreamer_tpu_torch.tensors.types import TensorInfo, TensorsInfo, TensorType

log = get_logger("filter.tf")


def is_tf_model(model: Optional[str]) -> bool:
    """A frozen ``.pb`` GraphDef file or a SavedModel directory."""
    if not model:
        return False
    if model.endswith(".pb") and os.path.isfile(model):
        return True
    return os.path.isdir(model) and any(
        os.path.isfile(os.path.join(model, name))
        for name in ("saved_model.pb", "saved_model.pbtxt"))


def _static_specs(specs, model: str):
    import tensorflow as tf

    fixed = []
    for s in specs:
        if s.shape.rank is None or any(d is None for d in s.shape):
            raise ValueError(
                f"tensorflow: {model!r} input {s.name or ''} has dynamic "
                f"shape {s.shape} — the filter needs static shapes; set the "
                "input property on tensor_filter (input=DIMS "
                "inputtype=TYPE) to pin it")
        fixed.append(tf.TensorSpec(s.shape, s.dtype, name=s.name))
    return fixed


def _pinned(specs, props_in_info, named: bool):
    """``specs`` with the dims the user pinned (innermost-first caps dims)
    in place of the model's, when the counts agree."""
    import tensorflow as tf

    if props_in_info is None or len(props_in_info) != len(specs):
        return specs
    return [tf.TensorSpec(tuple(reversed(ti.dim)), s.dtype,
                          name=s.name if named else None)
            for ti, s in zip(props_in_info, specs)]


def _info(shapes_and_dtypes) -> TensorsInfo:
    return TensorsInfo([
        TensorInfo(dim=tuple(reversed([int(d) for d in shape])) or (1,),
                   type=TensorType.from_any(np.dtype(dtype)))
        for shape, dtype in shapes_and_dtypes])


def _entry(call, specs, model: str, what: str) -> dict:
    """The backend entry (fn/in_info/out_info) of a TF callable traced
    once on ``specs``: ``fn`` takes and returns numpy arrays."""
    import tensorflow as tf

    fn = tf.function(call, input_signature=specs)
    cf = fn.get_concrete_function(*specs)
    in_info = _info((s.shape, s.dtype.as_numpy_dtype) for s in specs)
    out_info = _info((t.shape, t.dtype.as_numpy_dtype) for t in cf.outputs)
    log.info("tensorflow: loaded %s %s (%d inputs -> %d outputs)", what,
             model, len(in_info), len(out_info))

    def run(*xs):
        return [np.asarray(o) for o in cf(*xs)]

    return dict(fn=run, in_info=in_info, out_info=out_info)


def saved_model_entry(model: str, signature: Optional[str] = None,
                      props_in_info=None) -> dict:
    """SavedModel dir → backend entry (fn/in_info/out_info)."""
    import tensorflow as tf
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    sm = tf.saved_model.load(model)
    sig_name = signature or "serving_default"
    if sig_name not in sm.signatures:
        raise ValueError(
            f"tensorflow: SavedModel {model!r} has no signature "
            f"{sig_name!r} (available: {sorted(sm.signatures)})")
    cf = sm.signatures[sig_name]
    kwargs_sig = cf.structured_input_signature[1]
    # positional order: the sorted keys, as TF's nest flattens a dict (and
    # as the JAX package orders them)
    specs = [kwargs_sig[n] for n in sorted(kwargs_sig)]
    specs = _static_specs(_pinned(specs, props_in_info, True), model)
    frozen = convert_variables_to_constants_v2(cf)

    def call(*xs):
        out = frozen(*xs)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    return _entry(call, specs, model, f"SavedModel sig={sig_name}")


def graphdef_entry(model: str, custom: Optional[str] = None,
                   props_in_info=None) -> dict:
    """Frozen GraphDef ``.pb`` → backend entry. Needs tensor names the way
    the reference does: ``custom="inputname:x,outputname:y"``."""
    import tensorflow as tf

    opts = parse_custom(custom)
    in_names = [n for n in opts.get("inputname", "").split(";") if n]
    out_names = [n for n in opts.get("outputname", "").split(";") if n]
    if not in_names or not out_names:
        raise ValueError(
            "tensorflow: a frozen GraphDef needs tensor names — pass "
            'custom="inputname:input0,outputname:logits" on tensor_filter '
            "(the reference requires the same via input/output props, "
            "tensor_filter_tensorflow.cc)")
    gd = tf.compat.v1.GraphDef()
    with open(model, "rb") as f:
        gd.ParseFromString(f.read())

    def _name(t):
        return t if ":" in t else t + ":0"

    wrapped = tf.compat.v1.wrap_function(
        lambda: tf.compat.v1.import_graph_def(gd, name=""), [])
    cf = wrapped.prune([_name(n) for n in in_names],
                       [_name(n) for n in out_names])
    # a pruned function's flat inputs are the placeholders in the order
    # prune() was given
    specs = [tf.TensorSpec(t.shape, t.dtype) for t in cf.inputs]
    specs = _static_specs(_pinned(specs, props_in_info, False), model)

    def call(*xs):
        out = cf(*xs)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    return _entry(call, specs, model, "GraphDef")


def tf_model_entry(model: str, custom: Optional[str] = None,
                   props_in_info=None) -> dict:
    opts = parse_custom(custom)
    if os.path.isdir(model):
        return saved_model_entry(model, signature=opts.get("signature"),
                                 props_in_info=props_in_info)
    return graphdef_entry(model, custom=custom, props_in_info=props_in_info)


@subplugin(FILTER, "tensorflow")
class TensorFlowFilter(FilterFramework):
    """framework=tensorflow — a SavedModel or a frozen .pb run by TF on the
    host (ROADMAP C.46: the JAX package stages it onto the accelerator)."""

    NAME = "tensorflow"
    KEEP_ON_DEVICE = False

    def __init__(self):
        super().__init__()
        self._entry: Optional[dict] = None

    def open(self, props: FilterProperties) -> None:
        super().open(props)
        model = props.model or ""
        if not is_tf_model(model):
            raise ValueError(
                f"tensorflow: {model!r} is neither a SavedModel directory "
                "nor a frozen .pb GraphDef")
        try:
            import tensorflow  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "tensorflow: the tensorflow package is not importable in "
                "this environment; export the model to a .pt2 file and "
                "load it with framework=torch") from e
        self._entry = tf_model_entry(model, custom=props.custom,
                                     props_in_info=props.input_info)

    def close(self) -> None:
        self._entry = None
        super().close()

    def get_model_info(self):
        return self._entry["in_info"], self._entry["out_info"]

    def invoke(self, inputs: Sequence[Any]) -> List[np.ndarray]:
        xs = [np.asarray(x) for x in inputs]
        with self.global_stats().measure():
            return self._entry["fn"](*xs)
