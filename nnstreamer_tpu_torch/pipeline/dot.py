"""Pipeline graph dumps in Graphviz dot format.

A copy of the JAX package's ``pipeline/dot.py`` (no JAX in it). The
reference inherits GStreamer's ``GST_DEBUG_DUMP_DOT_DIR``: set the env
var, and every pipeline state change writes a ``.dot`` of the runtime
graph — the standard way to debug caps negotiation and topology.
Equivalent here:

- ``pipeline_to_dot(pipe)`` — dot text for the CURRENT runtime graph:
  elements, pad links, negotiated caps on edges, and fused regions drawn
  as clusters around their member elements (a region runs as one CUDA
  graph on the card, so the fusion is visible, not hidden).
- ``NNSTPU_DUMP_DOT_DIR=<dir>`` — every ``Pipeline.start()`` writes
  ``<serial>-<name>.playing.dot`` there (serial keeps repeated runs
  distinct, mirroring the reference's timestamped dumps).
- ``nns-launch --dot FILE`` writes the started graph and keeps running.

Render with ``dot -Tpng out.dot``.
"""

from __future__ import annotations

import itertools
import os
from typing import List

_serial = itertools.count()


def _esc(s: str) -> str:
    return str(s).replace('"', '\\"')


def _caps_label(pad) -> str:
    caps = getattr(pad, "caps", None)
    return _esc(str(caps)) if caps is not None else ""


def pipeline_to_dot(pipe) -> str:
    """Dot text for a pipeline's current element/link graph."""
    lines: List[str] = [
        "digraph pipeline {",
        "  rankdir=LR;",
        "  node [shape=box, fontsize=10, fontname=monospace];",
        "  edge [fontsize=8, fontname=monospace];",
        f'  label="{_esc(pipe.name)} ({pipe.state.value})";',
    ]
    regions = [r for r in (pipe._regions or ()) if not r._dead]
    lane_execs = list(getattr(pipe, "_lane_execs", None) or ())
    nodes = list(pipe.elements) + regions + lane_execs

    def node_id(el) -> str:
        return f"n{id(el):x}"

    in_region = {id(m) for r in regions for m in r.members}
    for el in pipe.elements:
        if id(el) in in_region:
            continue
        lines.append(
            f'  {node_id(el)} [label="{_esc(el.name)}\\n'
            f'({_esc(el.ELEMENT_NAME)})"];')
    for r in regions:
        lines.append(f"  subgraph cluster_{node_id(r)} {{")
        lines.append(f'    label="{_esc(r.name)}\\n(fused region — one '
                     f'CUDA graph)"; style=dashed; color=blue;')
        for m in r.members:
            lines.append(
                f'    {node_id(m)} [label="{_esc(m.name)}\\n'
                f'({_esc(m.ELEMENT_NAME)})"];')
        lines.append("  }")
        # the region itself: a small routing node so external links render
        lines.append(
            f'  {node_id(r)} [label="{_esc(r.name)}" shape=cds '
            f"color=blue];")
    for ex in lane_execs:
        # the ingest lane executor spliced between source and the rest of
        # the graph (pipeline/lanes.py): a routing node like the regions',
        # plus a dashed edge to the template segment it replicates per lane
        lines.append(
            f'  {node_id(ex)} [label="{_esc(ex.name)}\\n'
            f'({ex.n} ingest lanes)" shape=cds color=darkgreen];')
        if ex.segment:
            lines.append(
                f"  {node_id(ex)} -> {node_id(ex.segment[0])} "
                f'[label="replicates ×{ex.n}" style=dashed '
                f"color=darkgreen];")
    for el in nodes:
        for sp in el.srcpads:
            peer = sp.peer
            if peer is None:
                continue
            label = _caps_label(sp)
            attr = f' [label="{label}"]' if label else ""
            lines.append(
                f"  {node_id(el)} -> {node_id(peer.element)}{attr};")
    lines.append("}")
    return "\n".join(lines) + "\n"


def maybe_dump_dot(pipe, phase: str = "playing") -> str | None:
    """Write a dot dump if ``NNSTPU_DUMP_DOT_DIR`` is set; returns the
    path written (or None). Failures only warn — a dump must never take
    down the pipeline."""
    out_dir = os.environ.get("NNSTPU_DUMP_DOT_DIR", "").strip()
    if not out_dir:
        return None
    from nnstreamer_tpu_torch.log import get_logger

    try:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir, f"{next(_serial):04d}-{pipe.name}.{phase}.dot")
        with open(path, "w") as f:
            f.write(pipeline_to_dot(pipe))
        return path
    except Exception as e:  # noqa: BLE001 — a debugging aid must never
        # abort Pipeline.start(): encoding errors, odd node attributes,
        # and filesystem failures all just warn
        get_logger("dot").warning("dot dump failed: %s", e)
        return None
