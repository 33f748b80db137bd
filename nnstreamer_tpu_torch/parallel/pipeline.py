"""Pipeline parallelism — GPipe-style microbatch pipelining over mesh
axis ``pp``.

The JAX package's ``parallel/pipeline.py`` on the port's single-controller
mesh. The stacked layer axis L is split over ``pp`` (each stage holds
L/pp contiguous layers), a batch is split into microbatches, and the
classic schedule runs for ``num_microbatches + pp - 1`` steps: at step t
stage 0 takes microbatch t, every other stage takes what the stage
before it handed on at step t - 1 (``lax.ppermute`` one stage forward),
and the last stage's result is microbatch ``t - (pp - 1)``. The bubble
fraction is (pp-1)/(num_mb+pp-1).

At each step the ranks of every stage that holds a microbatch run at
once, one thread a device (``parallel/sharded.run_ranks``), and meet
within their stage at the tp, ep and sp collectives (ring attention when
``sp`` > 1); the controller then moves each stage's activations to the
next stage's devices. A stage with no microbatch at a step (the bubble)
does not run: in the JAX package it computes on a placeholder whose
result is discarded. The outputs gather on the mesh's first device,
which is where every stage's copy of them meets in a single controller
(the JAX package's ``psum`` of zeros over ``pp``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from nnstreamer_tpu_torch.models import transformer as _tf
from nnstreamer_tpu_torch.models.transformer import (
    TransformerConfig,
    make_layer_body,
)
from nnstreamer_tpu_torch.parallel.mesh import Mesh, P, PartitionSpec
from nnstreamer_tpu_torch.parallel.ring import ring_attention
from nnstreamer_tpu_torch.parallel.sharded import (
    _assemble,
    _local,
    _move,
    _seq_parts,
    _split,
    check_experts,
    rank_groups,
    run_ranks,
)


def _stage_param_tree(cfg: TransformerConfig) -> Dict[str, int]:
    """Skeleton tree matching the stacked layer params (values unused)."""
    keys = ["ln1", "qkv", "proj", "ln2"]
    keys += (["router", "w_in", "w_out"] if cfg.num_experts
             else ["w_in", "w_out"])
    return {k: 0 for k in keys}


def pipeline_param_specs(cfg: TransformerConfig) -> Dict[str, PartitionSpec]:
    """PartitionSpecs for the pipelined model: L axis over ``pp``, tp/ep
    exactly as the unpipelined placement
    (``parallel.sharded.transformer_param_specs``)."""
    specs = {
        "embed": P(None, "tp"),
        "ln1": P("pp", None),
        "qkv": P("pp", None, None, "tp", None),
        "proj": P("pp", "tp", None, None),
        "ln2": P("pp", None),
        "ln_f": P(None),
    }
    if cfg.num_experts:
        specs["router"] = P("pp", None, "ep")
        specs["w_in"] = P("pp", "ep", None, "tp")
        specs["w_out"] = P("pp", "ep", "tp", None)
    else:
        specs["w_in"] = P("pp", None, "tp")
        specs["w_out"] = P("pp", "tp", None)
    return specs


def _schedule(cfg: TransformerConfig, mesh: Mesh, params: Dict[str, Any],
              num_mb: int, batch: int, seq: int, positions: torch.Tensor,
              ingest: Callable, finish: Callable) -> torch.Tensor:
    """Run the GPipe schedule over ``mesh``: ``ingest(lp, m, rows, cols,
    dev)`` gives stage 0's input for microbatch ``m`` (its rows and
    sequence columns, on the rank's device), each stage applies its
    layers, and ``finish(lp, x)`` maps the last stage's activations to
    the output. Returns the outputs ``[num_mb, batch, seq, ...]`` on the
    mesh's first device."""
    check_experts(cfg, mesh)
    pp = mesh.shape.get("pp", 1)
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers {cfg.n_layers} does not divide by the "
                         f"pp mesh axis ({pp})")
    sp = _seq_parts(mesh, seq)
    dp = mesh.shape.get("dp", 1)
    if batch % dp:
        raise ValueError(f"microbatch rows {batch} do not divide by the dp "
                         f"mesh axis ({dp})")
    per_stage = cfg.n_layers // pp
    body = make_layer_body(
        cfg, ring_attention if mesh.shape.get("sp", 1) > 1 else None)
    coords = mesh.coords()
    devs = [d.device for d in mesh.device_list()]
    # flat index of the rank one stage on (same coordinates otherwise)
    nxt = {}
    for i, c in enumerate(coords):
        for k, c2 in enumerate(coords):
            if c2.get("pp", 0) == c.get("pp", 0) + 1 and all(
                    c2[a] == c[a] for a in c if a != "pp"):
                nxt[i] = k
    locs = {}
    for i, c in enumerate(coords):
        lp = _local(params, i, devs[i])
        stage = c.get("pp", 0)
        # a placement without pp holds every layer: take the stage's
        locs[i] = {k: (v.narrow(0, stage * per_stage, per_stage)
                       if k not in ("embed", "ln_f") and v.shape[0] !=
                       per_stage else v) for k, v in lp.items()}
    state: Dict[int, torch.Tensor] = {}
    outs: Dict[int, List[Optional[torch.Tensor]]] = {
        i: [None] * num_mb for i, c in enumerate(coords)
        if c.get("pp", 0) == pp - 1}
    for t in range(num_mb + pp - 1):
        active = [i for i, c in enumerate(coords)
                  if 0 <= t - c.get("pp", 0) < num_mb]

        def rank(k, t=t, active=active):
            i = active[k]
            c = coords[i]
            stage = c.get("pp", 0)
            rows = _split(batch, dp, c.get("dp", 0))
            cols = _split(seq, sp, c.get("sp", 0))
            lp = locs[i]
            x = ingest(lp, t, rows, cols, devs[i]) if stage == 0 \
                else state[i]
            pos = _move(positions[rows, cols], devs[i])
            for l in range(per_stage):
                x, _ = body(x, pos, _tf._layer(lp, l))
            return finish(lp, x) if stage == pp - 1 else x

        res = run_ranks([devs[i] for i in active],
                        rank_groups([coords[i] for i in active]), rank)
        for i, x in zip(active, res):
            if coords[i].get("pp", 0) == pp - 1:
                outs[i][t - (pp - 1)] = x
            else:
                # hand the activations one stage forward
                state[nxt[i]] = _move(x, devs[nxt[i]])
    last = sorted(outs)
    per_mb = [_assemble(mesh, [coords[i] for i in last],
                        [outs[i][m] for i in last], dp, sp, devs[0],
                        seq_dim=1) for m in range(num_mb)]
    return torch.stack(per_mb)


def pipelined_block_forward(cfg: TransformerConfig, mesh: Mesh) -> Callable:
    """Returns ``blocks(stage_params, x, positions) -> y`` where

    - ``x``/``y``: activations ``[num_mb, mb_batch, seq, d_model]`` (y on
      the mesh's first device),
    - ``positions``: ``[num_mb, mb_batch, seq]`` global rotary positions
      (every microbatch takes the first's, as in the JAX package),
    - ``stage_params``: the stacked layer params placed with their
      leading L axis over ``pp`` (each stage sees L/pp layers).
    """
    def blocks(stage_params, x, positions):
        missing = set(_stage_param_tree(cfg)) - set(stage_params)
        if missing:
            raise ValueError(f"stage params lack {sorted(missing)}")
        num_mb, mb, s = x.shape[:3]
        return _schedule(
            cfg, mesh, stage_params, num_mb, mb, s, positions[0],
            lambda lp, m, rows, cols, dev: _move(x[m, rows, cols], dev),
            lambda lp, y: y)

    return blocks


def build_pipelined_forward(cfg: TransformerConfig, mesh: Mesh,
                            num_microbatches: int) -> Callable:
    """``apply_fn(params, tokens[int num_mb, mb, s]) -> logits [num_mb,
    mb, s, vocab]``. The first stage's ranks embed their tokens and the
    last stage's compute the final norm and the logits (the embedding is
    replicated over pp: a copy a stage); only the block stack is
    pipelined."""
    dtype = cfg.dtype

    def apply_fn(params, tokens):
        tokens = torch.as_tensor(tokens)
        num_mb, mb, s = tokens.shape
        if num_mb != num_microbatches:
            raise ValueError(
                f"tokens leading dim {num_mb} != num_microbatches "
                f"{num_microbatches} the step was built for")
        positions = torch.arange(s, dtype=torch.int32)[None, :].expand(mb, s)
        return _schedule(
            cfg, mesh, params, num_mb, mb, s, positions,
            lambda lp, m, rows, cols, dev: _tf._embed(
                lp, _move(tokens[m, rows, cols], dev), dtype),
            lambda lp, y: _tf._final_logits(y, lp))

    return apply_fn
