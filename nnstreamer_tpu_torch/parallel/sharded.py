"""Sharding rules for the transformer and its sharded serving steps.

The JAX package's ``parallel/sharded.py`` names a PartitionSpec per
parameter and lets XLA insert the collectives. The port keeps the specs
(:func:`transformer_param_specs`) and runs the shards itself, on the
single-controller mesh of ``parallel/mesh.py``:

- **dp** splits the batch (the engine's decode lanes): each dp rank runs
  the model's step function on its rows, its shard of the cache and its
  copy of the weights.
- **tp** splits heads and the FFN hidden dimension (and the embedding's
  model dimension): the tp ranks of one dp rank run the same step
  function at once, one thread each (as ``torch.nn.DataParallel`` drives
  its devices), and meet at the explicit collectives the model's layer
  math calls (``models.transformer.tp_sum``/``tp_gather``): the sum of
  the partial products after ``proj`` and after ``w_out``, the gather of
  the embedding's columns, and the sum of the logits' partial products.
  A mesh whose tp axis has one device calls no collective.

Training and long context are ROADMAP A.25: :func:`make_train_step`,
:func:`lm_loss`, :func:`make_pp_train_step`, ring attention over ``sp``
and the pipelined (``pp``) placement raise naming it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from nnstreamer_tpu_torch.models import transformer as _tf
from nnstreamer_tpu_torch.models.transformer import (
    KVCache,
    TransformerConfig,
    build_forward,
)
from nnstreamer_tpu_torch.parallel.mesh import (
    Mesh,
    P,
    PartitionSpec,
    ShardedTensor,
)
from nnstreamer_tpu_torch.pipeline.element import not_ported

_TRAINING = "A.25 training and long context"


def transformer_param_specs(cfg: TransformerConfig
                            ) -> Dict[str, PartitionSpec]:
    """PartitionSpec per param name. tp shards heads / ff hidden; ep shards
    experts; everything else is replicated (the layer axis L is never
    sharded)."""
    specs = {
        "embed": P(None, "tp"),
        "ln1": P(None, None),
        "qkv": P(None, None, None, "tp", None),
        "proj": P(None, "tp", None, None),
        "ln2": P(None, None),
        "ln_f": P(None),
    }
    if cfg.num_experts:
        specs["router"] = P(None, None, "ep")
        specs["w_in"] = P(None, "ep", None, "tp")
        specs["w_out"] = P(None, "ep", "tp", None)
    else:
        specs["w_in"] = P(None, None, "tp")
        specs["w_out"] = P(None, "tp", None)
    return specs


def _mesh_axis(mesh: Mesh, name: str) -> bool:
    return name in mesh.axis_names and mesh.shape[name] > 1


def _check_axes(mesh: Mesh) -> None:
    """The serving steps run dp and tp; any other axis of more than one
    device (ring attention over sp, experts over ep, stages over pp) is
    A.25's."""
    for name in ("sp", "ep", "pp"):
        if _mesh_axis(mesh, name):
            raise not_ported(f"a {name} mesh axis of more than one device",
                             _TRAINING)


# -- tensor-parallel groups ----------------------------------------------------
class TpGroup:
    """The tp ranks of one dp rank, one thread each, meeting at the model's
    collectives. A collective deposits each rank's tensor, waits for all,
    and gives every rank the same result, combined in rank order on its
    own device."""

    def __init__(self, n: int):
        self._slots: List[Optional[torch.Tensor]] = [None] * n
        self._barrier = threading.Barrier(n)

    def _exchange(self, rank: int, x: torch.Tensor) -> List[torch.Tensor]:
        self._slots[rank] = x
        self._barrier.wait()
        parts = [_move(t, x.device) for t in self._slots]
        self._barrier.wait()  # every rank has read before the next write
        return parts

    def all_reduce(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        parts = self._exchange(rank, x)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def all_gather(self, rank: int, x: torch.Tensor, dim: int
                   ) -> torch.Tensor:
        return torch.cat(self._exchange(rank, x), dim=dim)

    def abort(self) -> None:
        self._barrier.abort()


def run_tp(devices: Sequence[torch.device],
           fn: Callable[[int], Any]) -> List[Any]:
    """``fn(rank)`` for each tp rank: in the calling thread for one rank
    (no collective: the model's layer math then runs as on one device),
    else one thread a rank inside a :class:`TpGroup`. Returns the ranks'
    results in order; the first failure is raised after every rank ended
    (a failing rank aborts the group, so no rank waits forever)."""
    if len(devices) == 1:
        return [fn(0)]
    group = TpGroup(len(devices))
    results: List[Any] = [None] * len(devices)
    errors: List[BaseException] = []
    # autograd modes are per thread: the ranks run in the caller's
    inference = torch.is_inference_mode_enabled()
    grad = torch.is_grad_enabled()

    def body(rank):
        try:
            with _tf.tp_rank(group, rank), _on_device(devices[rank]), \
                    torch.inference_mode(inference), \
                    torch.set_grad_enabled(grad):
                results[rank] = fn(rank)
        except threading.BrokenBarrierError as e:
            errors.append(e)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.insert(0, e)
            group.abort()

    threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                name=f"tp-rank-{r}")
               for r in range(len(devices))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return results


def _on_device(dev: torch.device):
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


# -- sharded views ---------------------------------------------------------------
def _move(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``x`` on ``dev`` (itself when already there)."""
    return x.to(dev)  # nns-lint: disable=NNS113 -- a shard or a step's rows moving between mesh devices; the placed weights and caches are registered where serve places them


def _narrow_view(t: torch.Tensor, dim: int, lo: int, hi: int,
                 device: torch.device) -> Tuple[torch.Tensor, bool]:
    """``t[lo:hi]`` along ``dim`` on ``device``: a view when ``t`` is
    there (writes land in ``t``), else a copy (second value True: the
    caller writes it back)."""
    part = t.narrow(dim, lo, hi - lo)
    if part.device == device:
        return part, False
    return _move(part, device), True


class ShardedLM:
    """The transformer's serving steps on a dp × tp mesh.

    ``params`` are :func:`transformer_param_specs` placements
    (``serve.place_params``); the engine's monolithic cache is sharded
    slots over dp and heads over tp (``[L, 2, B, S, h, dh]`` leaves:
    spec ``(None, None, dp, None, tp)``); the paged arena blocks over dp
    and heads over tp (``[L, NTOT + 1, 2, T, h, dh]``: ``(None, dp,
    None, None, tp)``). A batch-1 cache (prefill, chunked prefill, the
    prefix cache) is one plain tensor per leaf on the mesh's first
    device, as the JAX engine's batch-1 cache is unsharded; each tp rank
    reads and writes its heads of it.

    Each method is the matching ``models.transformer.build_*`` step
    function with the same arguments and results, run shard by shard: the
    rows of dp rank d on d's devices, the heads of tp rank t on t's. On a
    mesh of one device every shard is the whole tensor (a view), so the
    step runs exactly as unsharded and a CUDA graph captures it as one.

    The paged steps run every row against one block-gathered arena per
    tp rank, on the dp-0 device of that rank (a stream's table may name
    blocks of any dp shard), and write the blocks back to their shards:
    the arena is placed over dp, its compute is not split by dp.
    """

    def __init__(self, cfg: TransformerConfig, mesh: Mesh, fns: Dict[str,
                 Callable]):
        _check_axes(mesh)
        self.cfg = cfg
        self.mesh = mesh
        self.dp = mesh.shape.get("dp", 1)
        self.tp = mesh.shape.get("tp", 1)
        coords = mesh.coords()
        flat = {(c.get("dp", 0), c.get("tp", 0)): i
                for i, c in enumerate(coords)
                if all(c[a] == 0 for a in c if a not in ("dp", "tp"))}
        #: flat device index of (dp rank, tp rank)
        self._idx = flat
        self._devs = [d.device for d in mesh.device_list()]
        self._fns = fns
        h = cfg.n_heads
        self._heads = [(t * h // self.tp, (t + 1) * h // self.tp)
                       for t in range(self.tp)]

    @property
    def device(self) -> torch.device:
        """The controller's device: where results gather."""
        return self._devs[0]

    def _dev(self, d: int, t: int) -> torch.device:
        return self._devs[self._idx[(d, t)]]

    def _local_params(self, params: Dict[str, Any], d: int, t: int
                      ) -> Dict[str, torch.Tensor]:
        i = self._idx[(d, t)]
        return {k: (v.shards[i] if isinstance(v, ShardedTensor) else v)
                for k, v in params.items()}

    def _local_cache(self, cache: KVCache, d: int, t: int) -> KVCache:
        i = self._idx[(d, t)]
        return KVCache(*(leaf.shards[i] for leaf in cache.leaves()))

    def _rows(self, b: int, d: int) -> slice:
        n = b // self.dp
        return slice(d * n, (d + 1) * n)

    @staticmethod
    def _to(x, rows, dev):
        """A per-row input (a tensor or a host int) for one dp rank."""
        if isinstance(x, torch.Tensor) and x.dim() > 0:
            return _move(x[rows], dev)
        if isinstance(x, torch.Tensor):
            return _move(x, dev)
        return x

    def _gather_rows(self, outs: List[torch.Tensor]) -> torch.Tensor:
        if len(outs) == 1:
            return outs[0]
        return torch.cat([_move(o, self.device) for o in outs])

    # -- batch-1 caches ----------------------------------------------------
    @contextlib.contextmanager
    def _head_slices(self, cache1: KVCache, t: int, dev: torch.device):
        """tp rank ``t``'s heads of a plain batch-1 cache, on ``dev``;
        written back when they had to be copied there."""
        lo, hi = self._heads[t]
        parts = [_narrow_view(leaf, 4, lo, hi, dev)
                 for leaf in cache1.leaves()]
        yield KVCache(*(p for p, _ in parts))
        for leaf, (p, copied) in zip(cache1.leaves(), parts):
            if copied:
                leaf.narrow(4, lo, hi - lo).copy_(p)

    def prefill(self, params, tokens, lengths=None):
        """``build_prefill``'s step on dp rank 0's tp group: the logits and
        a plain batch-1 cache on the first device (heads gathered)."""
        def rank(t):
            dev = self._dev(0, t)
            return self._fns["prefill"](self._local_params(params, 0, t),
                                        _move(tokens, dev), lengths)

        outs = run_tp([self._dev(0, t) for t in range(self.tp)], rank)
        logits = outs[0][0]
        if len(outs) == 1:
            return logits, outs[0][1]
        leaves = zip(*(o[1].leaves() for o in outs))
        cache = KVCache(*(torch.cat([_move(x, self.device) for x in ls], dim=4)
                          for ls in leaves))
        return logits, cache

    def chunk(self, params, tokens, cache1, pos0):
        """``build_chunk_decode``'s step on a plain batch-1 cache."""
        def rank(t):
            dev = self._dev(0, t)
            with self._head_slices(cache1, t, dev) as local:
                logits, _ = self._fns["chunk"](
                    self._local_params(params, 0, t), _move(tokens, dev),
                    local, _move(pos0, dev)
                    if isinstance(pos0, torch.Tensor) else pos0)
            return logits

        return run_tp([self._dev(0, t) for t in range(self.tp)],
                      rank)[0], cache1

    # -- the engine's sharded cache ----------------------------------------
    def decode(self, params, token, cache, pos):
        """``build_decode_step``'s step: each dp rank its rows and its
        cache shard."""
        outs = []
        for d in range(self.dp):
            rows = self._rows(token.shape[0], d)

            def rank(t, d=d, rows=rows):
                dev = self._dev(d, t)
                logits, _ = self._fns["decode"](
                    self._local_params(params, d, t),
                    self._to(token, rows, dev),
                    self._local_cache(cache, d, t),
                    self._to(pos, rows, dev))
                return logits

            outs.append(run_tp([self._dev(d, t) for t in range(self.tp)],
                               rank)[0])
        return self._gather_rows(outs), cache

    def write_slot(self, cache, slot: int, cache1: KVCache) -> None:
        """Copy a batch-1 cache into batch slot ``slot`` of the sharded
        cache: the slot's dp rank, each tp rank its heads."""
        per = cache.leaves()[0].shape[2] // self.dp
        d, local = divmod(int(slot), per)
        for leaf, src in zip(cache.leaves(), cache1.leaves()):
            for t in range(self.tp):
                lo, hi = self._heads[t]
                dst = leaf.shards[self._idx[(d, t)]]
                dst[:, :, local].copy_(src[:, :, 0].narrow(3, lo, hi - lo))

    # -- the paged arena ----------------------------------------------------
    @contextlib.contextmanager
    def blocks(self, arena: KVCache, t: int):
        """tp rank ``t``'s arena with every dp shard's blocks in order, on
        its dp-0 device: the shard itself under dp1, else a gathered copy
        whose block ranges are written back to their shards after."""
        parts = [[leaf.shards[self._idx[(d, t)]] for d in range(self.dp)]
                 for leaf in arena.leaves()]
        if self.dp == 1:
            yield KVCache(*(p[0] for p in parts))
            return
        dev = self._dev(0, t)
        full = [torch.cat([_move(x, dev) for x in p], dim=1) for p in parts]
        yield KVCache(*full)
        for p, f in zip(parts, full):
            off = 0
            for x in p:
                n = x.shape[1]
                x.copy_(f.narrow(1, off, n))
                off += n

    def _paged(self, name, params, tokens, arena, rest):
        """``name``'s step ``(params, tokens, arena, *rest)`` on each tp
        rank's block-gathered arena."""
        def rank(t):
            dev = self._dev(0, t)
            moved = [_move(a, dev) if isinstance(a, torch.Tensor) else a
                     for a in rest]
            with self.blocks(arena, t) as local:
                logits, _ = self._fns[name](
                    self._local_params(params, 0, t), _move(tokens, dev),
                    local, *moved)
            return logits

        return run_tp([self._dev(0, t) for t in range(self.tp)],
                      rank)[0], arena

    def paged_decode(self, params, token, arena, bt, pos):
        return self._paged("paged_decode", params, token, arena, (bt, pos))

    def paged_chunk(self, params, tokens, arena, bt, pos0, limit):
        return self._paged("paged_chunk", params, tokens, arena,
                           (bt, pos0, limit))

    def scatter_prefill(self, arena: KVCache, cache1: KVCache,
                        apply: Callable[[KVCache, KVCache], None]) -> None:
        """``apply(arena_view, cache1_heads)`` for each tp rank on its
        block-gathered arena and its heads of a plain batch-1 cache."""
        for t in range(self.tp):
            dev = self._dev(0, t)
            with self.blocks(arena, t) as local, \
                    self._head_slices(cache1, t, dev) as heads:
                apply(local, heads)

    def each_arena(self, arena: KVCache, apply: Callable[[KVCache], None]
                   ) -> None:
        """``apply(arena_view)`` for each tp rank's block-gathered arena."""
        for t in range(self.tp):
            with self.blocks(arena, t) as local:
                apply(local)


def make_sharded_forward(cfg: TransformerConfig, mesh: Mesh) -> Callable:
    """``apply_fn(params, tokens) -> logits`` over ``mesh``: params placed
    per :func:`transformer_param_specs` (``shard_params``), the batch
    over dp, heads and the FFN over tp. Ring attention over ``sp`` is
    A.25's."""
    _check_axes(mesh)
    fwd = build_forward(cfg)
    lm = ShardedLM(cfg, mesh, {})

    def apply_fn(params, tokens, position_offset=0):
        outs = []
        dp = lm.dp if tokens.shape[0] % lm.dp == 0 else 1
        for d in range(dp):
            rows = slice(d * tokens.shape[0] // dp,
                         (d + 1) * tokens.shape[0] // dp)

            def rank(t, d=d, rows=rows):
                dev = lm._dev(d, t)
                return fwd(lm._local_params(params, d, t),
                           _move(tokens[rows], dev), position_offset)

            outs.append(run_tp([lm._dev(d, t) for t in range(lm.tp)],
                               rank)[0])
        return lm._gather_rows(outs)

    return apply_fn


def shard_params(params, mesh: Mesh, cfg: TransformerConfig,
                 pipelined: bool = False):
    """Rule-sharded param placement, routed through the serving plane's
    :func:`~nnstreamer_tpu_torch.parallel.serve.place_params` so the
    per-shard bytes register with the budget accountant whenever one is
    active. The matmul weights are cast to the model dtype first, as the
    engine serves them (``transformer.prepare_params``)."""
    from nnstreamer_tpu_torch.parallel import serve as _serve

    if pipelined:
        raise not_ported("pipelined parameter placement (pp)", _TRAINING)
    specs = transformer_param_specs(cfg)
    specs = {k: P(*(a if a in mesh.axis_names else None for a in s))
             for k, s in specs.items()}
    return _serve.place_params(_tf.prepare_params(params, cfg), mesh, specs,
                               label="sharded:transformer")


def lm_loss(apply_fn: Callable, params, tokens):
    raise not_ported("lm_loss", _TRAINING)


def make_train_step(cfg: TransformerConfig, mesh: Mesh,
                    learning_rate: float = 1e-3) -> Callable:
    raise not_ported("make_train_step", _TRAINING)


def make_pp_train_step(cfg: TransformerConfig, mesh: Mesh,
                       num_microbatches: int = 4,
                       learning_rate: float = 1e-3) -> Callable:
    raise not_ported("make_pp_train_step", _TRAINING)
