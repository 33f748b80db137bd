"""Sharding rules for the transformer, its sharded serving steps and its
sharded train steps.

The JAX package's ``parallel/sharded.py`` names a PartitionSpec per
parameter and lets XLA insert the collectives. The port keeps the specs
(:func:`transformer_param_specs`) and runs the shards itself, on the
single-controller mesh of ``parallel/mesh.py``: one thread a device
(:func:`run_ranks`, as ``torch.nn.DataParallel`` drives its devices),
the ranks meeting at explicit collectives of a :class:`Group`, each a
device move or a sum of moved tensors, so that autograd differentiates
the one graph the ranks' threads build together:

- **dp** splits the batch (the engine's decode lanes): each dp rank runs
  the model's step function on its rows, its shard of the cache and its
  copy of the weights.
- **tp** splits heads and the FFN hidden dimension (and the embedding's
  model dimension): the tp ranks meet at the collectives the model's
  layer math calls (``models.transformer.tp_sum``/``tp_gather``): the
  sum of the partial products after ``proj`` and after ``w_out``, the
  gather of the embedding's columns, and the sum of the logits' partial
  products.
- **sp** splits the sequence: each rank holds a contiguous shard of the
  tokens, at its global rotary positions, and the ranks meet in ring
  attention (``parallel/ring.py``); the logits are gathered along the
  sequence.
- **ep** splits the MoE experts: each rank gathers every expert's
  router logits, computes its experts' share of the FFN output, and the
  shares are summed over ep.
- **pp** splits the layer stack into stages (``parallel/pipeline.py``,
  :func:`make_pp_train_step`).

A mesh axis of one device calls no collective. A train step
(:func:`make_train_step`) sums the gradients of every copy of a
parameter slice (a replicated leaf has one copy a rank, and each copy
gets only its rank's share, where GSPMD sums them), updates the slice
once and writes the value to every copy; across processes
(``parallel/multihost.py``) it adds one all-reduce of those sums.
"""

from __future__ import annotations

import contextlib
import threading
from collections import defaultdict
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
    """The serving steps run dp, tp and ep; the engine does not serve a
    sequence (sp) or stage (pp) axis of more than one device."""
    for name in ("sp", "pp"):
        if _mesh_axis(mesh, name):
            raise ValueError(
                f"serving: the engine does not serve a {name} mesh axis "
                "of more than one device (it serves dp, tp and ep)")


# -- collective groups ---------------------------------------------------------
class Group:
    """The ranks of one mesh axis that run together, one thread each,
    meeting at collectives. A collective deposits each rank's tensors,
    waits for all, and gives every rank the result, combined in rank
    order on its own device."""

    def __init__(self, n: int):
        self.size = n
        self._slots: List[Any] = [None] * n
        self._barrier = threading.Barrier(n)

    def _exchange(self, rank: int, x: Any, dev: torch.device) -> List[Any]:
        self._slots[rank] = x
        self._barrier.wait()
        parts = [_move(t, dev) if isinstance(t, torch.Tensor)
                 else tuple(_move(u, dev) for u in t) for t in self._slots]
        self._barrier.wait()  # every rank has read before the next write
        return parts

    def all_reduce(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        parts = self._exchange(rank, x, x.device)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def all_gather(self, rank: int, x: torch.Tensor, dim: int
                   ) -> torch.Tensor:
        return torch.cat(self._exchange(rank, x, x.device), dim=dim)

    def shift(self, rank: int, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The tensors rank ``rank - 1`` (mod the size) gave, on this
        rank's device: ``lax.ppermute`` with ``perm=[(i, i + 1)]``."""
        return self._exchange(rank, xs, xs[0].device)[(rank - 1) % self.size]

    def abort(self) -> None:
        self._barrier.abort()


#: the axes whose ranks meet at collectives inside one step (dp ranks do
#: not: they meet only at the gather of the results and in the gradients)
GROUP_AXES = ("tp", "sp", "ep")


def rank_groups(coords: Sequence[Dict[str, int]]
                ) -> List[Dict[str, Tuple[Group, int]]]:
    """For ranks at mesh ``coords``, each rank's ``{axis: (group, rank)}``
    on every axis of :data:`GROUP_AXES` where more than one of them share
    every other coordinate; the rank in the group is the coordinate."""
    out: List[Dict[str, Tuple[Group, int]]] = [{} for _ in coords]
    for axis in GROUP_AXES:
        buckets: Dict[tuple, List[int]] = defaultdict(list)
        for i, c in enumerate(coords):
            if axis in c:
                buckets[tuple(sorted((a, v) for a, v in c.items()
                                     if a != axis))].append(i)
        for members in buckets.values():
            if len(members) > 1:
                group = Group(len(members))
                for i in members:
                    out[i][axis] = (group, coords[i][axis])
    return out


def run_ranks(devices: Sequence[torch.device],
              groups: Sequence[Dict[str, Tuple[Group, int]]],
              fn: Callable[[int], Any]) -> List[Any]:
    """``fn(i)`` for each rank ``i`` on ``devices[i]`` with its collective
    ``groups[i]``: in the calling thread for one rank (no collective:
    the model's layer math then runs as on one device), else one thread
    a rank. Returns the ranks' results in order; the first failure is
    raised after every rank ended (a failing rank aborts every group of
    the run, so no rank waits forever)."""
    if len(devices) == 1 and not groups[0]:
        return [fn(0)]
    every = {id(g): g for gs in groups for g, _ in gs.values()}
    results: List[Any] = [None] * len(devices)
    errors: List[BaseException] = []
    # autograd modes are per thread: the ranks run in the caller's
    inference = torch.is_inference_mode_enabled()
    grad = torch.is_grad_enabled()

    def body(rank):
        try:
            with _tf.mesh_ranks(groups[rank]), _on_device(devices[rank]), \
                    torch.inference_mode(inference), \
                    torch.set_grad_enabled(grad):
                results[rank] = fn(rank)
        except threading.BrokenBarrierError as e:
            errors.append(e)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.insert(0, e)
            for g in every.values():
                g.abort()

    threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                name=f"mesh-rank-{r}")
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
    """The transformer's serving steps on a dp × tp × ep mesh.

    ``params`` are :func:`transformer_param_specs` placements
    (``serve.place_params``); the engine's monolithic cache is sharded
    slots over dp and heads over tp (``[L, 2, B, S, h, dh]`` leaves:
    spec ``(None, None, dp, None, tp)``); the paged arena blocks over dp
    and heads over tp (``[L, NTOT + 1, 2, T, h, dh]``: ``(None, dp,
    None, None, tp)``). Both are replicated over ep: each ep rank holds
    its own copy and writes the same values into it. A batch-1 cache
    (prefill, chunked prefill, the prefix cache) is one plain tensor per
    leaf on the mesh's first device, as the JAX engine's batch-1 cache
    is unsharded; each tp rank of the first ep rank reads and writes its
    heads of it, the other ep ranks a private copy.

    Each method is the matching ``models.transformer.build_*`` step
    function with the same arguments and results, run shard by shard: the
    rows of dp rank d on d's devices, the heads of tp rank t on t's, the
    experts of ep rank e on e's (the MoE layer's expert exchange,
    ``transformer._moe_ffn``). On a mesh of one device every shard is the
    whole tensor (a view), so the step runs exactly as unsharded and a
    CUDA graph captures it as one.

    The paged steps run every row against one block-gathered arena per
    (tp, ep) rank, on the dp-0 device of that rank (a stream's table may
    name blocks of any dp shard), and write the blocks back to their
    shards: the arena is placed over dp, its compute is not split by dp.
    """

    def __init__(self, cfg: TransformerConfig, mesh: Mesh, fns: Dict[str,
                 Callable]):
        _check_axes(mesh)
        check_experts(cfg, mesh)
        self.cfg = cfg
        self.mesh = mesh
        self.dp = mesh.shape.get("dp", 1)
        self.tp = mesh.shape.get("tp", 1)
        self.ep = mesh.shape.get("ep", 1)
        coords = mesh.coords()
        flat = {(c.get("dp", 0), c.get("tp", 0), c.get("ep", 0)): i
                for i, c in enumerate(coords)
                if all(c[a] == 0 for a in c if a not in ("dp", "tp", "ep"))}
        #: flat device index of (dp rank, tp rank, ep rank)
        self._idx = flat
        self._devs = [d.device for d in mesh.device_list()]
        self._fns = fns
        h = cfg.n_heads
        self._heads = [(t * h // self.tp, (t + 1) * h // self.tp)
                       for t in range(self.tp)]
        #: the (tp, ep) ranks of one dp rank, in the order they run
        self._cols = [(t, e) for t in range(self.tp) for e in range(self.ep)]
        self._col_coords = [{"tp": t, "ep": e} for t, e in self._cols]

    @property
    def device(self) -> torch.device:
        """The controller's device: where results gather."""
        return self._devs[0]

    def _dev(self, d: int, t: int, e: int = 0) -> torch.device:
        return self._devs[self._idx[(d, t, e)]]

    def _local_params(self, params: Dict[str, Any], d: int, t: int,
                      e: int = 0) -> Dict[str, torch.Tensor]:
        i = self._idx[(d, t, e)]
        return {k: (v.shards[i] if isinstance(v, ShardedTensor) else v)
                for k, v in params.items()}

    def _local_cache(self, cache: KVCache, d: int, t: int, e: int = 0
                     ) -> KVCache:
        i = self._idx[(d, t, e)]
        return KVCache(*(leaf.shards[i] for leaf in cache.leaves()))

    def _run(self, d: int, fn: Callable[[int, int], Any]) -> List[Any]:
        """``fn(t, e)`` for each (tp, ep) rank of dp rank ``d``, meeting at
        the tp and ep collectives; results in :attr:`_cols` order (the
        first is tp rank 0's of ep rank 0)."""
        return run_ranks([self._dev(d, t, e) for t, e in self._cols],
                         rank_groups(self._col_coords),
                         lambda k: fn(*self._cols[k]))

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
    def _head_slices(self, cache1: KVCache, t: int, dev: torch.device,
                     private: bool = False):
        """tp rank ``t``'s heads of a plain batch-1 cache, on ``dev``;
        written back when they had to be copied there. ``private``: a copy
        that is never written back (an ep rank past the first, whose
        writes equal the first's)."""
        lo, hi = self._heads[t]
        if private:
            yield KVCache(*(_move(leaf.narrow(4, lo, hi - lo), dev).clone()
                            for leaf in cache1.leaves()))
            return
        parts = [_narrow_view(leaf, 4, lo, hi, dev)
                 for leaf in cache1.leaves()]
        yield KVCache(*(p for p, _ in parts))
        for leaf, (p, copied) in zip(cache1.leaves(), parts):
            if copied:
                leaf.narrow(4, lo, hi - lo).copy_(p)

    def prefill(self, params, tokens, lengths=None):
        """``build_prefill``'s step on dp rank 0's (tp, ep) ranks: the
        logits and a plain batch-1 cache on the first device (heads
        gathered)."""
        def rank(t, e):
            dev = self._dev(0, t, e)
            return self._fns["prefill"](self._local_params(params, 0, t, e),
                                        _move(tokens, dev), lengths)

        outs = self._run(0, rank)
        logits = outs[0][0]
        if len(outs) == 1:
            return logits, outs[0][1]
        heads = [o[1] for o, (_, e) in zip(outs, self._cols) if e == 0]
        leaves = zip(*(c.leaves() for c in heads))
        cache = KVCache(*(torch.cat([_move(x, self.device) for x in ls], dim=4)
                          for ls in leaves))
        return logits, cache

    def chunk(self, params, tokens, cache1, pos0):
        """``build_chunk_decode``'s step on a plain batch-1 cache."""
        def rank(t, e):
            dev = self._dev(0, t, e)
            with self._head_slices(cache1, t, dev, private=e > 0) as local:
                logits, _ = self._fns["chunk"](
                    self._local_params(params, 0, t, e), _move(tokens, dev),
                    local, _move(pos0, dev)
                    if isinstance(pos0, torch.Tensor) else pos0)
            return logits

        return self._run(0, rank)[0], cache1

    # -- the engine's sharded cache ----------------------------------------
    def decode(self, params, token, cache, pos):
        """``build_decode_step``'s step: each dp rank its rows and its
        cache shard."""
        outs = []
        for d in range(self.dp):
            rows = self._rows(token.shape[0], d)

            def rank(t, e, d=d, rows=rows):
                dev = self._dev(d, t, e)
                logits, _ = self._fns["decode"](
                    self._local_params(params, d, t, e),
                    self._to(token, rows, dev),
                    self._local_cache(cache, d, t, e),
                    self._to(pos, rows, dev))
                return logits

            outs.append(self._run(d, rank)[0])
        return self._gather_rows(outs), cache

    def write_slot(self, cache, slot: int, cache1: KVCache) -> None:
        """Copy a batch-1 cache into batch slot ``slot`` of the sharded
        cache: the slot's dp rank, each tp rank its heads, in every ep
        rank's copy."""
        per = cache.leaves()[0].shape[2] // self.dp
        d, local = divmod(int(slot), per)
        for leaf, src in zip(cache.leaves(), cache1.leaves()):
            for t, e in self._cols:
                lo, hi = self._heads[t]
                dst = leaf.shards[self._idx[(d, t, e)]]
                dst[:, :, local].copy_(src[:, :, 0].narrow(3, lo, hi - lo))

    # -- the paged arena ----------------------------------------------------
    @contextlib.contextmanager
    def blocks(self, arena: KVCache, t: int, e: int = 0):
        """(tp ``t``, ep ``e``) rank's arena with every dp shard's blocks
        in order, on its dp-0 device: the shard itself under dp1, else a
        gathered copy whose block ranges are written back to their shards
        after."""
        parts = [[leaf.shards[self._idx[(d, t, e)]] for d in range(self.dp)]
                 for leaf in arena.leaves()]
        if self.dp == 1:
            yield KVCache(*(p[0] for p in parts))
            return
        dev = self._dev(0, t, e)
        full = [torch.cat([_move(x, dev) for x in p], dim=1) for p in parts]
        yield KVCache(*full)
        for p, f in zip(parts, full):
            off = 0
            for x in p:
                n = x.shape[1]
                x.copy_(f.narrow(1, off, n))
                off += n

    def _paged(self, name, params, tokens, arena, rest):
        """``name``'s step ``(params, tokens, arena, *rest)`` on each
        (tp, ep) rank's block-gathered arena."""
        def rank(t, e):
            dev = self._dev(0, t, e)
            moved = [_move(a, dev) if isinstance(a, torch.Tensor) else a
                     for a in rest]
            with self.blocks(arena, t, e) as local:
                logits, _ = self._fns[name](
                    self._local_params(params, 0, t, e), _move(tokens, dev),
                    local, *moved)
            return logits

        return self._run(0, rank)[0], arena

    def paged_decode(self, params, token, arena, bt, pos):
        return self._paged("paged_decode", params, token, arena, (bt, pos))

    def paged_chunk(self, params, tokens, arena, bt, pos0, limit):
        return self._paged("paged_chunk", params, tokens, arena,
                           (bt, pos0, limit))

    def scatter_prefill(self, arena: KVCache, cache1: KVCache,
                        apply: Callable[[KVCache, KVCache], None]) -> None:
        """``apply(arena_view, cache1_heads)`` for each (tp, ep) rank on
        its block-gathered arena and its heads of a plain batch-1
        cache."""
        for t, e in self._cols:
            dev = self._dev(0, t, e)
            with self.blocks(arena, t, e) as local, \
                    self._head_slices(cache1, t, dev) as heads:
                apply(local, heads)

    def each_arena(self, arena: KVCache, apply: Callable[[KVCache], None]
                   ) -> None:
        """``apply(arena_view)`` for each (tp, ep) rank's block-gathered
        arena."""
        for t, e in self._cols:
            with self.blocks(arena, t, e) as local:
                apply(local)


def _local(params: Dict[str, Any], i: int, dev: torch.device
           ) -> Dict[str, torch.Tensor]:
    """Flat mesh device ``i``'s parameters: its shard of each sharded
    one, a plain tensor on ``dev``."""
    return {k: (v.shards[i] if isinstance(v, ShardedTensor)
                else _move(v, dev)) for k, v in params.items()}


def _split(n: int, parts: int, k: int) -> slice:
    """Part ``k`` of ``n`` split evenly ``parts`` ways."""
    return slice(k * n // parts, (k + 1) * n // parts)


def check_experts(cfg: TransformerConfig, mesh: Mesh) -> None:
    """An ep axis of more than one device must split the experts
    evenly."""
    ep = mesh.shape.get("ep", 1)
    if cfg.num_experts and ep > 1 and cfg.num_experts % ep:
        raise ValueError(f"num_experts ({cfg.num_experts}) must divide by "
                         f"mesh axis 'ep' ({ep})")


def _seq_parts(mesh: Mesh, s: int) -> int:
    sp = mesh.shape.get("sp", 1)
    if s % sp:
        raise ValueError(f"sequence length {s} does not divide by the sp "
                         f"mesh axis ({sp})")
    return sp


def make_sharded_forward(cfg: TransformerConfig, mesh: Mesh) -> Callable:
    """``apply_fn(params, tokens) -> logits`` over ``mesh``: params placed
    per :func:`transformer_param_specs` (``shard_params``), the batch
    over dp (replicated when it does not divide), heads and the FFN over
    tp, experts over ep, and the sequence over sp with ring attention
    (each sp rank at its global rotary positions). The logits gather on
    the mesh's first device. A pp axis replicates: its first stage
    computes."""
    from nnstreamer_tpu_torch.parallel.ring import ring_attention

    check_experts(cfg, mesh)
    sp_on = _mesh_axis(mesh, "sp")
    fwd = build_forward(cfg, attention_fn=ring_attention if sp_on else None)
    coords = mesh.coords()
    devs = [d.device for d in mesh.device_list()]

    def apply_fn(params, tokens, position_offset=0):
        tokens = torch.as_tensor(tokens)
        b, s = tokens.shape
        sp = _seq_parts(mesh, s)
        dp = mesh.shape.get("dp", 1)
        dp = dp if b % dp == 0 else 1
        run = [i for i, c in enumerate(coords) if c.get("pp", 0) == 0
               and c.get("dp", 0) < dp]

        def rank(k):
            i = run[k]
            c = coords[i]
            j = c.get("sp", 0)
            seq = _split(s, sp, j)
            return fwd(_local(params, i, devs[i]),
                       _move(tokens[_split(b, dp, c.get("dp", 0)), seq],
                             devs[i]), position_offset + seq.start)

        outs = run_ranks([devs[i] for i in run],
                         rank_groups([coords[i] for i in run]), rank)
        return _assemble(mesh, [coords[i] for i in run], outs, dp, sp,
                         devs[0], seq_dim=1)

    return apply_fn


def _assemble(mesh: Mesh, coords: Sequence[Dict[str, int]],
              outs: Sequence[torch.Tensor], dp: int, sp: int,
              dev: torch.device, seq_dim: int) -> torch.Tensor:
    """The ranks' outputs at ``coords`` as one tensor on ``dev``: the
    first tp and ep rank's (every one holds the same), rows over dp
    along dimension ``seq_dim - 1`` and the sequence over sp along
    ``seq_dim``."""
    part = {}
    for c, o in zip(coords, outs):
        if c.get("tp", 0) == 0 and c.get("ep", 0) == 0:
            part[(c.get("dp", 0), c.get("sp", 0))] = o
    if len(part) == 1:
        return _move(next(iter(part.values())), dev)
    rows = [torch.cat([_move(part[(d, j)], dev) for j in range(sp)],
                      dim=seq_dim) for d in range(dp)]
    return torch.cat(rows, dim=seq_dim - 1)


def shard_params(params, mesh: Mesh, cfg: TransformerConfig,
                 pipelined: bool = False):
    """Rule-sharded param placement, routed through the serving plane's
    :func:`~nnstreamer_tpu_torch.parallel.serve.place_params` so the
    per-shard bytes register with the budget accountant whenever one is
    active. ``pipelined``: the layer axis over pp
    (:func:`~nnstreamer_tpu_torch.parallel.pipeline.pipeline_param_specs`,
    each stage its contiguous layers). The params are placed as given, as
    in the JAX package: the master weights a train step updates (each
    matmul casts its weight to the model dtype). On a mesh of one device
    each shard is the tensor given, and a train step updates it in
    place."""
    from nnstreamer_tpu_torch.parallel import serve as _serve

    if pipelined:
        from nnstreamer_tpu_torch.parallel.pipeline import (
            pipeline_param_specs,
        )

        specs = pipeline_param_specs(cfg)
    else:
        specs = transformer_param_specs(cfg)
    specs = {k: P(*(a if a in mesh.axis_names else None for a in s))
             for k, s in specs.items()}
    return _serve.place_params(params, mesh, specs,
                               label="sharded:transformer")


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token negative log-likelihood, log-softmax in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    targets = _move(targets, logp.device).long()
    return -torch.gather(logp, -1, targets[..., None]).mean()


def lm_loss(apply_fn: Callable, params, tokens) -> torch.Tensor:
    """Next-token cross-entropy (fp32 logits): the logits of every
    position but the last against the tokens that follow, averaged over
    the whole batch (under sp, on the gathered logits)."""
    tokens = torch.as_tensor(tokens)
    return _nll(apply_fn(params, tokens)[:, :-1], tokens[:, 1:])


# -- the train steps -------------------------------------------------------------
def _leaves(params: Dict[str, Any]) -> Dict[str, Any]:
    """``params`` with each tensor (each shard) as a fresh autograd leaf
    sharing its storage."""
    def leaf(t):
        return t.detach().requires_grad_(True)

    return {k: (ShardedTensor([leaf(t) for t in v.shards], v.sharding,
                              v.shape)
                if isinstance(v, ShardedTensor) else leaf(v))
            for k, v in params.items()}


def _copies(st: ShardedTensor) -> List[List[int]]:
    """The flat indices of the shards that hold each slice of ``st``, in
    rank order."""
    groups: Dict[tuple, List[int]] = {}
    for i, sl in enumerate(st.sharding.local_slices(st.shape)):
        groups.setdefault(tuple((x.start, x.stop) for x in sl), []).append(i)
    return list(groups.values())


def _grad_sum(leaves: Sequence[torch.Tensor], dev: torch.device
              ) -> torch.Tensor:
    """The sum of the leaves' gradients on ``dev``, in rank order (a leaf
    no rank's result reached has none)."""
    out = None
    for t in leaves:
        if t.grad is not None:
            g = _move(t.grad, dev)
            out = g if out is None else out + g
    return out if out is not None else torch.zeros_like(leaves[0],
                                                        device=dev)


def _sgd(params: Dict[str, Any], leaves: Dict[str, Any],
         loss: torch.Tensor, lr: float) -> torch.Tensor:
    """``p - lr * g`` in place on every copy of every parameter slice,
    ``g`` the sum of the slice's copies' gradients (averaged over the
    processes of a multi-process run, with the loss). Returns the loss."""
    from nnstreamer_tpu_torch.parallel import multihost

    with torch.no_grad():
        sums = []   # (tensors to write, summed gradient)
        for k, p in params.items():
            lf = leaves[k]
            if isinstance(p, ShardedTensor):
                for idx in _copies(p):
                    dev = p.shards[idx[0]].device
                    sums.append(([p.shards[i] for i in idx],
                                 _grad_sum([lf.shards[i] for i in idx], dev)))
            else:
                sums.append(([p], _grad_sum([lf], p.device)))
        loss = loss.detach()
        grads = multihost.dp_mean([g for _, g in sums] + [loss])
        for (dsts, _), g in zip(sums, grads):
            new = dsts[0] - g * lr
            for t in dsts:
                t.copy_(_move(new, t.device))
        return grads[-1]


def _train_step(loss_fn: Callable, learning_rate: float) -> Callable:
    def step(params, tokens):
        leaves = _leaves(params)
        with torch.enable_grad():
            loss = loss_fn(leaves, tokens)
            loss.backward()
        return params, _sgd(params, leaves, loss, learning_rate)

    return step


def make_train_step(cfg: TransformerConfig, mesh: Mesh,
                    learning_rate: float = 1e-3) -> Callable:
    """One SGD step, fully sharded: params per ``transformer_param_specs``
    (``shard_params``), the batch over dp, the sequence over sp. Returns
    ``step(params, tokens) -> (params, loss)``; the params are updated in
    place (the counterpart of ``donate_argnums=(0,)``) and the loss is
    the mean over the whole global batch, a 0-d tensor on the mesh's
    first device."""
    apply_fn = make_sharded_forward(cfg, mesh)
    return _train_step(lambda p, t: lm_loss(apply_fn, p, t), learning_rate)


def make_pp_train_step(cfg: TransformerConfig, mesh: Mesh,
                       num_microbatches: int = 4,
                       learning_rate: float = 1e-3) -> Callable:
    """One SGD step with the block stack **pipeline-parallel** over mesh
    axis ``pp`` (the microbatched GPipe schedule of
    ``parallel/pipeline.py``), composed with tp, ep, sp (ring attention
    inside each stage) and dp (the microbatch rows).

    ``tokens`` are ``[num_microbatches, mb_batch, seq]``; the microbatch
    axis is the pipeline's time axis, ``mb_batch`` splits over dp,
    ``seq`` over sp. Params per ``shard_params(..., pipelined=True)``.
    Returns ``step(params, tokens) -> (params, loss)`` as
    :func:`make_train_step`."""
    from nnstreamer_tpu_torch.parallel.pipeline import build_pipelined_forward

    apply_fn = build_pipelined_forward(cfg, mesh, num_microbatches)

    def loss_fn(params, tokens):
        tokens = torch.as_tensor(tokens)
        return _nll(apply_fn(params, tokens)[:, :, :-1], tokens[:, :, 1:])

    return _train_step(loss_fn, learning_rate)
