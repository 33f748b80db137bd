"""Continuous-batching decode engine, on the card.

The JAX package's ``serving/engine.py`` on its single-chip, greedy path:

- **One batched decode.** ``max_streams`` batch slots share one KV cache
  ``[L, 2, B, S, h, dh]`` (``models.transformer.KVCache``: int8 values
  with per-vector scales under ``kv_quant="int8"``), preallocated once
  and updated in place by the prefill insert and every decode step.
  Empty slots decode garbage that the host ignores; shapes never change
  as streams come and go.
- **The K-step dispatch as one program.** Each dispatch runs
  ``steps_per_dispatch`` (K) decode steps and yields a ``[B, K]`` token
  block. Where the JAX engine jits the K steps under ``lax.scan``, this
  one captures them on the card as one CUDA graph per (B, K)
  (:class:`_DecodeProgram`) and replays it for every dispatch: one graph
  launch where the steps' kernels would each be a launch from Python.
  The last token and the advanced positions stay in the program's static
  buffers and feed the next replay; the block goes to pinned host memory
  behind a CUDA event and is processed one block behind, so the host's
  fetch overlaps the next block's compute. On the CPU the program runs
  its body, the same eager loop, on the same static buffers.
- **Bucketed prefill.** Prompts are right-padded to power-of-two buckets
  (16, 32, ...); logits come from the true last position, and the pad
  k/v is unreachable before decode overwrites it. Prefill attention is
  kernel B2 (``ops/flash_attention.py``) unless ``attention="reference"``,
  run eagerly: B2 encodes its TMA tensor maps from each call's
  addresses. Decode and the chunk program attend over dynamically placed
  cache slots with the plain masked form (``_attend_cache``), as the JAX
  package leaves it to XLA.
- **Chunked prefill** (``prefill_chunk``): a prompt ingests in chunks of
  C tokens through the chunk program (``build_chunk_decode`` at ``[1,
  C]``, eager), one chunk per loop iteration between decode dispatches;
  its batch slot is reserved meanwhile.
- **Prefix cache** (``prefix_cache``): the KV of the last N admitted
  prompts stays on the card; a prompt that shares a prefix with one of
  them prefills only the remainder through the chunk program, and an
  exact repeat none. Under the HBM accountant (``tensors/memory.py``)
  each monolithic entry is a droppable ``kvcache`` unit: the evict rung
  revokes it and the engine thread drops it (:meth:`_reap_condemned`).
- **The paged KV cache** (``block_tokens`` > 0, ``serving/kvpool.py``):
  the cache becomes fixed-size blocks of one preallocated arena with a
  block table per stream, and admission is bounded by free blocks, not
  batch slots: more streams than lanes time-share the B decode lanes
  under per-token EDF deadlines (``scheduler.token_deadline``), a shared
  prompt prefix costs its blocks once (copy-on-write), and block
  exhaustion walks the evict → defer → shed ladder. The paged K-step
  dispatch is the same one graph per (B, K), with the block table one
  more static ``[B, MB]`` buffer loaded before each replay; the paged
  loop is synchronous, as the JAX engine's is, because the next block
  table depends on what the host emitted.
- **Speculative decoding** (``speculate`` = γ > 0, greedy only): a
  ``speculate_layers``-deep prefix slice of the target
  (``models/speculative.py``) drafts γ tokens, the target verifies the
  γ+1 positions in one chunk pass, and each stream emits the accepted
  prefix plus the target's own next token — exactly the greedy tokens.
  On the card each round (γ draft steps, the target chunk, the accept,
  the draft fix-up) is one CUDA graph per (B, γ) over static buffers
  (:class:`_SpecRoundProgram`); the host reads the ``[B, γ+1]`` tokens,
  their logprobs and ``n_emit``. Both cache modes.
- **Sampled decoding** (``temperature`` > 0, with ``top_k`` and
  ``min_p``): :func:`~nnstreamer_tpu_torch.models.transformer.make_sampler`
  on every path. A stream's draws are keyed by (``seed``, stream id) at
  the position of the token being drawn, so they do not depend on the
  streams beside it, on K, or on how its prompt was prefilled (monolithic
  or paged, chunked, the prefix cache). The first token samples at
  admission; the K-step dispatch draws its K uniforms a lane in one
  Philox call inside the same captured graph, from a static per-lane key
  buffer that :meth:`_LaneProgram.load` fills beside ``token`` and
  ``pos``. Greedy (``temperature <= 0``) is argmax, as before.
- **Request-path SLO admission.** With ``slo_budget_ms`` > 0 the engine
  owns an :class:`~nnstreamer_tpu_torch.serving.scheduler.SloScheduler`:
  ``submit()`` raises ``SloRejected`` when the request's deadline cannot
  be met behind the queued and active requests at the current
  per-request service estimate (cold: everything is admitted), and each
  finished request's submit-to-finish time feeds the estimate. The paged
  engine's streams carry its budget as their deadline.

- **Serving mesh** (``mesh``, a ``parallel.mesh.Mesh``): the params are
  placed per ``parallel.sharded.transformer_param_specs`` (heads and the
  FFN over ``tp``; axes the mesh lacks pruned to replicated), the cache
  shards batch slots over ``dp`` and heads over ``tp``, the paged arena
  blocks over ``dp`` (its block count padded to divide) and heads over
  ``tp``; ``parallel.sharded.ShardedLM`` runs each step shard by shard.
  Prefill keeps plain attention, as the JAX engine keeps XLA attention
  under a mesh. ``speculate`` raises under a mesh. On one card the
  K-step dispatch stays one captured graph per (B, K); a mesh of several
  cards dispatches eagerly.

Under the HBM accountant the paged pool
registers its arena under ``kvcache``, a dropped paged prefix entry
counts ``nns_mem_pressure_events_total{rung="evict"}`` and a shed stream
``{rung="shed"}``. :meth:`ContinuousBatchingEngine.close` stops the
engine and unregisters every byte it registered.
"""

from __future__ import annotations

import collections
import itertools
import queue as _queue
import threading
import time as _time
import weakref
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from nnstreamer_tpu_torch.device import resolve_device
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.models.transformer import (
    KVCache,
    philox_uniforms,
    sampling_key,
)
from nnstreamer_tpu_torch.ops import _counts

log = get_logger("serving")


class GenerationStream:
    """Handle for one submitted prompt: iterate to receive token ids as
    they are generated; ``None``-terminated internally."""

    _DONE = object()

    def __init__(self, stream_id: int, prompt_len: int):
        self.stream_id = stream_id
        self.prompt_len = prompt_len
        self.tokens: List[int] = []  # generated so far (post-prompt)
        #: chosen-token log-probabilities (the model's own fp32
        #: log_softmax), parallel to ``tokens``
        self.logprobs: List[float] = []
        self.finished = False
        self.finish_reason: Optional[str] = None  # "eos"|"length"|...
        self.cancelled = False
        self._q: _queue.Queue = _queue.Queue()

    def cancel(self) -> None:
        """Request cancellation (client gone, timeout, user abort): the
        engine frees this stream's batch slot at the next block boundary
        and finishes it with reason "cancelled". Pending (not yet
        admitted) streams are dropped without prefilling. Safe from any
        thread; idempotent; a no-op once finished."""
        self.cancelled = True

    def __iter__(self) -> Iterator[int]:
        while True:
            item = self._q.get()
            if item is self._DONE:
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the stream finishes; returns all generated ids."""
        out = []
        deadline = None if timeout is None else _time.monotonic() + timeout
        while True:
            t = None if deadline is None else max(
                0.0, deadline - _time.monotonic())
            try:
                item = self._q.get(timeout=t)
            except _queue.Empty:
                raise TimeoutError(
                    f"stream {self.stream_id}: no token within {timeout}s")
            if item is self._DONE:
                return out
            out.append(item)

    # engine-side
    def _emit(self, tok: int, logprob: float = 0.0):
        self.tokens.append(tok)
        self.logprobs.append(logprob)
        self._q.put(tok)

    def _finish(self, reason: str):
        if self.finished:
            return  # idempotent: cancel/stop/EOS may race benignly
        self.finished = True
        self.finish_reason = reason
        self._q.put(self._DONE)




class _PrefixTrie:
    """Token trie over the prefix-cache keys: longest-common-prefix lookup
    in O(prompt_len), independent of entry count (a copy of the JAX
    engine's).

    Each node counts the entries in its subtree and keeps a representative
    one (``rep``), so a lookup never descends below the walk: every entry
    in the deepest walkable node's subtree shares exactly the walked
    tokens with the prompt, i.e. all tie at the maximal LCP.
    """

    __slots__ = ("root",)

    @staticmethod
    def _node():
        return {"kids": {}, "entry": None, "count": 0, "rep": None}

    def __init__(self):
        self.root = self._node()

    def insert(self, key: tuple) -> None:
        node = self.root
        node["count"] += 1
        node["rep"] = key
        for tok in key:
            node = node["kids"].setdefault(tok, self._node())
            node["count"] += 1
            node["rep"] = key
        node["entry"] = key

    def remove(self, key: tuple) -> None:
        path = [self.root]
        node = self.root
        for tok in key:
            node = node["kids"][tok]
            path.append(node)
        node["entry"] = None
        for n in path:
            n["count"] -= 1
        # prune empty nodes; repair representatives that pointed at key
        for i in range(len(path) - 1, 0, -1):
            parent, child = path[i - 1], path[i]
            if child["count"] == 0:
                del parent["kids"][key[i - 1]]
        for n in path:
            if n["count"] > 0 and n["rep"] == key:
                n["rep"] = self._any_entry(n)

    @staticmethod
    def _any_entry(node):
        while node["entry"] is None:
            node = next(k for k in node["kids"].values() if k["count"] > 0)
        return node["entry"]

    def lookup(self, prompt) -> tuple:
        """→ (best_key, lcp): a cached key maximizing LCP with ``prompt``
        (an exact whole-prompt entry preferred), or (None, 0)."""
        node = self.root
        d = 0
        for tok in prompt:
            child = node["kids"].get(int(tok))
            if child is None:
                break
            node = child
            d += 1
        if d == 0 or node["count"] == 0:
            return None, 0
        if d == len(prompt) and node["entry"] is not None:
            return node["entry"], d  # exact match carries reusable logits
        return node["rep"], d


class _LaneProgram(_counts.GraphProgram):
    """A program over the engine's lanes: the static inputs every lane
    program reads, ``token [B]``, ``pos [B]`` and each lane's packed
    Philox key ``key [B]`` (read by the sampled dispatch; on the paged
    engine also the block table ``bt [B, MB]``), and :meth:`load`, which
    copies the host mirrors into them. A subclass allocates its outputs
    and defines the body.

    Captured (``_counts.GraphProgram``), every :meth:`run` is one replay,
    which reads the engine's cache (or arena) and parameters where they
    were at the capture. Without a capture (the CPU) a run executes the
    body."""

    def __init__(self, engine: "ContinuousBatchingEngine"):
        super().__init__(engine.device)
        self.engine = engine
        B, dev = engine.B, engine.device
        self.token = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((B,), dtype=torch.int64, device=dev)
        self.key = torch.zeros((B,), dtype=torch.int64, device=dev)
        #: the paged engine's block tables (all sentinel: every write of
        #: an unloaded program lands in the arena's trash block)
        self.bt = torch.full((B, engine.MB), engine._pool.SENTINEL,
                             dtype=torch.int64, device=dev) \
            if engine.paged else None

    def load(self, last: np.ndarray, pos: np.ndarray,
             bt: Optional[np.ndarray] = None,
             key: Optional[np.ndarray] = None) -> None:
        """Copy host arrays in, each through a fresh pinned staging copy on
        the current stream, ordered before the next run: the host mirrors
        may change as soon as this returns."""
        up = self.engine._upload
        self.token.copy_(up(last))
        self.pos.copy_(up(pos))
        if bt is not None:
            self.bt.copy_(up(bt))
        if key is not None:
            self.key.copy_(up(key))


class _DecodeProgram(_LaneProgram):
    """The engine's K-step dispatch. ``token`` and ``pos`` feed the first
    step (the block table is constant over the K steps). The body is the
    engine's eager :meth:`ContinuousBatchingEngine._dispatch` loop; it
    leaves the ``[B, K]`` tokens and logprobs in ``toks`` and ``lps`` and,
    as its last op, writes the advanced token and positions back into
    ``token`` and ``pos``, so the next run chains off them with no host
    step. :meth:`load` runs after an admission or a recovery (the paged
    loop before every dispatch)."""

    def __init__(self, engine: "ContinuousBatchingEngine"):
        super().__init__(engine)
        self.K = engine.K
        B, dev = engine.B, engine.device
        self.toks = torch.zeros((B, self.K), dtype=torch.int32, device=dev)
        self.lps = torch.zeros((B, self.K), dtype=torch.float32, device=dev)

    def body(self) -> None:
        toks, lps, last, pos = self.engine._dispatch(self.token, self.pos,
                                                     self.bt, self.key)
        self.toks.copy_(toks)
        self.lps.copy_(lps)
        self.token.copy_(last)
        self.pos.copy_(pos)


class _SpecRoundProgram(_LaneProgram):
    """One speculative round for every lane: the ``[B, γ+1]`` verified
    tokens ``tgt`` and their logprobs ``lps`` and the per-lane emit count
    ``n_emit [B]`` out. The body is
    :meth:`ContinuousBatchingEngine._spec_round`: γ draft steps, one
    target chunk of γ+1, the accept and the draft fix-up, all on the
    device (the accept count stays there). Captured once per (B, γ) on
    the card; the body on the CPU."""

    def __init__(self, engine: "ContinuousBatchingEngine"):
        super().__init__(engine)
        self.gamma = engine.speculate
        B, dev, g = engine.B, engine.device, engine.speculate
        self.tgt = torch.zeros((B, g + 1), dtype=torch.int32, device=dev)
        self.lps = torch.zeros((B, g + 1), dtype=torch.float32, device=dev)
        self.n_emit = torch.zeros((B,), dtype=torch.int64, device=dev)

    def body(self) -> None:
        tgt, lps, n_emit = self.engine._spec_round(self.token, self.pos,
                                                   self.bt)
        self.tgt.copy_(tgt)
        self.lps.copy_(lps)
        self.n_emit.copy_(n_emit)


class _PendingRequest:
    def __init__(self, prompt: np.ndarray, max_new: int,
                 stream: GenerationStream):
        self.prompt = prompt
        self.max_new = max_new
        self.stream = stream
        self.submit_t = _time.monotonic()  # → queue-wait histogram


class ContinuousBatchingEngine:
    """Batched multi-stream generation over one transformer model.

    Parameters
    ----------
    cfg, params: a ``models.transformer`` config and its parameter dict
        (fp32 masters, e.g. ``init_params``); the matmul weights are cast
        to ``cfg.dtype`` once and everything moves to ``device``.
    max_streams: batch slots (B). Static — sizes the cache.
    max_seq: cache length S (defaults to ``cfg.max_seq``).
    steps_per_dispatch: decode steps per dispatch (K), or "auto" —
        start() measures the host↔device round trip and the per-step
        decode time of the captured program and picks K so the fixed cost
        is at most ~20% of a block (see _calibrate_k).
    eos_id: generation stops when the model emits this id (None → length
        -bounded only).
    min_bucket: smallest prefill padding bucket.
    prefill_chunk: when set, prompts ingest in chunks of this many tokens,
        one chunk per engine-loop iteration, interleaved with decode
        dispatches. Requires ``0 < prefill_chunk < max_seq`` and a prompt
        whose last chunk fits the cache: ``ceil(n / C) * C <= max_seq``.
    kv_quant: ``"int8"`` stores the KV cache quantized (per-vector absmax
        scales, ``models.transformer._Int8KVCodec``): about half the
        cache bytes, at a small, bounded numeric cost.
    prefix_cache: keep the KV of the last N admitted prompts on the card
        (LRU) and prefill only what a new prompt adds to the longest
        common prefix with one of them. 0 (default) disables.
    attention: prefill attention: "auto" (kernel B2 for CUDA tensors; on
        the card a head_dim the kernel does not take raises here) or
        "reference" (the plain version).
    block_tokens: > 0 turns the paged KV cache on (``serving/kvpool.py``;
        it must divide ``max_seq``); 0 (default) or ``NNSTPU_PAGED_KV=0``
        keeps the monolithic cache.
    kv_blocks: arena size in blocks (paged mode); defaults to
        ``max_streams * max_seq / block_tokens``, the monolithic cache's
        bytes (under a mesh padded so the blocks with the zero block
        divide over dp).
    mesh: a ``parallel.mesh.Mesh`` (``parallel.make_mesh``) — serving over
        several devices: params per ``parallel.sharded.
        transformer_param_specs`` (heads and the FFN over ``tp``), the
        cache's slots and the arena's blocks over ``dp``
        (``max_streams`` and ``n_heads`` must divide); plain attention;
        the engine's device is the mesh's first. None: one device.
    temperature, top_k, min_p: sampling (``models.transformer.
        make_sampler``); ``temperature <= 0`` (default) is greedy and
        ignores ``top_k`` and ``min_p``.
    seed: the sampling seed; each stream draws with the Philox key of
        (seed, its stream id), so sampled output is reproducible whatever
        the batch composition.
    speculate: > 0 turns speculative decoding on with that many drafted
        tokens a round (greedy only); ``speculate_layers`` is the draft's
        depth (default half the target's, at least 1). Concurrency is
        capped at ``max_streams``: the draft cache is slot-structured.
    device: where the engine computes; None → the package device
        (``cuda:0`` unless ``set_device`` says otherwise).

    ``mesh`` keeps the JAX engine's signature and raises (see the module
    docstring).
    """

    #: process-wide sequence behind ``obs_name`` (engine0, engine1, ...)
    _OBS_SEQ = itertools.count()

    #: reserves a batch slot while its chunked prefill is in flight
    _RESERVED = object()

    #: minimum common-prefix length worth a warm (remainder-only)
    #: admission; exact whole-prompt hits are never thresholded
    PREFIX_MIN_REUSE = 4

    #: the K-step dispatch and the speculative round run eagerly on a
    #: card too when True: set only by chip_smoke.py and the card's tests,
    #: to compare the captured programs with their bodies (the JAX engine
    #: has no such switch)
    _eager_dispatch = False

    _GREEDY_ONLY = ("serving: speculate requires greedy decoding "
                    "(temperature=0) — draft/verify parity is exact only "
                    "for argmax")

    def __init__(self, cfg, params, max_streams: int = 4,
                 max_seq: Optional[int] = None,
                 steps_per_dispatch: Any = 8,
                 temperature: float = 0.0, top_k: int = 0,
                 min_p: float = 0.0,
                 eos_id: Optional[int] = None, seed: int = 0,
                 min_bucket: int = 16, mesh=None,
                 prefill_chunk: Optional[int] = None,
                 kv_quant: Optional[str] = None,
                 prefix_cache: int = 0,
                 attention: str = "auto",
                 slo_budget_ms: float = 0.0,
                 block_tokens: int = 0,
                 kv_blocks: Optional[int] = None,
                 speculate: int = 0,
                 speculate_layers: Optional[int] = None,
                 device=None):
        from nnstreamer_tpu_torch.models.transformer import (
            build_chunk_decode,
            build_decode_step,
            build_paged_chunk,
            build_paged_decode_step,
            build_prefill,
            init_cache,
            make_sampler,
            prepare_params,
        )
        from nnstreamer_tpu_torch.obs.collectors import (
            register_engine_collector,
        )
        from nnstreamer_tpu_torch.obs.flight import LMTokenStats
        from nnstreamer_tpu_torch.obs.registry import get_registry
        from nnstreamer_tpu_torch.ops.flash_attention import (
            flash_attention,
            kernel_takes,
        )
        from nnstreamer_tpu_torch.serving import kvpool as _kvpool
        from nnstreamer_tpu_torch.utils.stats import InvokeStats

        if attention not in ("auto", "reference"):
            raise ValueError(
                f"serving: attention must be 'auto' or 'reference', got "
                f"{attention!r}")
        self.temperature = float(temperature)
        if int(speculate or 0) > 0 and self.temperature > 0:
            # the JAX engine's guard
            raise ValueError(self._GREEDY_ONLY)
        #: the one sampling function, shared with the stream step
        self._sample = make_sampler(cfg.vocab, self.temperature,
                                    int(top_k), float(min_p),
                                    with_logprobs=True)
        self.seed = int(seed)

        self.cfg = cfg
        self.B = int(max_streams)
        self.S = int(max_seq or cfg.max_seq)
        self.prefill_chunk = None if prefill_chunk is None \
            else int(prefill_chunk)
        if self.prefill_chunk is not None and not (
                0 < self.prefill_chunk < self.S):
            raise ValueError(
                f"serving: prefill_chunk must be in (0, {self.S}), got "
                f"{prefill_chunk}")
        self.prefix_cache = int(prefix_cache)
        if self.prefix_cache < 0:
            raise ValueError(
                f"serving: prefix_cache must be >= 0, got {prefix_cache}")
        self.kv_quant = kv_quant
        # the codec's ValueError for an unknown kv_quant comes first
        self._decode = build_decode_step(cfg, self.S, kv_codec=kv_quant)
        self._chunk_fn = build_chunk_decode(cfg, self.S, kv_codec=kv_quant)
        self.device = resolve_device() if device is None \
            else torch.device(device)
        #: the serving mesh's sharded steps (parallel/sharded.py); None
        #: on one device
        self._lm = None
        if mesh is not None:
            from nnstreamer_tpu_torch.parallel import serve as _serve
            from nnstreamer_tpu_torch.parallel.mesh import P
            from nnstreamer_tpu_torch.parallel.sharded import (
                ShardedLM,
                transformer_param_specs,
            )

            def axis(name, dim, total):
                if name not in mesh.axis_names or mesh.shape[name] <= 1:
                    return None
                if total % mesh.shape[name]:
                    raise ValueError(
                        f"serving: {dim} ({total}) must divide by mesh "
                        f"axis {name!r} ({mesh.shape[name]})")
                return name

            dp = axis("dp", "max_streams", self.B)
            tp = axis("tp", "n_heads", cfg.n_heads)
            # the mesh's first device is the controller's: host inputs
            # land there and results gather there
            self.device = mesh.device_list()[0].device

            def prune(spec):
                # drop axis names the mesh doesn't have (a dp-only
                # serving mesh has no "tp"): replicated on that dimension
                return P(*(a if (a is not None and a in mesh.axis_names)
                           else None for a in spec))

            specs = {k: prune(sp)
                     for k, sp in transformer_param_specs(cfg).items()}
        elif attention == "auto" and self.device.type == "cuda" and \
                not kernel_takes(cfg.head_dim):
            raise ValueError(
                f"serving: kernel B2 does not take head_dim "
                f"{cfg.head_dim} (a multiple of 8, at most 256); pass "
                "attention='reference' for plain attention")
        if mesh is None:
            self.params = prepare_params(params, cfg, self.device)
        else:
            # serving-plane placement: per-shard bytes register with the
            # budget accountant when one is active
            self.params = _serve.place_params(
                prepare_params(params, cfg, "cpu"), mesh, specs,
                label="engine:lm")
        self._auto_k = steps_per_dispatch == "auto"
        self.K = 8 if self._auto_k else int(steps_per_dispatch)
        self.eos_id = eos_id
        self.min_bucket = int(min_bucket)

        # the meshed engine keeps plain attention, as the JAX engine keeps
        # XLA attention under a mesh: kernel B2 runs unmeshed only
        self._prefill_fn = build_prefill(
            cfg, self.S,
            attention_fn=flash_attention
            if attention == "auto" and mesh is None else None,
            kv_codec=kv_quant)

        self.block_tokens = int(block_tokens or 0)
        #: paged KV cache on: block_tokens > 0 and the kill switch
        #: (NNSTPU_PAGED_KV) allows it; off, every path below is the
        #: monolithic engine's
        self.paged = self.block_tokens > 0 and _kvpool.paged_enabled()
        self._pool = None
        self.MB = 0
        if self.paged:
            if self.S % self.block_tokens:
                raise ValueError(
                    f"serving: block_tokens ({self.block_tokens}) must "
                    f"divide max_seq ({self.S})")
            #: block-table width: blocks a stream holds at full context
            self.MB = self.S // self.block_tokens
            self._paged_decode = build_paged_decode_step(
                cfg, self.block_tokens, self.S, kv_codec=kv_quant)
            self._paged_chunk_fn = build_paged_chunk(
                cfg, self.block_tokens, self.S, kv_codec=kv_quant)
            self._num_blocks = int(kv_blocks) if kv_blocks \
                else self.B * self.MB
            if mesh is not None and "dp" in mesh.axis_names:
                # the arena's block axis shards over dp: pad so the
                # blocks with the zero block (NTOT) divide
                self._num_blocks += (-(self._num_blocks + 1)) % \
                    mesh.shape["dp"]
        self._init_cache = lambda: init_cache(cfg, self.B, self.S,
                                              kv_codec=kv_quant,
                                              device=self.device)
        if mesh is not None:
            self._lm = ShardedLM(cfg, mesh, {
                "decode": self._decode, "chunk": self._chunk_fn,
                "prefill": self._prefill_fn,
                **({"paged_decode": self._paged_decode,
                    "paged_chunk": self._paged_chunk_fn}
                   if self.paged else {})})
            self._decode, self._chunk_fn = self._lm.decode, self._lm.chunk
            self._prefill_fn = self._lm.prefill
            if self.paged:
                self._paged_decode = self._lm.paged_decode
                self._paged_chunk_fn = self._lm.paged_chunk

            def shard_cache(cache):
                # leaves [L, 2, B, S, h, dh] (and the int8 codec's scales
                # [L, 2, B, S, h]): slots over dp, heads over tp. Working
                # state the engine sizes itself: placed, not registered
                full = (None, None, dp, None, tp, None)
                return KVCache(*_serve.place_tree(
                    list(cache.leaves()), mesh,
                    lambda a: P(*full[:a.dim()]), label="engine:kv-cache"))

            self._init_cache = lambda: shard_cache(init_cache(
                cfg, self.B, self.S, kv_codec=kv_quant, device="cpu"))
        #: the serving mesh (None on one device)
        self._mesh = mesh
        if mesh is not None and len(mesh.device_list()) > 1 and \
                self.device.type == "cuda":
            # one captured graph spans one device; the K-step dispatch
            # of a multi-card mesh runs eagerly
            self._eager_dispatch = True
        self._init_cache1 = lambda: init_cache(cfg, 1, self.S,
                                               kv_codec=kv_quant,
                                               device=self.device)

        # host-side per-slot state
        self._pos = np.zeros(self.B, np.int64)
        self._last = np.zeros(self.B, np.int32)
        #: each slot's packed Philox key (``transformer.sampling_key``)
        self._key = np.zeros(self.B, np.int64)
        #: the K-step program (captured on a card); None until start()
        #: builds it, and again after a recovery or a K change
        self._program: Optional[_DecodeProgram] = None
        self._capture_stream = None
        #: True when the host mirrors are authoritative (after admissions
        #: or a recovery): the next dispatch loads them into the program
        self._reload = True
        #: captures (K of each), their seconds, and the dispatches that
        #: were graph replays
        self.graph_stats: Dict[str, Any] = {"captures": [],
                                            "capture_s": 0.0, "replays": 0}
        #: issued-but-unprocessed dispatch blocks:
        #: (t0, K, toks_host, lps_host, event, [(slot, stream), ...])
        self._inflight: "collections.deque" = collections.deque()
        self._slots: List[Any] = [None] * self.B
        self._budget = np.zeros(self.B, np.int64)  # tokens still allowed
        #: in-progress chunked admission: (request, slot, cache1, k, base)
        #: with k the next chunk; one at a time, advanced between dispatches
        self._partial = None
        #: tuple(prompt ids) → (kv KVCache [L, 2, 1, n, ...], logits[1, V])
        #: — LRU, engine thread only; the trie mirrors the key set
        self._prefix: "collections.OrderedDict" = collections.OrderedDict()
        self._prefix_trie = _PrefixTrie()
        #: prefix key → (accountant unit key, bytes) under an HBM budget;
        #: keys whose units the accountant revoked wait in _condemned for
        #: the engine thread (:meth:`_reap_condemned`)
        self._prefix_acct: Dict[tuple, tuple] = {}
        self._prefix_seq = itertools.count()
        self._condemned: set = set()
        self._condemned_lock = threading.Lock()

        # paged mode never allocates the monolithic cache: the pool's
        # arena (made below, after obs_name) is the only KV storage
        self._cache = None if self.paged else self._init_cache()
        self._pending: "_queue.Queue[_PendingRequest]" = _queue.Queue()
        self._next_id = 0
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats: Dict[str, Any] = {
            "tokens_generated": 0, "dispatches": 0, "prefills": 0,
            "prefill_chunks": 0, "slot_steps": 0, "active_slot_steps": 0,
            "prefix_hits": 0, "prefix_tokens_reused": 0,
            "concurrent_streams_max": 0, "kv_sheds": 0, "kv_defers": 0,
            "spec_drafted": 0, "spec_accepted": 0,
        }
        #: registry label distinguishing concurrent engines in one process
        self.obs_name = f"engine{next(self._OBS_SEQ)}"
        self._m_queue_wait = get_registry().histogram(
            "nns_serving_queue_wait_seconds",
            "submit() to batch-slot admission wait",
            engine=self.obs_name)
        register_engine_collector(self)
        #: request-path SLO admission (serving/scheduler.py): submit()
        #: rejects prompts whose deadline is unmeetable under the EWMA
        #: per-request service estimate; 0 = admit everything (default)
        self._slo = None
        if float(slo_budget_ms or 0.0) > 0:
            from nnstreamer_tpu_torch.serving.scheduler import SloScheduler

            self._slo = SloScheduler(budget_ms=float(slo_budget_ms),
                                     name=self.obs_name)
        #: per-token latency quantiles (TTFT vs inter-token split)
        self._lm_stats = LMTokenStats(self.obs_name)
        #: reference-style windowed read-outs (latency_us = one [B, K]
        #: dispatch wall time including the token fetch)
        self.invoke_stats = InvokeStats()
        if self.paged:
            self._pool = _kvpool.BlockPool(
                cfg, self._num_blocks, self.block_tokens, kv_codec=kv_quant,
                mesh=mesh, owner=self.obs_name, device=self.device)
            #: sid → per-stream decode state (stream, blocks, pos, last,
            #: budget, deadline_t, slot); engine thread only. Every
            #: admitted stream lives here, on a decode lane or parked
            self._sstate: Dict[int, dict] = {}
            #: admission head deferred on block exhaustion (FIFO order
            #: keeps: nothing behind it admits until it fits)
            self._held: Optional[_PendingRequest] = None
            #: decode lane → sid on it (None = free lane)
            self._lane: List[Optional[int]] = [None] * self.B
            #: host mirror of the device block tables, one row a lane
            self._bt = np.full((self.B, self.MB), self._pool.SENTINEL,
                               np.int64)

        self.speculate = 0
        self._speculate_layers: Optional[int] = None
        #: the draft model, its cache and builders (set_speculate)
        self._spec: Optional[dict] = None
        #: the speculative round program (captured on a card); None until
        #: start() builds it, and again after a recovery
        self._spec_program: Optional[_SpecRoundProgram] = None
        if int(speculate or 0) > 0:
            self.set_speculate(int(speculate), speculate_layers)

    # -- device helpers -------------------------------------------------------
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device without a stream sync
        (pinned staging, asynchronous copy)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t.to(self.device)  # nns-lint: disable=NNS113 -- control data: a few token ids or block indices per dispatch; the cache and weights are the tracked bytes
        return t.pin_memory().to(self.device, non_blocking=True)  # nns-lint: disable=NNS113 -- control data: a few token ids or block indices per dispatch; the cache and weights are the tracked bytes

    def _fetch_async(self, *tensors: torch.Tensor):
        """Start device→host copies into pinned memory; returns the host
        tensors and a CUDA event marking their arrival (None off CUDA,
        where the copies are made at once: the program's buffers are
        overwritten by the next dispatch)."""
        if self.device.type != "cuda":
            return [t.to("cpu", copy=True) for t in tensors], None
        out = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            out.append(h)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return out, event

    def _dispatch(self, token: torch.Tensor, pos: torch.Tensor,
                  bt: Optional[torch.Tensor] = None,
                  key: Optional[torch.Tensor] = None):
        """K decode steps: ([B] token, [B] pos) → ([B, K] tokens, [B, K]
        logprobs, last token, advanced pos), all on the device; on the
        paged engine against the arena through the block tables ``bt [B,
        MB]``, which the loop has topped up through pos + K - 1. Sampled,
        step j of lane r draws the token at position ``pos[r] + 1 + j``
        with lane r's key ``key [B]``: the K uniforms of every lane come
        from one Philox call. The body of :class:`_DecodeProgram`."""
        u = None
        if not self._sample.greedy:
            ctr = pos[:, None] + 1 + torch.arange(self.K, device=pos.device)
            u = philox_uniforms(torch.stack(
                [key[:, None].expand_as(ctr), ctr], dim=-1))   # [B, K]
        toks, lps = [], []
        for j in range(self.K):
            if self.paged:
                logits, _ = self._paged_decode(self.params, token,
                                               self._pool.arena, bt, pos)
            else:
                logits, _ = self._decode(self.params, token, self._cache,
                                         pos)
            token, lp = self._sample.draw(logits,
                                          None if u is None else u[:, j])
            toks.append(token)
            lps.append(lp)
            pos = pos + 1
        return torch.stack(toks, 1), torch.stack(lps, 1), token, pos

    def _capture(self, prog: _counts.GraphProgram, warm: bool,
                 tag: int) -> None:
        """Capture ``prog`` on the card (not on the CPU, nor under
        ``_eager_dispatch``); ``graph_stats`` records ``tag``."""
        if self.device.type != "cuda" or self._eager_dispatch:
            return
        with torch.cuda.device(self.device):
            if self._capture_stream is None:
                self._capture_stream = torch.cuda.Stream(self.device)
            prog.capture(self._capture_stream, warm)
        self.graph_stats["captures"].append(tag)
        self.graph_stats["capture_s"] += prog.capture_s

    def _ensure_program(self, warm: bool) -> _DecodeProgram:
        """The program at the current K, built (and, on a card, captured)
        if there is none at that K. ``warm`` as in
        :meth:`_counts.GraphProgram.capture`: only start() asks for it (on
        the paged engine the unloaded program writes the trash block
        only)."""
        if self._program is not None and self._program.K == self.K:
            return self._program
        self._drop_program()
        prog = _DecodeProgram(self)
        self._capture(prog, warm, self.K)
        self._program = prog
        self._reload = True
        return prog

    def _ensure_spec_program(self, warm: bool) -> _SpecRoundProgram:
        """The speculative round program, built and captured if there is
        none. Its warm-up writes every lane's caches at positions 0..γ:
        only start() asks for it, before any stream is live."""
        if self._spec_program is None:
            prog = _SpecRoundProgram(self)
            self._capture(prog, warm, self.speculate)
            self._spec_program = prog
        return self._spec_program

    def _drop_program(self) -> None:
        if self._program is not None:
            self._program.release()
            self._program = None
        if self._spec_program is not None:
            self._spec_program.release()
            self._spec_program = None

    def _calibrate_k(self) -> None:
        """steps_per_dispatch="auto": pick K from MEASURED costs.

        A decode block costs ``rtt + K·s`` wall time for ``rtt`` = the
        fixed dispatch + sync cost (a tiny op and its ``.item()``) and
        ``s`` = one batched decode step, which falls out of one timed run
        of the program at the initial K (on a card a graph replay, as
        every dispatch will be). K is chosen so the fixed cost is ≤ ~20%
        of the block (K ≥ 4·rtt/s), clamped to [8, 128] and rounded down
        to a power of two; the program is built again only if K changed.
        Runs once, before the engine loop starts, on the live cache
        (admission overwrites a slot's whole KV; the paged program's
        unloaded block tables send every write to the trash block)."""
        x = torch.zeros((8,), dtype=torch.int32, device=self.device)
        (x + 1)[0].item()  # warm off the clock
        rtts = []
        for _ in range(3):
            t0 = _time.monotonic()
            (x + 1)[0].item()
            rtts.append(_time.monotonic() - t0)
        rtt = min(rtts)
        prog = self._ensure_program(warm=True)
        prog.run()
        prog.toks.cpu()  # warm
        t0 = _time.monotonic()
        prog.run()
        prog.toks.cpu()
        block = _time.monotonic() - t0
        step = max((block - rtt) / self.K, 1e-5)
        k = max(8, min(128, int(4 * rtt / step)))
        self.K = 1 << (k.bit_length() - 1)  # round down to a power of two
        log.info("serving: auto K — rtt %.3f ms, step %.3f ms → K=%d",
                 rtt * 1e3, step * 1e3, self.K)

    # -- public API -----------------------------------------------------------
    def start(self) -> "ContinuousBatchingEngine":
        if self._thread is not None and not self._thread.is_alive():
            # leftover from a timed-out stop() whose loop has since
            # exited: reap it so restart works instead of silently no-op
            self._thread.join(timeout=0)
            self._thread = None
        if self._thread is not None:
            if self._stop_evt.is_set():
                raise RuntimeError(
                    "serving: previous engine loop is still shutting "
                    "down; retry start() after it exits")
            return self  # already running
        with torch.inference_mode():
            if self._auto_k:
                self._auto_k = False  # calibrate once, not per restart
                try:
                    self._calibrate_k()
                except Exception as e:  # noqa: BLE001 — auto-tune is an
                    # optimization; the initial K always works
                    log.warning("serving: K auto-calibration failed (%s); "
                                "keeping K=%d", e, self.K)
                    self._drop_program()
                    if self.paged:
                        self._pool.reset()
                    else:
                        self._cache = None
                        self._cache = self._init_cache()
            # no stream is live before the loop starts: the program may
            # warm up on the cache (a capture error raises here)
            if self._spec is None:
                self._ensure_program(warm=True)
            else:
                # speculative rounds replace the K-step dispatch
                if self._program is not None:
                    self._program.release()
                    self._program = None
                self._ensure_spec_program(warm=True)
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="cb-engine", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        """Stop the engine and unregister every byte it registered with
        the HBM accountant (prefix entries, the paged arena): after
        close() the engine's account nets to zero."""
        self.stop()
        for key in list(self._prefix_acct):
            self._prefix_unaccount(key)
        if self.paged:
            self._pool.close()

    def stop(self):
        self._stop_evt.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                # stuck in a long dispatch: keep the thread ref so a later
                # start() can't spawn a concurrent second loop, and leave
                # stream state to the still-running loop
                log.warning("serving: engine loop still busy at stop(); "
                            "call stop() again after it settles")
                return
            self._thread = None
        # fail any stream still in flight so iterators don't hang; the
        # lock serializes with submit()'s running-check + enqueue, so a
        # request can't slip into _pending after this drain
        with self._lock:
            if self._partial is not None:
                self._partial[0].stream._finish("engine-stopped")
                self._partial = None
            for i, st in enumerate(self._slots):
                if st is not None and st is not self._RESERVED and \
                        not st.finished:
                    st._finish("engine-stopped")
                self._slots[i] = None
            if self.paged:
                for state in list(self._sstate.values()):
                    self._finish_paged(state, "engine-stopped")
                if self._held is not None:
                    self._held.stream._finish("engine-stopped")
                    self._held = None
            while True:
                try:
                    req = self._pending.get_nowait()
                except _queue.Empty:
                    break
                req.stream._finish("engine-stopped")

    def submit(self, prompt, max_new_tokens: int = 64) -> GenerationStream:
        """Queue a prompt (sequence of int token ids); returns a
        :class:`GenerationStream` yielding generated ids."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("serving: empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"serving: max_new_tokens must be >= 1, got {max_new_tokens}"
                " (the prefill always yields the first token)")
        # chunked mode: the last chunk's writes (ceil(n/C)*C slots) must
        # fit the cache — equal to the plain n < S bound when C divides S
        limit = self.S - 1 if self.prefill_chunk is None else min(
            self.S - 1, (self.S // self.prefill_chunk) * self.prefill_chunk)
        if self.speculate:
            # a verify chunk writes kv at positions [pos, pos + γ]; the
            # per-stream budget keeps pos <= S - 1 - γ only if admission
            # does
            limit = min(limit, self.S - 1 - self.speculate)
        if prompt.size > limit:
            raise ValueError(
                f"serving: prompt length {prompt.size} must be <= {limit} "
                f"(cache length {self.S}"
                + (f", prefill chunk {self.prefill_chunk})"
                   if self.prefill_chunk is not None else ")"))
        with self._lock:
            # running-check + enqueue under the same lock stop() drains
            # under, so a request can't land after the drain
            if self._thread is None or self._stop_evt.is_set():
                raise RuntimeError(
                    "serving: engine is not running — call start() first "
                    "(a submit with no loop thread would never complete)")
            if self._slo is not None:
                # backlog ahead of this request: queued + active streams;
                # raises SloRejected before any slot or queue capacity is
                # taken — overload is turned away at the door
                backlog = self._pending.qsize() + (
                    len(self._sstate) + (1 if self._held is not None
                                         else 0)
                    if self.paged else
                    sum(1 for s in self._slots if s is not None))
                self._slo.admit_request(_time.monotonic(), backlog)
            sid = self._next_id
            self._next_id += 1
            stream = GenerationStream(sid, prompt.size)
            stream.submit_t = _time.monotonic()
            self._pending.put(_PendingRequest(prompt, int(max_new_tokens),
                                              stream))
        self._wake.set()
        return stream

    def generate(self, prompt, max_new_tokens: int = 64,
                 timeout: Optional[float] = None) -> List[int]:
        """Synchronous helper: submit + wait (engine must be started)."""
        return self.submit(prompt, max_new_tokens).result(timeout=timeout)

    @property
    def active_streams(self) -> int:
        if self.paged:
            return len(self._sstate)
        return sum(1 for s in self._slots
                   if s is not None and s is not self._RESERVED)

    # -- engine internals ------------------------------------------------------
    def _bucket(self, n: int) -> int:
        b = self.min_bucket
        while b < n:
            b *= 2
        return min(b, self.S)

    # -- prefix cache (engine thread only) ------------------------------------
    def _prefix_lookup(self, prompt: np.ndarray):
        """Longest COMMON prefix between ``prompt`` and any cached entry
        (two prompts sharing a preamble reuse the shared part); returns
        (p, kv sliced to p, logits) — logits only when the whole prompt
        equals a whole stored key."""
        best_key, best_lcp = self._prefix_trie.lookup(prompt)
        if best_key is None or best_lcp <= 0:
            return 0, None, None
        self._prefix.move_to_end(best_key)
        kv, logits = self._prefix[best_key]
        if not (best_lcp == prompt.size == len(best_key)):
            logits = None
        if logits is None and best_lcp == prompt.size:
            # whole prompt covered by a LONGER stored key: we have its kv
            # but not its last-position logits — recompute one position
            best_lcp -= 1
        if best_lcp <= 0:
            return 0, None, None
        if best_lcp < len(best_key):
            kv = kv.map(lambda a: a[:, :, :, :best_lcp])
        return best_lcp, kv, logits

    def _prefix_store(self, prompt: np.ndarray, cache1, logits) -> None:
        if not self.prefix_cache:
            return
        key = tuple(int(t) for t in prompt)
        n = prompt.size
        # the prompt's n slots only (axis 3 = S in every cache tensor),
        # copied out of the S-slot admission cache
        kv = cache1.map(lambda a: a[:, :, :, :n].clone())
        if key not in self._prefix:
            self._prefix_trie.insert(key)
        else:
            self._prefix_unaccount(key)  # re-stored: bytes change
        self._prefix[key] = (kv, logits)
        self._prefix.move_to_end(key)
        self._prefix_account(key, kv)
        while len(self._prefix) > self.prefix_cache:
            evicted, _ = self._prefix.popitem(last=False)
            self._prefix_trie.remove(evicted)
            self._prefix_unaccount(evicted)

    # -- prefix-cache HBM accounting (tensors/memory.py, "kvcache") ----------
    def _prefix_account(self, key: tuple, kv) -> None:
        """Register one monolithic prefix entry's device bytes with the
        HBM accountant as a DROPPABLE unit: under pressure the accountant
        revokes it (``on_drop`` condemns the key; the engine thread
        reaps), so cached prefixes ride the evict rung of the pressure
        ladder instead of being invisible device memory."""
        from nnstreamer_tpu_torch.tensors import memory as _memory

        acct = _memory.ACTIVE
        if acct is None:
            return
        nbytes = _memory.nbytes_of(list(kv.leaves()))
        acct_key = f"{self.obs_name}:prefix:{next(self._prefix_seq)}"
        ref = weakref.ref(self)

        def on_drop(_k, key=key):
            eng = ref()
            if eng is not None:
                with eng._condemned_lock:
                    eng._condemned.add(key)

        acct.residency.register_droppable(
            acct_key, nbytes, on_drop, label=f"{self.obs_name}:prefix")
        self._prefix_acct[key] = (acct_key, nbytes)

    def _prefix_unaccount(self, key: tuple) -> None:
        rec = self._prefix_acct.pop(key, None)
        if rec is None:
            return
        from nnstreamer_tpu_torch.tensors import memory as _memory

        acct = _memory.ACTIVE
        if acct is not None:
            acct.residency.unregister(rec[0])

    def _reap_condemned(self) -> None:
        """Engine-thread half of droppable prefix eviction: drop the
        entries whose accounting units the pressure ladder revoked
        (their bytes are already unregistered; only the engine's
        references remain to release)."""
        if not self._condemned:
            return
        with self._condemned_lock:
            keys = list(self._condemned)
            self._condemned.clear()
        for key in keys:
            self._prefix_acct.pop(key, None)
            if key in self._prefix:
                del self._prefix[key]
                self._prefix_trie.remove(key)

    @staticmethod
    def _place_prefix_kv(cache1, kv):
        """Write a cached kv slice into slots [0, n) of a fresh cache (in
        place)."""
        n = kv.values.shape[3]
        cache1.map(lambda a: a[:, :, :, :n]).copy_(kv)
        return cache1

    def _admit(self, req: _PendingRequest, slot: int):
        """Device phase of one admission: prefill (or prefix reuse) and
        first-token sample, dispatched without a host sync. Returns the
        record :meth:`_activate_commit` completes."""
        self._m_queue_wait.observe(_time.monotonic() - req.submit_t)
        prompt = req.prompt
        n = prompt.size
        p, kv, cached_logits = (self._prefix_lookup(prompt)
                                if self.prefix_cache else (0, None, None))
        if p == n:  # whole prompt cached: no prefill compute
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_reused"] += p
            cache1 = self._place_prefix_kv(self._init_cache1(), kv)
            return self._activate_begin(req, slot, cached_logits, cache1)
        if (p >= self.PREFIX_MIN_REUSE
                and p + self._bucket(n - p) <= self.S):
            # prefill only the remainder through the chunk program; the
            # first bound skips near-useless hits, the second keeps the
            # padded chunk's writes inside the cache
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_reused"] += p
            cache1 = self._place_prefix_kv(self._init_cache1(), kv)
            rem = n - p
            padded = np.zeros((1, self._bucket(rem)), np.int32)
            padded[0, :rem] = prompt[p:]
            logits, cache1 = self._chunk_fn(
                self.params, self._upload(padded), cache1,
                self._upload(np.asarray(p, np.int64)))
            logits = logits[:, rem - 1]
            self._prefix_store(prompt, cache1, logits)
            return self._activate_begin(req, slot, logits, cache1)
        padded = np.zeros((1, self._bucket(n)), np.int32)
        padded[0, :n] = prompt
        logits, cache1 = self._prefill_fn(
            self.params, self._upload(padded),
            lengths=self._upload(np.asarray([n], np.int64)))
        self._prefix_store(prompt, cache1, logits)
        return self._activate_begin(req, slot, logits, cache1)

    def _begin_partial(self, req: _PendingRequest, slot: int) -> None:
        self._m_queue_wait.observe(_time.monotonic() - req.submit_t)
        base = 0
        cache1 = self._init_cache1()
        if self.prefix_cache:
            p, kv, cached_logits = self._prefix_lookup(req.prompt)
            if p == req.prompt.size:  # whole prompt cached: no chunks
                self.stats["prefix_hits"] += 1
                self.stats["prefix_tokens_reused"] += p
                cache1 = self._place_prefix_kv(cache1, kv)
                self._activate(req, slot, cached_logits, cache1)
                return
            if p // self.prefill_chunk > 0:
                # resume at the last chunk boundary <= p: chunk starts
                # stay multiples of C (the submit-time bound assumes it).
                # A hit below one chunk is a miss
                self.stats["prefix_hits"] += 1
                base = (p // self.prefill_chunk) * self.prefill_chunk
                self.stats["prefix_tokens_reused"] += base
                cache1 = self._place_prefix_kv(cache1, kv)
        self._slots[slot] = self._RESERVED
        self._partial = (req, slot, cache1, 0, base)

    def _advance_partial(self) -> None:
        """Run ONE prefill chunk; on the last chunk, activate the slot."""
        req, slot, cache1, k, base = self._partial
        C = self.prefill_chunk
        prompt, n = req.prompt, req.prompt.size
        start = base + k * C
        end = min(start + C, n)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :end - start] = prompt[start:end]
        try:
            logits, cache1 = self._chunk_fn(
                self.params, self._upload(chunk), cache1,
                self._upload(np.asarray(start, np.int64)))
            self.stats["prefill_chunks"] += 1
            if end < n:
                self._partial = (req, slot, cache1, k + 1, base)
                return
            # final chunk: logits at the prompt's true last position
            self._partial = None
            logits_last = logits[:, (n - 1) - start]
            if self.paged:
                rec = self._activate_paged_from_cache1(req, logits_last,
                                                       cache1)
                if rec is None:  # pool exhausted: re-ingest when it isn't
                    self.stats["kv_defers"] += 1
                    self._held = req
                else:
                    self._commit_wave([rec], self._activate_commit_paged)
                return
            self._prefix_store(prompt, cache1, logits_last)
            self._activate(req, slot, logits_last, cache1)
        except Exception as e:  # noqa: BLE001 — a failed chunk must free
            # the reserved slot and fail only this request
            log.warning("serving: chunked prefill failed: %s", e)
            self._partial = None
            if slot is not None:
                self._slots[slot] = None
            state = self._sstate.get(req.stream.stream_id) \
                if self.paged else None
            if state is not None:  # activated: its blocks go back too
                self._finish_paged(state, f"error: {e}")
                return
            req.stream._finish(f"error: {e}")

    def _sample_first(self, req: _PendingRequest, logits):
        """The first token of an admission (position n, the prompt's
        length) and its logprob, on the device, drawn with the stream's
        key."""
        keys = None if self._sample.greedy else self._upload(np.asarray(
            [[sampling_key(self.seed, req.stream.stream_id),
              req.prompt.size]], np.int64))
        first_d, _, lp_d = self._sample(logits, keys)
        return first_d, lp_d

    def _activate_begin(self, req: _PendingRequest, slot: int, logits,
                        cache1):
        """Device half of an activation: sample the first token, write the
        prompt's KV into the slot (the whole slot, in place: the captured
        program reads the cache where it is), and CLAIM the slot. Returns
        ``(req, slot, first_d, lp_d)``."""
        first_d, lp_d = self._sample_first(req, logits)
        if self._lm is not None:
            self._lm.write_slot(self._cache, slot, cache1)
        else:
            self._cache.map(lambda t: t[:, :, slot]).copy_(
                cache1.map(lambda t: t[:, :, 0]))
        if self._spec is not None:
            # the shallow draft re-reads the whole prompt (half the
            # layers, one bucketed prefill), so its cache is canonical
            # from position 0
            self._draft_prefill(req, slot)
        self._slots[slot] = req.stream  # claimed; mirrors land at commit
        return (req, slot, first_d, lp_d)

    def _activate(self, req: _PendingRequest, slot: int, logits,
                  cache1) -> None:
        """Single-admission tail (the chunked path): begin, one host sync,
        commit."""
        rec = self._activate_begin(req, slot, logits, cache1)
        self._sync_host_state()
        self._commit_wave([rec], self._activate_commit)

    def _activate_commit(self, rec, first: int, first_lp: float) -> None:
        """Host half: install the per-slot host mirrors and emit the first
        token. Callers run :meth:`_sync_host_state` after the begins and
        before the first commit."""
        req, slot, _, _ = rec
        n = req.prompt.size
        self.stats["prefills"] += 1
        self._pos[slot] = n
        self._last[slot] = first
        self._key[slot] = sampling_key(self.seed, req.stream.stream_id)
        # cap generation so cache writes stay inside the slot's S window
        # (a speculative verify chunk writes through pos + γ, hence the
        # margin; zero when speculation is off)
        self._budget[slot] = min(req.max_new, self.S - n - self.speculate)
        t0 = getattr(req.stream, "submit_t", None)
        if t0 is not None:
            self._lm_stats.observe_ttft(_time.monotonic() - t0)
        req.stream._emit(first, first_lp)
        self.stats["tokens_generated"] += 1
        self._post_emit(slot, first)

    def _commit_wave(self, admitted, commit) -> None:
        """Fetch a whole admission wave's first tokens in one copy, then
        ``commit`` each; a failed commit fails only its stream."""
        (firsts, lps), event = self._fetch_async(
            torch.cat([rec[2] for rec in admitted]),
            torch.cat([rec[3] for rec in admitted]))
        if event is not None:
            event.synchronize()
        firsts, lps = firsts.numpy(), lps.numpy()
        for i, rec in enumerate(admitted):
            try:
                commit(rec, int(firsts[i]), float(lps[i]))
            except Exception as e:  # noqa: BLE001 — fail only this
                # stream; its slot or blocks free for the next prompt
                log.warning("serving: activate failed: %s", e)
                if self.paged:
                    state = rec[1]
                    if self._sstate.get(state["sid"]) is state:
                        self._finish_paged(state, f"error: {e}")
                        continue
                else:
                    self._slots[rec[1]] = None
                rec[0].stream._finish(f"error: {e}")

    def _post_emit(self, slot: int, tok: int):
        """Budget/EOS bookkeeping after a token reaches its stream. The
        slot is freed BEFORE _finish wakes the client, so a caller that
        observes its stream done also observes the slot released."""
        st = self._slots[slot]
        self._budget[slot] -= 1
        done = (self.eos_id is not None and tok == self.eos_id) or \
            self._budget[slot] <= 0
        if done and self._slo is not None:
            t0 = getattr(st, "submit_t", None)
            if t0 is not None:
                # the whole request's service time feeds the admission
                # EWMA and the controller's p99 window — per REQUEST, the
                # engine's admission unit
                now = _time.monotonic()
                self._slo.observe_completion(now - t0, now, frames=1)
                self._slo.observe_service(now - t0, frames=1)
        if self.eos_id is not None and tok == self.eos_id:
            self._slots[slot] = None
            st._finish("eos")
        elif self._budget[slot] <= 0:
            self._slots[slot] = None
            st._finish("length")

    # -- pipelined block processing -------------------------------------------
    def _process_block(self, t0, k, toks_h, lps_h, event, snapshot):
        """Materialize one dispatched block and emit its tokens to the
        streams that were active when it was issued (a slot freed or
        re-admitted since then skips emission)."""
        if event is not None:
            event.synchronize()  # the D2H wait; timed below
        toks = toks_h.numpy()
        lps = lps_h.numpy()
        dt = _time.monotonic() - t0
        self.invoke_stats.record(dt)
        self.stats["dispatches"] += 1
        self.stats["slot_steps"] += self.B * k
        per_tok = dt / k
        for slot, st in snapshot:
            if self._slots[slot] is not st:
                continue  # freed/replaced while the block was in flight
            self._lm_stats.observe_token(per_tok)
            self._pos[slot] += k
            self._last[slot] = toks[slot, -1]
            for j in range(k):
                tok = int(toks[slot, j])
                self.stats["tokens_generated"] += 1
                self.stats["active_slot_steps"] += 1
                st._emit(tok, float(lps[slot, j]))
                self._post_emit(slot, tok)
                if self._slots[slot] is None:
                    break  # EOS/length mid-block: drop the tail

    def _drain_inflight(self):
        while self._inflight:
            self._process_block(*self._inflight.popleft())

    def _sync_host_state(self):
        """Drain the pipeline so admissions (which write per-slot host
        state) operate on current values; the next dispatch loads the
        program's buffers from the host mirrors."""
        self._drain_inflight()
        self._reload = True

    def _recover(self, e) -> None:
        """Device failure (a capture or a replay included): salvage what
        the card already computed (a best-effort drain — those tokens were
        generated), then fail every in-flight stream and any half-ingested
        prompt, drop the program (its graph read the old cache), rebuild
        the cache, and keep serving: the next dispatch captures anew."""
        log.error("serving: dispatch failed: %s", e)
        try:
            self._drain_inflight()
        except Exception:  # noqa: BLE001 — wedged device: drop the rest
            self._inflight.clear()
        if self._partial is not None:
            self._partial[0].stream._finish(f"error: {e}")
            self._partial = None
        for slot in range(self.B):
            st = self._slots[slot]
            if st is not None and st is not self._RESERVED:
                st._finish(f"error: {e}")
            self._slots[slot] = None
        self._drop_program()
        if self.paged:
            for state in list(self._sstate.values()):
                state["stream"]._finish(f"error: {e}")
            self._sstate.clear()
            if self._held is not None:
                self._held.stream._finish(f"error: {e}")
                self._held = None
            self._lane = [None] * self.B
            # zeroed in place, the same bytes; paged prefix entries hold
            # block ids into the dropped allocation map and go with it
            self._pool.reset()
            self._bt[:] = self._pool.SENTINEL
            self._prefix.clear()
            self._prefix_trie = _PrefixTrie()
        else:
            self._cache = None
            self._cache = self._init_cache()
        if self._spec is not None:
            self._spec["dcache"] = None
            self._spec["dcache"] = self._spec["init_dcache"]()
        self._reload = True

    # -- speculative decoding (speculate=γ) -----------------------------------
    def set_speculate(self, k: int,
                      draft_layers: Optional[int] = None) -> None:
        """Reconfigure speculative decoding (``tensor_lm_serve
        speculate=``). No-op when unchanged; requires a stopped engine
        loop (the draft cache and the round program are rebuilt). ``k=0``
        turns it off."""
        k = int(k or 0)
        if k == self.speculate and (
                k == 0 or draft_layers == self._speculate_layers):
            return
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(
                "serving: set_speculate requires a stopped engine loop")
        if k < 0:
            raise ValueError(f"serving: speculate must be >= 0, got {k}")
        if k >= self.S:
            raise ValueError(
                f"serving: speculate ({k}) must be < max_seq ({self.S})")
        if k and self.temperature > 0:
            raise ValueError(self._GREEDY_ONLY)
        if k and self._mesh is not None:
            raise ValueError(
                "serving: speculate does not compose with mesh= (the "
                "draft cache is slot-structured, not sharded)")
        if self._spec_program is not None:
            self._spec_program.release()
            self._spec_program = None
        self.speculate = k
        self._speculate_layers = draft_layers
        self._spec = None
        if k:
            self._build_speculative()

    def _build_speculative(self) -> None:
        """The draft: a ``speculate_layers``-deep prefix slice of the
        target's stacked params (views, no copy), with its own raw
        slot-structured cache, its decode step and its plain-attention
        prefill (the JAX engine's draft prefill takes no flash kernel)."""
        from nnstreamer_tpu_torch.models.speculative import (
            draft_from_target,
        )
        from nnstreamer_tpu_torch.models.transformer import (
            build_decode_step,
            build_prefill,
            init_cache,
        )

        nl = self._speculate_layers or max(1, self.cfg.n_layers // 2)
        dcfg, dparams = draft_from_target(self.cfg, self.params, nl)

        def init_dcache():
            return init_cache(dcfg, self.B, self.S, device=self.device)

        self._spec = {
            "dparams": dparams, "dcfg": dcfg,
            "dcache": init_dcache(), "init_dcache": init_dcache,
            "decode": build_decode_step(dcfg, self.S),
            "prefill": build_prefill(dcfg, self.S),
        }

    def _draft_prefill(self, req: _PendingRequest, slot: int) -> None:
        sp = self._spec
        n = req.prompt.size
        padded = np.zeros((1, self._bucket(n)), np.int32)
        padded[0, :n] = req.prompt
        _lg, dcache1 = sp["prefill"](
            sp["dparams"], self._upload(padded),
            lengths=self._upload(np.asarray([n], np.int64)))
        sp["dcache"].map(lambda t: t[:, :, slot]).copy_(
            dcache1.map(lambda t: t[:, :, 0]))

    def _spec_round(self, token: torch.Tensor, pos: torch.Tensor,
                    bt: Optional[torch.Tensor] = None):
        """One speculative round for every lane, on the device: γ greedy
        draft steps, then the target verifies the γ+1 positions ``[token,
        d_1..d_γ]`` in one chunk pass (the paged chunk on the paged
        engine), so ``n_emit`` ∈ [1, γ+1] tokens per lane are exactly what
        greedy decoding emits. A rejected draft needs no undo: the host
        advances pos by ``n_emit``, and the slots above it are written
        before they are ever attended. Last, the draft's cache takes the
        last emitted token's k/v at its position (a no-op rewrite unless
        all γ were accepted, when it fills the one position the draft
        steps never wrote). Returns ``(tgt [B, γ+1], lps [B, γ+1], n_emit
        [B])``; the body of :class:`_SpecRoundProgram`."""
        sp = self._spec
        g = self.speculate
        dparams, dcache, ddecode = sp["dparams"], sp["dcache"], sp["decode"]
        tok, p, drafts = token, pos, []
        for _ in range(g):
            lg, _ = ddecode(dparams, tok, dcache, p)
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
            drafts.append(tok)
            p = p + 1
        drafts = torch.stack(drafts, 1)                     # [B, γ]
        chunk_toks = torch.cat([token[:, None], drafts], 1)  # [B, γ+1]
        if self.paged:
            limit = torch.full((token.shape[0],), g + 1, dtype=torch.int64,
                               device=token.device)
            logits, _ = self._paged_chunk_fn(self.params, chunk_toks,
                                             self._pool.arena, bt, pos,
                                             limit)
        else:
            logits, _ = self._chunk_fn(self.params, chunk_toks, self._cache,
                                       pos)
        tgt = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, γ+1]
        lps = torch.gather(torch.log_softmax(logits.float(), dim=-1), -1,
                           tgt.long()[..., None])[..., 0]
        match = (tgt[:, :g] == drafts).to(torch.int32)
        n_emit = torch.cumprod(match, dim=1).sum(dim=1) + 1
        fix = torch.where(
            n_emit == 1, token,
            torch.gather(tgt, 1, torch.clamp(n_emit - 2, min=0)[:, None]
                         )[:, 0])
        ddecode(dparams, fix, dcache, pos + n_emit - 1)
        return tgt, lps, n_emit

    def _run_spec_round(self, last: np.ndarray, pos: np.ndarray,
                        bt: Optional[np.ndarray] = None):
        """Load the round program, run it (one replay on the card), and
        fetch its tokens, logprobs and emit counts: the one host read a
        round."""
        prog = self._spec_program
        if prog is None:  # after a recovery: capture anew (no warm-up)
            prog = self._ensure_spec_program(warm=False)
        prog.load(last, pos, bt)
        prog.run()
        if prog.graph is not None:
            self.graph_stats["replays"] += 1
        (tgt, lps, n_emit), event = self._fetch_async(prog.tgt, prog.lps,
                                                      prog.n_emit)
        if event is not None:
            event.synchronize()
        return tgt.numpy(), lps.numpy(), n_emit.numpy()

    def _spec_emit(self, st, m: int, tgt_row, lps_row, post_emit,
                   still_live) -> None:
        self.stats["spec_drafted"] += self.speculate
        self.stats["spec_accepted"] += m - 1
        for j in range(m):
            tok = int(tgt_row[j])
            self.stats["tokens_generated"] += 1
            self.stats["active_slot_steps"] += 1
            st._emit(tok, float(lps_row[j]))
            post_emit(tok)
            if not still_live():
                break

    def _spec_step_mono(self) -> None:
        g = self.speculate
        snapshot = [(slot, st) for slot, st in enumerate(self._slots)
                    if st is not None and st is not self._RESERVED]
        if not snapshot:
            return
        t0 = _time.monotonic()
        tgt, lps, n_emit = self._run_spec_round(self._last, self._pos)
        dt = _time.monotonic() - t0
        self.invoke_stats.record(dt)
        self.stats["dispatches"] += 1
        self.stats["slot_steps"] += self.B * (g + 1)
        for slot, st in snapshot:
            if self._slots[slot] is not st:
                continue
            m = int(n_emit[slot])
            self._pos[slot] += m
            self._last[slot] = int(tgt[slot, m - 1])
            self._lm_stats.observe_token(dt / max(1, m))
            self._spec_emit(st, m, tgt[slot], lps[slot],
                            lambda tok, slot=slot: self._post_emit(slot, tok),
                            lambda slot=slot: self._slots[slot] is not None)

    def _spec_step_paged(self) -> None:
        g = self.speculate
        run = []
        for st in list(self._sstate.values()):
            if self._sstate.get(st["sid"]) is not st:
                continue
            if not self._topup(st):
                continue
            slot = st["slot"]
            self._bt[slot, :] = self._pool.SENTINEL
            self._bt[slot, :len(st["blocks"])] = st["blocks"]
            run.append(st)
        if not run:
            return
        last = np.zeros(self.B, np.int32)
        pos = np.zeros(self.B, np.int64)
        for st in run:
            last[st["slot"]] = st["last"]
            pos[st["slot"]] = st["pos"]
        t0 = _time.monotonic()
        tgt, lps, n_emit = self._run_spec_round(last, pos, self._bt)
        dt = _time.monotonic() - t0
        self.invoke_stats.record(dt)
        self.stats["dispatches"] += 1
        self.stats["slot_steps"] += self.B * (g + 1)
        for st in run:
            if self._sstate.get(st["sid"]) is not st:
                continue
            slot = st["slot"]
            m = int(n_emit[slot])
            # rejected drafts roll the block table's tail back by
            # construction: pos advances only m, and the stale kv above it
            # is written again before it is ever attended
            st["pos"] += m
            st["last"] = int(tgt[slot, m - 1])
            self._lm_stats.observe_token(dt / max(1, m))
            self._spec_emit(
                st["stream"], m, tgt[slot], lps[slot],
                lambda tok, st=st: self._post_emit_paged(st, tok),
                lambda st=st: self._sstate.get(st["sid"]) is st)

    # -- paged mode (block_tokens > 0) ----------------------------------------
    def _blocks_for(self, n: int) -> int:
        """Blocks a fresh n-token-prompt stream needs up front: the
        prompt's positions plus the first decode write (n // T + 1: the
        tail block doubles as the decode block unless the prompt ends on a
        boundary)."""
        return n // self.block_tokens + 1

    def _alloc_blocks(self, k: int):
        """Pool alloc with the evict rung of the pressure ladder: LRU paged
        prefix entries are dropped until the allocation fits (or nothing
        is left to drop: the caller then defers or sheds); each drop
        counts the accountant's ``evict`` rung."""
        ids = self._pool.alloc(k)
        while ids is None and self._evict_prefix_paged():
            ids = self._pool.alloc(k)
        return ids

    def _evict_prefix_paged(self) -> bool:
        if not self._prefix:
            return False
        from nnstreamer_tpu_torch.tensors import memory as _memory

        evicted, (ids, _logits) = self._prefix.popitem(last=False)
        self._prefix_trie.remove(evicted)
        self._pool.release(list(ids))
        acct = _memory.ACTIVE
        if acct is not None:
            acct.count_pressure("evict")
        return True

    def _prefix_lookup_paged(self, prompt: np.ndarray):
        """→ (lcp, entry key, logits): the longest common prefix between
        ``prompt`` and a cached entry; logits only on an exact whole-prompt
        == whole-key hit. Reuse is at block granularity (the caller rounds
        down)."""
        if not self.prefix_cache:
            return 0, None, None
        best_key, lcp = self._prefix_trie.lookup(prompt)
        if best_key is None or lcp <= 0:
            return 0, None, None
        self._prefix.move_to_end(best_key)
        _ids, logits = self._prefix[best_key]
        if not (lcp == prompt.size == len(best_key)):
            logits = None
        return lcp, best_key, logits

    def _prefix_store_paged(self, prompt: np.ndarray, blocks,
                            logits) -> None:
        """Retain the stream's prompt-covering blocks as a cache entry:
        sharing is a refcount bump, so a prefix costs its blocks once and
        reuse is exact by construction (the same physical k/v). The tail
        block may be partial; every reader takes a copy-on-write copy of
        it, and the donor's later appends land at offsets >= n % T,
        outside the entry's [0, n)."""
        if not self.prefix_cache:
            return
        key = tuple(int(t) for t in prompt)
        if key in self._prefix:
            return
        n = prompt.size
        T = self.block_tokens
        ids = tuple(blocks[:(n + T - 1) // T])
        self._pool.retain(ids)
        self._prefix_trie.insert(key)
        self._prefix[key] = (ids, logits)
        self._prefix.move_to_end(key)
        while len(self._prefix) > self.prefix_cache:
            evicted, (eids, _lg) = self._prefix.popitem(last=False)
            self._prefix_trie.remove(evicted)
            self._pool.release(list(eids))

    def _admit_paged(self, req: _PendingRequest):
        """Paged admission: allocate the stream's blocks, prefill cold /
        block-aligned warm / exact hit, and return the activation record —
        or None to defer when the pool cannot cover the prompt (admission
        is bounded by free blocks; the caller holds the request so FIFO
        order keeps). Every path allocates before any device work."""
        self._m_queue_wait.observe(_time.monotonic() - req.submit_t)
        prompt = req.prompt
        n = prompt.size
        T = self.block_tokens
        p, key_hit, cached_logits = self._prefix_lookup_paged(prompt)
        if cached_logits is not None:  # exact whole-prompt hit
            eids, _lg = self._prefix[key_hit]
            fresh = self._alloc_blocks(1)
            if fresh is None:
                return None
            full = n // T
            shared = list(eids[:full])
            self._pool.retain(shared)
            blocks = shared + fresh
            try:
                if n % T:
                    # copy-on-write: a private copy of the entry's partial
                    # tail, where the stream appends from offset n % T
                    self._pool.copy_block(eids[full], fresh[0])
                self.stats["prefix_hits"] += 1
                self.stats["prefix_tokens_reused"] += n
                return self._activate_begin_paged(req, cached_logits,
                                                  blocks)
            except Exception:
                self._pool.release(blocks)
                raise
        q = min((p // T) * T, ((n - 1) // T) * T)  # block-aligned reuse
        if (key_hit is not None
                and q >= max(T, self.PREFIX_MIN_REUSE)
                and q + self._bucket(n - q) <= self.S):
            eids, _lg = self._prefix[key_hit]
            shared = list(eids[:q // T])
            fresh = self._alloc_blocks(self._blocks_for(n) - len(shared))
            if fresh is None:
                return None
            self._pool.retain(shared)
            blocks = shared + fresh
            try:
                self.stats["prefix_hits"] += 1
                self.stats["prefix_tokens_reused"] += q
                rem = n - q
                toks = np.zeros((1, self._bucket(rem)), np.int32)
                toks[0, :rem] = prompt[q:]
                bt = np.full((1, self.MB), self._pool.SENTINEL, np.int64)
                bt[0, :len(blocks)] = blocks
                logits, _ = self._paged_chunk_fn(
                    self.params, self._upload(toks), self._pool.arena,
                    self._upload(bt), self._upload(np.asarray([q], np.int64)),
                    self._upload(np.asarray([rem], np.int64)))
                logits = logits[:, rem - 1]
                self._prefix_store_paged(prompt, blocks, logits)
                return self._activate_begin_paged(req, logits, blocks)
            except Exception:
                self._pool.release(blocks)
                raise
        blocks = self._alloc_blocks(self._blocks_for(n))
        if blocks is None:
            return None
        try:
            padded = np.zeros((1, self._bucket(n)), np.int32)
            padded[0, :n] = prompt
            logits, cache1 = self._prefill_fn(
                self.params, self._upload(padded),
                lengths=self._upload(np.asarray([n], np.int64)))
            self._pool.scatter_prefill(cache1, blocks[:(n + T - 1) // T])
            self._prefix_store_paged(prompt, blocks, logits)
            return self._activate_begin_paged(req, logits, blocks)
        except Exception:
            self._pool.release(blocks)
            raise

    def _activate_paged_from_cache1(self, req: _PendingRequest, logits,
                                    cache1):
        """Chunked-prefill commit: scatter the finished batch-1 cache into
        fresh blocks. None = pool exhausted (the caller holds it)."""
        n = req.prompt.size
        T = self.block_tokens
        blocks = self._alloc_blocks(self._blocks_for(n))
        if blocks is None:
            return None
        try:
            self._pool.scatter_prefill(cache1, blocks[:(n + T - 1) // T])
            self._prefix_store_paged(req.prompt, blocks, logits)
            return self._activate_begin_paged(req, logits, blocks)
        except Exception:
            self._pool.release(blocks)
            raise

    def _begin_partial_paged(self, req: _PendingRequest) -> None:
        """Chunked prompt ingestion, paged: the chunks build a batch-1
        monolithic cache that the final chunk scatters into fresh blocks;
        no slot is reserved, and the blocks are allocated at activation.
        (Prefix reuse is not wired on this path, as in the JAX engine.)"""
        self._m_queue_wait.observe(_time.monotonic() - req.submit_t)
        self._partial = (req, None, self._init_cache1(), 0, 0)

    def _activate_begin_paged(self, req: _PendingRequest, logits, blocks):
        """Sample the first token and create the stream's decode state. No
        lane is claimed (EDF binds lanes a dispatch), except under
        speculation, where the slot-structured draft cache pins a stream
        to its lane for life."""
        first_d, lp_d = self._sample_first(req, logits)
        stream = req.stream
        sid = stream.stream_id
        n = req.prompt.size
        now = _time.monotonic()
        slo_s = self._slo.budget_s if self._slo is not None else 60.0
        state = {
            "sid": sid, "stream": stream, "blocks": list(blocks),
            "pos": n, "last": 0,
            # cap writes inside S (a verify chunk writes through pos + γ)
            "budget": min(req.max_new, self.S - n - self.speculate),
            #: absolute deadline feeding the per-token EDF key
            "deadline_t": getattr(stream, "submit_t", now) + slo_s,
            "slot": None,
        }
        self._sstate[sid] = state
        if self._spec is not None:
            slot = self._lane.index(None)
            self._lane[slot] = sid
            state["slot"] = slot
            self._draft_prefill(req, slot)
        return (req, state, first_d, lp_d)

    def _activate_commit_paged(self, rec, first: int,
                               first_lp: float) -> None:
        req, state, _, _ = rec
        self.stats["prefills"] += 1
        state["last"] = first
        t0 = getattr(req.stream, "submit_t", None)
        if t0 is not None:
            self._lm_stats.observe_ttft(_time.monotonic() - t0)
        req.stream._emit(first, first_lp)
        self.stats["tokens_generated"] += 1
        self._post_emit_paged(state, first)

    def _post_emit_paged(self, state, tok: int) -> None:
        state["budget"] -= 1
        done_eos = self.eos_id is not None and tok == self.eos_id
        done = done_eos or state["budget"] <= 0
        if done and self._slo is not None:
            t0 = getattr(state["stream"], "submit_t", None)
            if t0 is not None:
                now = _time.monotonic()
                self._slo.observe_completion(now - t0, now, frames=1)
                self._slo.observe_service(now - t0, frames=1)
        if done_eos:
            self._finish_paged(state, "eos")
        elif state["budget"] <= 0:
            self._finish_paged(state, "length")

    def _finish_paged(self, state, reason: str) -> None:
        """Stream teardown: its blocks return to the pool before the client
        wakes, so a caller that sees its stream done also sees the
        capacity released."""
        self._sstate.pop(state["sid"], None)
        slot = state["slot"]
        if slot is not None:
            self._lane[slot] = None
            self._bt[slot, :] = self._pool.SENTINEL
            state["slot"] = None
        if state["blocks"]:
            self._pool.release(state["blocks"])
            state["blocks"] = []
        state["stream"]._finish(reason)

    def _shed_one(self, keep_sid: int) -> bool:
        """Decode-time block exhaustion: revoke the admitted stream with
        the earliest deadline (the most late), with the SLO scheduler's
        shed accounting, the accountant's ``shed`` rung and finish reason
        "shed". False = the only candidate was ``keep_sid`` itself, which
        the caller gives up."""
        from nnstreamer_tpu_torch.tensors import memory as _memory

        cands = [st for st in self._sstate.values()
                 if st["sid"] != keep_sid]
        self_shed = not cands
        if self_shed:
            victim = self._sstate.get(keep_sid)
            if victim is None:
                return False
        else:
            victim = min(cands, key=lambda st: st["deadline_t"])
        now = _time.monotonic()
        late = victim["deadline_t"] <= now
        acct = _memory.ACTIVE
        if acct is not None:
            acct.count_pressure("shed")
        if self._slo is not None:
            self._slo.note_shed_request(now, late)
        self.stats["kv_sheds"] += 1
        log.warning("serving: paged KV exhausted — shedding stream %d "
                    "(%s)", victim["sid"], "late" if late else "capacity")
        self._finish_paged(victim, "shed")
        return not self_shed

    def _topup(self, state) -> bool:
        """Grow ``state``'s block table to cover the whole next dispatch
        (pos + K - 1; pos + γ for a speculative verify), walking the evict
        → shed ladder on exhaustion. False = the stream itself was
        shed."""
        steps = (self.speculate + 1) if self._spec is not None else self.K
        # the program clamps positions to S - 1, so no dispatch writes
        # past the table's last block (ROADMAP C.19: the JAX engine asks
        # one more near the cache's end and its table overflows)
        hi = min((state["pos"] + steps - 1) // self.block_tokens,
                 self.MB - 1)
        while len(state["blocks"]) <= hi:
            ids = self._alloc_blocks(hi + 1 - len(state["blocks"]))
            if ids is None:
                if not self._shed_one(state["sid"]):
                    return False
                continue
            state["blocks"].extend(ids)
        return True

    def _decode_step_paged(self) -> None:
        """One EDF-scheduled K-step block: bind the B most urgent streams
        (per-token deadline: a nearly late short stream preempts a long
        one at block granularity), top up their block tables, load the
        program (tokens, positions, block tables) and run it — one replay
        on the card — then fetch and emit."""
        from nnstreamer_tpu_torch.serving.scheduler import token_deadline

        now = _time.monotonic()
        states = list(self._sstate.values())
        if len(states) > self.B:
            states.sort(key=lambda st: token_deadline(
                now, st["deadline_t"], st["budget"]))
            selected = states[:self.B]
            keep = {st["sid"] for st in selected}
            # park the preempted streams' lanes (their k/v stays in the
            # arena; a stream rebinds whenever EDF selects it again)
            for slot, sid in enumerate(self._lane):
                if sid is not None and sid not in keep:
                    parked = self._sstate.get(sid)
                    if parked is not None:
                        parked["slot"] = None
                    self._lane[slot] = None
                    self._bt[slot, :] = self._pool.SENTINEL
        else:
            selected = states
        run = []
        for st in selected:
            if self._sstate.get(st["sid"]) is not st:
                continue  # shed while topping up an earlier stream
            if not self._topup(st):
                continue  # self-shed
            if st["slot"] is None:
                slot = self._lane.index(None)
                self._lane[slot] = st["sid"]
                st["slot"] = slot
            slot = st["slot"]
            self._bt[slot, :] = self._pool.SENTINEL
            self._bt[slot, :len(st["blocks"])] = st["blocks"]
            run.append(st)
        if not run:
            return
        last = np.zeros(self.B, np.int32)
        pos = np.zeros(self.B, np.int64)
        for st in run:
            last[st["slot"]] = st["last"]
            pos[st["slot"]] = st["pos"]
        key = None  # a greedy engine's dispatch never reads the keys
        if not self._sample.greedy:
            key = np.zeros(self.B, np.int64)
            for st in run:
                key[st["slot"]] = sampling_key(self.seed, st["sid"])
        t0 = _time.monotonic()
        prog = self._ensure_program(warm=False)
        prog.load(last, pos, self._bt, key)
        prog.run()
        if prog.graph is not None:
            self.graph_stats["replays"] += 1
        (toks, lps), event = self._fetch_async(prog.toks, prog.lps)
        if event is not None:
            event.synchronize()
        toks, lps = toks.numpy(), lps.numpy()
        dt = _time.monotonic() - t0
        self.invoke_stats.record(dt)
        self.stats["dispatches"] += 1
        self.stats["slot_steps"] += self.B * self.K
        per_tok = dt / self.K
        for st in run:
            if self._sstate.get(st["sid"]) is not st:
                continue
            slot = st["slot"]
            st["pos"] += self.K
            st["last"] = int(toks[slot, -1])
            self._lm_stats.observe_token(per_tok)
            for j in range(self.K):
                tok = int(toks[slot, j])
                self.stats["tokens_generated"] += 1
                self.stats["active_slot_steps"] += 1
                st["stream"]._emit(tok, float(lps[slot, j]))
                self._post_emit_paged(st, tok)
                if self._sstate.get(st["sid"]) is not st:
                    break  # EOS, length or shed mid-block: drop the tail

    def _loop_paged(self):
        """The paged engine loop. Dispatch → emit runs synchronously (the
        host state it loads a block is a few hundred integers), which keeps
        lane parking and EDF preemption a host-side concern."""
        while not self._stop_evt.is_set():
            self._reap_condemned()
            for state in list(self._sstate.values()):
                if state["stream"].cancelled:
                    self._finish_paged(state, "cancelled")
            if self._held is not None and self._held.stream.cancelled:
                self._held.stream._finish("cancelled")
                self._held = None
            progressed = False
            if self._partial is not None:
                if self._partial[0].stream.cancelled:
                    self._partial[0].stream._finish("cancelled")
                    self._partial = None
                else:
                    self._advance_partial()
                    progressed = True
            admitted = []
            while self._partial is None:
                if self._spec is not None and \
                        len(self._sstate) >= self.B:
                    break  # the slot-structured draft cache caps streams
                if self._held is not None:
                    req, self._held = self._held, None
                else:
                    try:
                        req = self._pending.get_nowait()
                    except _queue.Empty:
                        break
                if req.stream.cancelled:
                    req.stream._finish("cancelled")
                    continue
                try:
                    if self.prefill_chunk is not None:
                        self._begin_partial_paged(req)
                        progressed = True
                        break
                    rec = self._admit_paged(req)
                except Exception as e:  # noqa: BLE001 — a bad request
                    # must not kill the engine loop
                    log.warning("serving: admit failed: %s", e)
                    req.stream._finish(f"error: {e}")
                    continue
                if rec is None:
                    # the pool cannot cover this prompt yet: hold the head
                    # (completions free blocks; FIFO order keeps)
                    self.stats["kv_defers"] += 1
                    self._held = req
                    break
                admitted.append(rec)
                progressed = True
            if admitted:
                try:
                    self._commit_wave(admitted, self._activate_commit_paged)
                except Exception as e:  # noqa: BLE001 — deferred device
                    # errors surface at the fetch
                    self._recover(e)
                    continue
            if len(self._sstate) > self.stats["concurrent_streams_max"]:
                self.stats["concurrent_streams_max"] = len(self._sstate)
            if not self._sstate:
                if not progressed:
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                continue
            try:
                if self._spec is not None:
                    self._spec_step_paged()
                else:
                    self._decode_step_paged()
            except Exception as e:  # noqa: BLE001 — a device failure must
                # not strand clients blocked on their streams
                self._recover(e)

    def _loop(self):
        # grad mode is per thread: this thread enters inference mode itself
        with torch.inference_mode():
            loop = self._loop_paged if self.paged else self._loop_mono
            if self.device.type == "cuda":
                with torch.cuda.device(self.device):
                    loop()
            else:
                loop()

    def _loop_mono(self):
        while not self._stop_evt.is_set():
            self._reap_condemned()
            # honor cancellations first: active slots free at this block
            # boundary; a half-ingested prompt stops mid-prefill
            for slot in range(self.B):
                st = self._slots[slot]
                if (st is not None and st is not self._RESERVED
                        and st.cancelled):
                    self._slots[slot] = None
                    st._finish("cancelled")
            if self._partial is not None and \
                    self._partial[0].stream.cancelled:
                _, slot, _, _, _ = self._partial
                self._slots[slot] = None
                self._partial[0].stream._finish("cancelled")
                self._partial = None
            # an in-flight chunked prefill: ONE chunk per iteration, so the
            # decode dispatch below keeps running streams moving
            progressed = False
            if self._partial is not None:
                self._advance_partial()
                progressed = True
            # admission: fill free slots from the pending queue. The
            # device work (prefill + first-token sample) dispatches per
            # request; the host fetch commits the wave at once below.
            queue_dry = False
            admitted = []
            for slot in range(self.B):
                if queue_dry or self._slots[slot] is not None \
                        or self._partial is not None:
                    continue
                # retry THIS slot past cancelled/failed queue heads
                while True:
                    try:
                        req = self._pending.get_nowait()
                    except _queue.Empty:
                        queue_dry = True
                        break
                    if req.stream.cancelled:
                        req.stream._finish("cancelled")
                        continue
                    try:
                        if self.prefill_chunk is not None:
                            self._begin_partial(req, slot)
                        else:
                            admitted.append(self._admit(req, slot))
                        progressed = True
                        break  # slot filled
                    except Exception as e:  # noqa: BLE001 — a bad request
                        # (or a prefill failure) must not kill the loop
                        log.warning("serving: admit failed: %s", e)
                        self._slots[slot] = None
                        self._partial = None
                        req.stream._finish(f"error: {e}")
            if admitted:
                try:
                    self._sync_host_state()
                    self._commit_wave(admitted, self._activate_commit)
                except Exception as e:  # noqa: BLE001 — deferred device
                    # errors surface at the fetch; _recover fails every
                    # admitted stream and frees the slots
                    self._recover(e)
            if self.active_streams == 0:
                try:
                    self._sync_host_state()  # late EOS frees the last slot
                except Exception as e:  # noqa: BLE001 — must not kill the
                    # engine thread
                    self._recover(e)
                    continue
                if self.active_streams == 0:
                    if not progressed:
                        self._wake.wait(timeout=0.05)
                        self._wake.clear()
                    continue
            if self._spec is not None:
                # speculative rounds replace the K-step dispatch; they run
                # synchronously off the host mirrors (per-stream emit
                # counts vary)
                try:
                    self._sync_host_state()
                    self._spec_step_mono()
                except Exception as e:  # noqa: BLE001
                    self._recover(e)
                continue
            try:
                t0 = _time.monotonic()
                prog = self._ensure_program(warm=False)
                if self._reload:
                    prog.load(self._last, self._pos, key=None
                              if self._sample.greedy else self._key)
                    self._reload = False
                prog.run()
                if prog.graph is not None:
                    self.graph_stats["replays"] += 1
                # start the copies NOW; the blocking wait runs one block
                # behind, so the fetch overlaps the next dispatch
                (toks_h, lps_h), event = self._fetch_async(prog.toks,
                                                           prog.lps)
                self._inflight.append((t0, prog.K, toks_h, lps_h, event, [
                    (slot, st) for slot, st in enumerate(self._slots)
                    if st is not None and st is not self._RESERVED]))
                if len(self._inflight) > 1:
                    self._process_block(*self._inflight.popleft())
            except Exception as e:  # noqa: BLE001 — a device failure must
                # not strand clients blocked on their streams
                self._recover(e)
                continue
        # stop requested: flush the pipelined blocks so streams whose
        # tokens were already computed still receive them
        try:
            self._drain_inflight()
        except Exception as e:  # noqa: BLE001 — draining on shutdown is
            # best-effort; a dead device must not block stop()
            log.warning("serving: drain at stop failed: %s", e)
