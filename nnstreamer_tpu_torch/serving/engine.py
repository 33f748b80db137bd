"""Continuous-batching decode engine, on the card.

The JAX package's ``serving/engine.py`` on its single-chip, monolithic-
cache, greedy path:

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
  exact repeat none. Registering the entries with the HBM accountant as
  droppable units waits for ``tensors/memory.py`` (A.19): without an
  accountant the JAX engine does not register them either.
- **Request-path SLO admission.** With ``slo_budget_ms`` > 0 the engine
  owns an :class:`~nnstreamer_tpu_torch.serving.scheduler.SloScheduler`:
  ``submit()`` raises ``SloRejected`` when the request's deadline cannot
  be met behind the queued and active requests at the current
  per-request service estimate (cold: everything is admitted), and each
  finished request's submit-to-finish time feeds the estimate. The paged
  engine's per-token deadlines and KV-pressure shedding wait for A.13.3.

Options of the JAX engine that are not ported yet raise with their
ROADMAP item: ``mesh`` (A.24), ``block_tokens`` (A.13.3), ``speculate``
(A.13.4) and sampled decoding — ``temperature > 0``, ``top_k``,
``min_p`` (A.13.5).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import queue as _queue
import threading
import time as _time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from nnstreamer_tpu_torch.device import resolve_device
from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.ops import _counts
from nnstreamer_tpu_torch.pipeline.element import not_ported

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


class _DecodeProgram:
    """The engine's K-step dispatch over static device buffers.

    ``token [B]`` and ``pos [B]`` feed the first step. The body is the
    engine's eager :meth:`ContinuousBatchingEngine._dispatch` loop; it
    leaves the ``[B, K]`` tokens and logprobs in ``toks`` and ``lps`` and,
    as its last op, writes the advanced token and positions back into
    ``token`` and ``pos``, so the next run chains off them with no host
    step. :meth:`load` copies the host mirrors in after an admission or a
    recovery.

    :meth:`capture` records the body once as a CUDA graph (on a side
    stream, in ``thread_local`` mode, so the process's other threads keep
    using the card meanwhile); every :meth:`run` after it is one replay,
    which reads the engine's cache and parameters where they were at the
    capture. Without a capture (the CPU) a run executes the body."""

    def __init__(self, engine: "ContinuousBatchingEngine"):
        self.engine = engine
        self.K = engine.K
        B, dev = engine.B, engine.device
        self.token = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((B,), dtype=torch.int64, device=dev)
        self.toks = torch.zeros((B, self.K), dtype=torch.int32, device=dev)
        self.lps = torch.zeros((B, self.K), dtype=torch.float32, device=dev)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        #: kernel-wrapper launches one replay runs (ops/_counts.py)
        self.tally: Dict[str, int] = {}
        self.capture_s = 0.0

    def body(self) -> None:
        toks, lps, last, pos = self.engine._dispatch(self.token, self.pos)
        self.toks.copy_(toks)
        self.lps.copy_(lps)
        self.token.copy_(last)
        self.pos.copy_(pos)

    def load(self, last: np.ndarray, pos: np.ndarray) -> None:
        self.token.copy_(self.engine._upload(last))
        self.pos.copy_(self.engine._upload(pos))

    def capture(self, stream: "torch.cuda.Stream", warm: bool) -> None:
        """Capture the body on ``stream``. ``warm`` first runs it eagerly
        there (cuBLAS's set-up for the stream, outside the capture): it
        advances the buffers and writes the cache at their positions, so
        only a caller with no live stream may ask for it."""
        t0 = _time.monotonic()
        cur = torch.cuda.current_stream(stream.device)
        stream.wait_stream(cur)
        if warm:
            with torch.cuda.stream(stream):
                self.body()
            cur.wait_stream(stream)
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with _counts.capture_tally() as tally, torch.cuda.graph(
                graph, stream=stream, capture_error_mode="thread_local"):
            self.body()
        self.graph, self.tally = graph, dict(tally)
        self.capture_s = _time.monotonic() - t0

    def run(self) -> None:
        if self.graph is None:
            self.body()
            return
        self.graph.replay()
        _counts.add_replay(self.tally)

    def release(self) -> None:
        """Drop the graph once the card is done with it (its private pool
        returns to the allocator)."""
        if self.graph is None:
            return
        with contextlib.suppress(RuntimeError):  # a failed card: drop anyway
            torch.cuda.synchronize(self.token.device)
        self.graph.reset()
        self.graph = None


class _PendingRequest:
    def __init__(self, prompt: np.ndarray, max_new: int,
                 stream: GenerationStream):
        self.prompt = prompt
        self.max_new = max_new
        self.stream = stream
        self.submit_t = _time.monotonic()  # → queue-wait histogram


class ContinuousBatchingEngine:
    """Batched multi-stream greedy generation over one transformer model.

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
    device: where the engine computes; None → the package device
        (``cuda:0`` unless ``set_device`` says otherwise).

    The other parameters keep the JAX engine's signature: each raises when
    it asks for an unported feature (see the module docstring), and
    ``seed`` and ``kv_blocks``/``speculate_layers`` have nothing to seed
    or size on the greedy, monolithic path.
    """

    #: process-wide sequence behind ``obs_name`` (engine0, engine1, ...)
    _OBS_SEQ = itertools.count()

    #: reserves a batch slot while its chunked prefill is in flight
    _RESERVED = object()

    #: minimum common-prefix length worth a warm (remainder-only)
    #: admission; exact whole-prompt hits are never thresholded
    PREFIX_MIN_REUSE = 4

    #: the K-step dispatch runs eagerly on a card too when True: set only
    #: by chip_smoke.py and the card's tests, to compare the captured
    #: program with its body (the JAX engine has no such switch)
    _eager_dispatch = False

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
        from nnstreamer_tpu_torch.utils.stats import InvokeStats

        if mesh is not None:
            raise not_ported("multi-device serving (mesh=)", "A.24")
        if int(block_tokens or 0) > 0:
            raise not_ported("the paged KV cache (block_tokens > 0)",
                             "A.13.3")
        if int(speculate or 0) > 0:
            raise not_ported("speculative decoding (speculate > 0)",
                             "A.13.4")
        if attention not in ("auto", "reference"):
            raise ValueError(
                f"serving: attention must be 'auto' or 'reference', got "
                f"{attention!r}")
        #: the one sampling function; raises for the unported sampled path
        self._sample = make_sampler(cfg.vocab, float(temperature),
                                    int(top_k), float(min_p),
                                    with_logprobs=True)

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
        if attention == "auto" and self.device.type == "cuda" and \
                not kernel_takes(cfg.head_dim):
            raise ValueError(
                f"serving: kernel B2 does not take head_dim "
                f"{cfg.head_dim} (a multiple of 8, at most 256); pass "
                "attention='reference' for plain attention")
        self.params = prepare_params(params, cfg, self.device)
        self._auto_k = steps_per_dispatch == "auto"
        self.K = 8 if self._auto_k else int(steps_per_dispatch)
        self.eos_id = eos_id
        self.min_bucket = int(min_bucket)

        self._prefill_fn = build_prefill(
            cfg, self.S,
            attention_fn=flash_attention if attention == "auto" else None,
            kv_codec=kv_quant)
        self._init_cache = lambda: init_cache(cfg, self.B, self.S,
                                              kv_codec=kv_quant,
                                              device=self.device)
        self._init_cache1 = lambda: init_cache(cfg, 1, self.S,
                                               kv_codec=kv_quant,
                                               device=self.device)

        # host-side per-slot state
        self._pos = np.zeros(self.B, np.int64)
        self._last = np.zeros(self.B, np.int32)
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

        self._cache = self._init_cache()
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

    # -- device helpers -------------------------------------------------------
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device without a stream sync
        (pinned staging, asynchronous copy)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

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

    def _dispatch(self, token: torch.Tensor, pos: torch.Tensor):
        """K greedy decode steps: ([B] token, [B] pos) → ([B, K] tokens,
        [B, K] logprobs, last token, advanced pos), all on the device. The
        body of :class:`_DecodeProgram`."""
        toks, lps = [], []
        for _ in range(self.K):
            logits, _ = self._decode(self.params, token, self._cache, pos)
            token, _, lp = self._sample(logits)
            toks.append(token)
            lps.append(lp)
            pos = pos + 1
        return torch.stack(toks, 1), torch.stack(lps, 1), token, pos

    def _ensure_program(self, warm: bool) -> _DecodeProgram:
        """The program at the current K, built (and, on a card, captured)
        if there is none at that K. ``warm`` as in
        :meth:`_DecodeProgram.capture`: only start() asks for it."""
        if self._program is not None and self._program.K == self.K:
            return self._program
        self._drop_program()
        prog = _DecodeProgram(self)
        if self.device.type == "cuda" and not self._eager_dispatch:
            with torch.cuda.device(self.device):
                if self._capture_stream is None:
                    self._capture_stream = torch.cuda.Stream(self.device)
                prog.capture(self._capture_stream, warm)
            self.graph_stats["captures"].append(self.K)
            self.graph_stats["capture_s"] += prog.capture_s
        self._program = prog
        self._reload = True
        return prog

    def _drop_program(self) -> None:
        if self._program is not None:
            self._program.release()
            self._program = None

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
        (admission overwrites a slot's whole KV)."""
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
                    self._cache = None
                    self._cache = self._init_cache()
            # no stream is live before the loop starts: the program may
            # warm up on the cache (a capture error raises here)
            self._ensure_program(warm=True)
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="cb-engine", daemon=True)
        self._thread.start()
        return self

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
                backlog = self._pending.qsize() + sum(
                    1 for s in self._slots if s is not None)
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
        self._prefix[key] = (kv, logits)
        self._prefix.move_to_end(key)
        while len(self._prefix) > self.prefix_cache:
            evicted, _ = self._prefix.popitem(last=False)
            self._prefix_trie.remove(evicted)

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
            self._prefix_store(prompt, cache1, logits_last)
            self._activate(req, slot, logits_last, cache1)
        except Exception as e:  # noqa: BLE001 — a failed chunk must free
            # the reserved slot and fail only this request
            log.warning("serving: chunked prefill failed: %s", e)
            self._partial = None
            self._slots[slot] = None
            req.stream._finish(f"error: {e}")

    def _activate_begin(self, req: _PendingRequest, slot: int, logits,
                        cache1):
        """Device half of an activation: sample the first token, write the
        prompt's KV into the slot (the whole slot, in place: the captured
        program reads the cache where it is), and CLAIM the slot. Returns
        ``(req, slot, first_d, lp_d)``."""
        first_d, _, lp_d = self._sample(logits)
        self._cache.map(lambda t: t[:, :, slot]).copy_(
            cache1.map(lambda t: t[:, :, 0]))
        self._slots[slot] = req.stream  # claimed; mirrors land at commit
        return (req, slot, first_d, lp_d)

    def _activate(self, req: _PendingRequest, slot: int, logits,
                  cache1) -> None:
        """Single-admission tail (the chunked path): begin, one host sync,
        commit."""
        rec = self._activate_begin(req, slot, logits, cache1)
        self._sync_host_state()
        self._commit_wave([rec])

    def _activate_commit(self, rec, first: int, first_lp: float) -> None:
        """Host half: install the per-slot host mirrors and emit the first
        token. Callers run :meth:`_sync_host_state` after the begins and
        before the first commit."""
        req, slot, _, _ = rec
        n = req.prompt.size
        self.stats["prefills"] += 1
        self._pos[slot] = n
        self._last[slot] = first
        # cap generation so cache writes stay inside the slot's S window
        self._budget[slot] = min(req.max_new, self.S - n)
        t0 = getattr(req.stream, "submit_t", None)
        if t0 is not None:
            self._lm_stats.observe_ttft(_time.monotonic() - t0)
        req.stream._emit(first, first_lp)
        self.stats["tokens_generated"] += 1
        self._post_emit(slot, first)

    def _commit_wave(self, admitted) -> None:
        """Fetch a whole admission wave's first tokens in one copy, then
        commit each; a failed commit fails only its stream."""
        (firsts, lps), event = self._fetch_async(
            torch.cat([rec[2] for rec in admitted]),
            torch.cat([rec[3] for rec in admitted]))
        if event is not None:
            event.synchronize()
        firsts, lps = firsts.numpy(), lps.numpy()
        for i, rec in enumerate(admitted):
            try:
                self._activate_commit(rec, int(firsts[i]), float(lps[i]))
            except Exception as e:  # noqa: BLE001 — fail only this
                # stream; the slot frees for the next prompt
                log.warning("serving: activate failed: %s", e)
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
        self._cache = None
        self._cache = self._init_cache()
        self._reload = True

    def _loop(self):
        # grad mode is per thread: this thread enters inference mode itself
        with torch.inference_mode():
            if self.device.type == "cuda":
                with torch.cuda.device(self.device):
                    self._loop_mono()
            else:
                self._loop_mono()

    def _loop_mono(self):
        while not self._stop_evt.is_set():
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
                    self._commit_wave(admitted)
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
            try:
                t0 = _time.monotonic()
                prog = self._ensure_program(warm=False)
                if self._reload:
                    prog.load(self._last, self._pos)
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
