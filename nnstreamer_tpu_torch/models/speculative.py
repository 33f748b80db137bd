"""Speculative decoding — draft and verify, with greedy-exact output.

The JAX package's ``models/speculative.py`` in PyTorch. A round turns γ
sequential target-model steps into

  1. γ cheap draft-model steps,
  2. one target-model chunk pass over the γ+1 candidate positions
     (``build_chunk_decode``: a ``[γ+1, d_model]`` matmul per layer), and
  3. a vectorized accept — no host control flow.

Greedy acceptance: the emitted stream is identical to target-only greedy
decoding; speculation changes the schedule, never the output.

**Rewind-free cache contract.** A rejected suffix needs no cleanup: both
models write slot i before any query attends it (the ``slot <= pos`` mask
admits slot i only once pos reaches i), so stale k/v past the accepted
prefix is unreachable and is overwritten when generation gets there.
Resetting ``pos`` to the accept point is the rewind.

Where the JAX module scans, conds and loops on the device, this one
writes the caches in place and

- runs ``lax.scan``'s fixed count as a Python loop;
- makes ``lax.cond``'s skipped round a masked update: every round runs,
  and one that may not (the cache window is exhausted, or the count limit
  is reached) leaves the state and the token buffer as they were;
- drives ``lax.while_loop`` (``fused=True``) from the host: replays of the
  R-round dispatch until ``count >= max_new``, one host read each.

:class:`SpeculativeDecoder` keeps its caches and the dispatch's state in
static buffers: on the card the R-round dispatch is one CUDA graph,
captured once per decoder and replayed; on the CPU it runs its body.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from nnstreamer_tpu_torch.device import resolve_device
from nnstreamer_tpu_torch.models.transformer import (
    TransformerConfig,
    build_chunk_decode,
    build_decode_step,
    build_prefill,
    init_cache,
    prepare_params,
)
from nnstreamer_tpu_torch.ops import _counts


def build_speculative_round(target_cfg: TransformerConfig,
                            draft_cfg: TransformerConfig,
                            gamma: int = 4,
                            max_seq: Optional[int] = None) -> Callable:
    """``round(target_params, draft_params, last_tok[int b], target_cache,
    draft_cache, pos[int b]) -> (tokens[b, γ+1], n_emit[b], target_cache,
    draft_cache, new_pos)``, the caches written in place.

    ``tokens[:, :n_emit]`` are the round's emitted ids (greedy-exact
    against the target); ``n_emit`` ∈ [1, γ+1]: the accepted drafts plus
    the target's correction, or all γ plus its bonus token. Entries past
    ``n_emit`` are speculative garbage the caller ignores. Batch must be
    1: the accept decision is a single prefix length."""
    if target_cfg.vocab != draft_cfg.vocab:
        raise ValueError(
            f"speculative: target vocab {target_cfg.vocab} != draft vocab "
            f"{draft_cfg.vocab}")
    if gamma < 1:
        raise ValueError(f"speculative: gamma must be >= 1, got {gamma}")
    s_max = max_seq or target_cfg.max_seq
    draft_step = build_decode_step(draft_cfg, s_max)
    target_chunk = build_chunk_decode(target_cfg, s_max)

    def spec_round(target_params, draft_params, last_tok, target_cache,
                   draft_cache, pos):
        if last_tok.shape[0] != 1:
            raise ValueError(
                f"speculative: batch must be 1 (got {last_tok.shape[0]}) "
                "— the accept prefix is a single length; run one decoder "
                "per stream")
        pos = torch.as_tensor(pos, device=last_tok.device).long().reshape(1)
        tok, dpos, drafts = last_tok, pos, []
        for _ in range(gamma):
            logits, _ = draft_step(draft_params, tok, draft_cache, dpos)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            drafts.append(tok)
            dpos = dpos + 1
        drafts = torch.stack(drafts, 1)                     # [1, γ]
        # the steps wrote k/v for [last, d_1..d_{γ-1}] at pos..pos+γ-1 but
        # not d_γ's: on full acceptance the next round starts past slot
        # pos+γ, whose k/v must be d_γ's — one more write closes the hole
        draft_step(draft_params, tok, draft_cache, dpos)
        # the target scores positions pos..pos+γ in one chunk over [last,
        # d_1..d_γ]; logits[:, i] predicts position pos+i+1
        chunk_toks = torch.cat([last_tok[:, None], drafts], dim=1)
        logits, _ = target_chunk(target_params, chunk_toks, target_cache,
                                 pos)
        target_toks = torch.argmax(logits, dim=-1).to(torch.int32)
        match = drafts[0] == target_toks[0, :gamma]         # [γ]
        # the first mismatch (γ when every draft matches)
        n_acc = torch.argmin(torch.cat(
            [match, match.new_zeros(1)]).to(torch.int32))
        ar = torch.arange(gamma + 1, device=drafts.device)
        out = torch.where(
            ar[None, :] < n_acc,
            torch.cat([drafts, drafts[:, -1:]], dim=1),
            torch.gather(target_toks, 1,
                         torch.clamp(n_acc, max=gamma).reshape(1, 1)
                         .expand(1, gamma + 1)))
        n_emit = (n_acc + 1).reshape(1)
        return out, n_emit, target_cache, draft_cache, pos + n_emit

    return spec_round


def build_speculative_dispatch(target_cfg: TransformerConfig,
                               draft_cfg: TransformerConfig,
                               gamma: int = 4,
                               rounds: int = 8,
                               max_seq: Optional[int] = None) -> Callable:
    """R speculative rounds in one call: ``dispatch(tp, dp, last_tok[1],
    t_cache, d_cache, pos[1], limit=None) -> (buf[1, R*(γ+1)],
    n_emits[R], last_tok, t_cache, d_cache, pos)``.

    Emitted tokens append into ``buf`` at the running count (each round's
    write overwrites the previous round's speculative tail), so the host
    reads once per R rounds; ``buf[:, :sum(n_emits)]`` is valid. A round
    that would write past the cache window, or that would start with the
    dispatch's count at ``limit`` (a host-driven fused generation's
    remaining budget; None: no limit), is skipped and reports ``n_emit =
    0``: all its state updates are masked, at fixed shapes."""
    spec_round = build_speculative_round(target_cfg, draft_cfg, gamma,
                                         max_seq)
    s_max = max_seq or target_cfg.max_seq
    width = gamma + 1

    def dispatch(target_params, draft_params, last_tok, t_cache, d_cache,
                 pos, limit=None):
        dev = last_tok.device
        buf = torch.zeros((1, rounds * width), dtype=torch.int32,
                          device=dev)
        pos = torch.as_tensor(pos, device=dev).long().reshape(1)
        count = torch.zeros((1,), dtype=torch.int64, device=dev)
        ar = torch.arange(width, device=dev)
        n_emits = []
        for _ in range(rounds):
            toks, n_emit, _, _, _ = spec_round(
                target_params, draft_params, last_tok, t_cache, d_cache,
                pos)
            run = pos + gamma < s_max
            if limit is not None:
                run = run & (count < limit)
            idx = torch.clamp(count[:, None] + ar[None, :],
                              max=rounds * width - 1)
            buf = torch.where(run[:, None], buf.scatter(1, idx, toks), buf)
            new_last = torch.gather(toks, 1, (n_emit - 1)[:, None])[:, 0]
            last_tok = torch.where(run, new_last, last_tok)
            n_emit = torch.where(run, n_emit, torch.zeros_like(n_emit))
            pos = pos + n_emit
            count = count + n_emit
            n_emits.append(n_emit)
        return (buf, torch.cat(n_emits), last_tok, t_cache, d_cache, pos)

    return dispatch


#: rounds per host-driven dispatch of build_speculative_generate, the
#: SpeculativeDecoder's default ``rounds_per_dispatch``
_GEN_ROUNDS = 4


def _host_generate(run_dispatch, max_new: int, host_read):
    """The host-driven ``lax.while_loop``: dispatches of R rounds, each
    under the remaining budget, until ``max_new`` tokens are out or a
    dispatch emits none (the cache window is exhausted). ``run_dispatch(
    limit)`` runs one; ``host_read()`` fetches its ``(buf, n_emits)`` as
    numpy (the one host read a dispatch). Returns ``(tokens, count,
    rounds, reads)``."""
    out, count, rounds, reads = [], 0, 0, 0
    while count < max_new:
        run_dispatch(max_new - count)
        buf, n_emits = host_read()
        reads += 1
        c = int(n_emits.sum())
        if c == 0:
            break
        out.extend(buf[0, :c].tolist())
        count += c
        rounds += int((n_emits > 0).sum())
    return out, count, rounds, reads


def build_speculative_generate(target_cfg: TransformerConfig,
                               draft_cfg: TransformerConfig,
                               gamma: int,
                               max_new: int,
                               max_seq: Optional[int] = None) -> Callable:
    """A whole greedy generation: ``gen(tp, dp, last_tok[1], t_cache,
    d_cache, pos) -> (buf[1, max_new+γ], tensor([count, rounds]))``, the
    JAX function's outputs. Its ``lax.while_loop`` is driven from the host
    here: dispatches of ``_GEN_ROUNDS`` rounds until ``count >= max_new``
    or the cache window ends, one host read each. ``buf[:, :min(count,
    max_new)]`` is the output."""
    dispatch = build_speculative_dispatch(target_cfg, draft_cfg, gamma,
                                          _GEN_ROUNDS, max_seq)
    width = max_new + gamma  # the last round may overshoot by <= γ

    def gen(target_params, draft_params, last_tok, t_cache, d_cache, pos):
        state = {"last": last_tok, "pos": pos}

        def run_dispatch(limit):
            state["buf"], state["n"], state["last"], _, _, state["pos"] = \
                dispatch(target_params, draft_params, state["last"],
                         t_cache, d_cache, state["pos"], limit)

        def host_read():
            return state["buf"].cpu().numpy(), state["n"].cpu().numpy()

        toks, count, n_rounds, _ = _host_generate(run_dispatch, max_new,
                                                  host_read)
        buf = torch.zeros((1, width), dtype=torch.int32,
                          device=last_tok.device)
        buf[0, :len(toks)] = torch.as_tensor(toks, dtype=torch.int32)
        return buf, torch.tensor([count, n_rounds])

    return gen


class _Dispatch(_counts.GraphProgram):
    """:func:`build_speculative_dispatch` over the decoder's static
    buffers: ``last [1]``, ``pos [1]`` and ``limit [1]`` in; ``buf`` and
    ``n_emits`` out, and the advanced ``last`` and ``pos`` written back,
    so the next run chains off them."""

    def __init__(self, dec: "SpeculativeDecoder"):
        super().__init__(dec.device)
        self.dec = dec
        dev = dec.device
        self.last = torch.zeros((1,), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.limit = torch.zeros((1,), dtype=torch.int64, device=dev)
        width = dec.R * (dec.gamma + 1)
        self.buf = torch.zeros((1, width), dtype=torch.int32, device=dev)
        self.n_emits = torch.zeros((dec.R,), dtype=torch.int64, device=dev)

    def body(self) -> None:
        d = self.dec
        buf, n_emits, last, _, _, pos = d._dispatch_fn(
            d.tp, d.dp, self.last, d._t_cache, d._d_cache, self.pos,
            self.limit)
        self.buf.copy_(buf)
        self.n_emits.copy_(n_emits)
        self.last.copy_(last)
        self.pos.copy_(pos)


class SpeculativeDecoder:
    """Host-side generation loop around the R-round dispatch.

    One target and one draft model, greedy, batch 1. The host reads one
    ``[R*(γ+1)]`` token buffer per dispatch; with ``fused=True`` the whole
    generation is one call of :meth:`generate` whose dispatches run under
    the remaining budget (the JAX class's one-program generation, driven
    from the host). ``stats`` counts as the JAX class counts: a fused
    generation is one dispatch; ``host_reads`` counts the reads.

    ``target_params`` and ``draft_params`` are fp32 masters (or params
    already prepared for ``cfg.dtype``): they are prepared and moved to
    ``device`` (None → the package device). The target's prefill runs
    kernel B2 on the card (its plain version on the CPU), as the engine's
    does; the draft's prefill is plain, as the engine's is."""

    def __init__(self, target_cfg: TransformerConfig, target_params: Any,
                 draft_cfg: TransformerConfig, draft_params: Any,
                 gamma: int = 4, rounds_per_dispatch: int = _GEN_ROUNDS,
                 max_seq: Optional[int] = None, device=None):
        from nnstreamer_tpu_torch.ops.flash_attention import flash_attention

        self.device = resolve_device() if device is None \
            else torch.device(device)
        self.tc = target_cfg
        self.dc = draft_cfg
        self.tp = prepare_params(target_params, target_cfg, self.device)
        self.dp = prepare_params(draft_params, draft_cfg, self.device)
        self.gamma = int(gamma)
        self.R = int(rounds_per_dispatch)
        self.S = int(max_seq or target_cfg.max_seq)
        self._dispatch_fn = build_speculative_dispatch(
            target_cfg, draft_cfg, self.gamma, self.R, self.S)
        self._prefill_t = build_prefill(target_cfg, self.S,
                                        attention_fn=flash_attention)
        self._prefill_d = build_prefill(draft_cfg, self.S)
        #: the caches the dispatch reads and writes, where it captured
        #: them; each generation's prefill is copied in
        self._t_cache = init_cache(target_cfg, 1, self.S, device=self.device)
        self._d_cache = init_cache(draft_cfg, 1, self.S, device=self.device)
        self._program: Optional[_Dispatch] = None
        self._stream = None
        self.stats = {"rounds": 0, "tokens": 0, "dispatches": 0,
                      "host_reads": 0}
        #: captures of the dispatch and their seconds (the card only)
        self.graph_stats = {"captures": 0, "capture_s": 0.0, "replays": 0}

    def _ensure_program(self) -> _Dispatch:
        if self._program is None:
            prog = _Dispatch(self)
            if self.device.type == "cuda":
                with torch.cuda.device(self.device):
                    self._stream = torch.cuda.Stream(self.device)
                    # the warm-up writes the caches at slot 0 upward, which
                    # the next prefill overwrites
                    prog.capture(self._stream, warm=True)
                self.graph_stats["captures"] += 1
                self.graph_stats["capture_s"] += prog.capture_s
            self._program = prog
        return self._program

    def _upload(self, arr) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _run(self, limit: int) -> None:
        prog = self._program
        prog.limit.copy_(self._upload(np.asarray([limit], np.int64)))
        prog.run()
        if prog.graph is not None:
            self.graph_stats["replays"] += 1

    def _read(self):
        prog = self._program
        return prog.buf.cpu().numpy(), prog.n_emits.cpu().numpy()

    @torch.inference_mode()
    def generate(self, prompt, max_new_tokens: int = 64,
                 fused: bool = False) -> list:
        """Greedy generation, token-identical to target-only greedy
        decoding. ``fused=True`` runs the whole generation as one call:
        its dispatches run under the remaining budget, and the stats count
        it as one dispatch."""
        prompt = np.asarray(prompt, np.int32).reshape(1, -1)
        n = prompt.shape[1]
        if not 0 < n < self.S:
            raise ValueError(f"speculative: prompt length {n} must be in "
                             f"(0, {self.S})")
        prog = self._ensure_program()
        toks = self._upload(prompt)
        t_logits, t_cache = self._prefill_t(self.tp, toks)
        _, d_cache = self._prefill_d(self.dp, toks)
        self._t_cache.copy_(t_cache)
        self._d_cache.copy_(d_cache)
        first = torch.argmax(t_logits[0]).to(torch.int32).reshape(1)
        prog.last.copy_(first)
        prog.pos.fill_(n)
        out = [int(first.item())]
        if fused:
            m = max_new_tokens - 1  # minus the prefill-seeded first token
            if m > 0:
                toks, count, rounds, reads = _host_generate(
                    self._run, m, self._read)
                out.extend(toks)
                self.stats["dispatches"] += 1
                self.stats["tokens"] += count
                self.stats["rounds"] += rounds
                self.stats["host_reads"] += reads
            return out[:max_new_tokens]
        no_limit = self.R * (self.gamma + 1) + 1
        while len(out) < max_new_tokens:
            self._run(no_limit)
            buf, n_emits = self._read()
            self.stats["host_reads"] += 1
            count = int(n_emits.sum())
            if count == 0:
                break  # cache window exhausted — every round skipped
            out.extend(buf[0, :count].tolist())
            self.stats["dispatches"] += 1
            self.stats["rounds"] += int((n_emits > 0).sum())
            self.stats["tokens"] += count
        return out[:max_new_tokens]

    @property
    def mean_accepted(self) -> float:
        """Average tokens emitted per executed round (1.0 = no speculation
        win; γ+1 = every draft accepted)."""
        return self.stats["tokens"] / max(1, self.stats["rounds"])


def draft_from_target(cfg: TransformerConfig, params: Any,
                      n_layers: int) -> Tuple[TransformerConfig, Any]:
    """Depth-pruned self-speculative draft: the target's first
    ``n_layers`` layers (params are stacked ``[L, ...]``, so the draft is
    a slice: views, no copy) sharing the embedding and the final norm."""
    if not 0 < n_layers <= cfg.n_layers:
        raise ValueError(
            f"draft_from_target: n_layers must be in (0, {cfg.n_layers}], "
            f"got {n_layers}")
    draft_cfg = dataclasses.replace(cfg, n_layers=n_layers)
    draft_params = {
        k: (v if k in ("embed", "ln_f") else v[:n_layers])
        for k, v in params.items()
    }
    return draft_cfg, draft_params
