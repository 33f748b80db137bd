"""Beam search — width-W decoding on the card.

The JAX package's ``models/beam.py`` in PyTorch. The W beams ARE the
batch: every step decodes all beams in one KV-cached pass
(``models/transformer.build_decode_step``, positions per stream ``[W]``),
scores combine in fp32, and the top-W reselection's beam reordering is a
gather on the cache's batch axis of every leaf (the int8 codec's scales
too). No host round trip until the final sequences materialize.

Length handling: beams that emit ``eos_id`` freeze (their only
continuation is another EOS at zero cost), so finished hypotheses
compete with live ones under plain summed-logprob scoring.

Where the JAX search is one jitted program (``lax.scan`` over the steps),
this one runs its steps eagerly from a Python loop; the prefill uses
plain attention, as the JAX beam's ``build_prefill`` default does.
``lax.top_k`` and ``jnp.argsort`` put the lower index first on ties;
a stable sort reproduces that order here (``torch.topk``'s order on ties
is not specified).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from nnstreamer_tpu_torch.device import resolve_device
from nnstreamer_tpu_torch.models.transformer import (
    KVCache,
    Params,
    TransformerConfig,
    build_decode_step,
    build_prefill,
    prepare_params,
)

_NEG = -1e30


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` of a 1-D tensor: the k largest, descending, the lower
    index first on ties."""
    values, idx = torch.sort(x, descending=True, stable=True)
    return values[:k], idx[:k]


def _reorder(cache: KVCache, parents: torch.Tensor) -> KVCache:
    """Beam reordering: row i of every leaf (values and int8 scales alike,
    batch axis 2) takes row ``parents[i]``, in place."""
    return cache.copy_(cache.map(lambda a: a[:, :, parents]))


def build_beam_search(cfg: TransformerConfig, beam_width: int = 4,
                      max_new: int = 32,
                      max_seq: Optional[int] = None,
                      eos_id: Optional[int] = None) -> Callable:
    """Returns ``search(params, prompt[int 1, n]) -> (sequences[int32 W,
    max_new], scores[float32 W])``, best beam first.

    Scores are summed fp32 log-probabilities of the emitted tokens
    (verifiable by teacher-forced re-scoring). A beam that emits
    ``eos_id`` is finished: its sequence pads with EOS and its score
    freezes."""
    if not 0 < beam_width <= cfg.vocab:
        raise ValueError(f"beam_search: beam_width must be in (0, "
                         f"{cfg.vocab}], got {beam_width}")
    if max_new < 1:
        raise ValueError(f"beam_search: max_new must be >= 1, got "
                         f"{max_new}")
    W = int(beam_width)
    V = cfg.vocab
    s_max = max_seq or cfg.max_seq
    prefill = build_prefill(cfg, s_max)
    decode = build_decode_step(cfg, s_max)

    def search(params, prompt):
        dev = prompt.device
        n = prompt.shape[1]
        logits, cache1 = prefill(params, prompt)          # [1, V], S slots
        scores, toks0 = _top_k(torch.log_softmax(logits[0].float(), -1), W)
        # beams as batch: the prompt's cache on W rows
        cache = cache1.map(lambda a: a.repeat_interleave(W, dim=2))
        seqs = torch.zeros((W, max_new), dtype=torch.int32, device=dev)
        seqs[:, 0] = toks0
        done = torch.zeros((W,), dtype=torch.bool, device=dev) \
            if eos_id is None else toks0 == eos_id
        if eos_id is not None:
            # finished beams: only EOS continues, at zero cost, so the
            # frozen hypothesis competes under its final score
            eos_row = torch.full((V,), _NEG, dtype=torch.float32, device=dev)
            eos_row[eos_id] = 0.0
        last = toks0.to(torch.int32)
        pos = torch.full((W,), n, dtype=torch.int64, device=dev)
        for m in range(1, max_new):
            logits, cache = decode(params, last, cache, pos)   # [W, V]
            logp = torch.log_softmax(logits.float(), dim=-1)
            if eos_id is not None:
                logp = torch.where(done[:, None], eos_row[None, :], logp)
            total = scores[:, None] + logp                     # [W, V]
            scores, flat_idx = _top_k(total.reshape(-1), W)
            parents = flat_idx // V
            toks = (flat_idx % V).to(torch.int32)
            cache = _reorder(cache, parents)
            seqs = seqs[parents]
            seqs[:, m] = toks
            done = done[parents]
            if eos_id is not None:
                done = done | (toks == eos_id)
            last = toks
            pos = pos + 1
        order = torch.sort(-scores, stable=True).indices
        return seqs[order], scores[order]

    return search


class BeamSearcher:
    """Host-side convenience around the search, on the package device
    (``cuda:0`` unless ``set_device`` or ``device`` says otherwise)."""

    def __init__(self, cfg: TransformerConfig, params: Params,
                 beam_width: int = 4, max_new: int = 32,
                 max_seq: Optional[int] = None,
                 eos_id: Optional[int] = None, device=None):
        self.cfg = cfg
        self.max_new = int(max_new)
        self.S = int(max_seq or cfg.max_seq)
        self.device = resolve_device() if device is None \
            else torch.device(device)
        self._search = build_beam_search(cfg, beam_width, max_new, self.S,
                                         eos_id)
        self.params = prepare_params(params, cfg, self.device)
        self.eos_id = eos_id

    def search(self, prompt) -> Tuple[np.ndarray, np.ndarray]:
        """(sequences [W, max_new], scores [W]) — best first. Sequences
        of finished beams pad with ``eos_id`` after their EOS."""
        prompt = np.asarray(prompt, np.int32).reshape(1, -1)
        # decode steps 1..max_new-1 write slots n..n+max_new-2; the last
        # must fit slot S-1
        limit = self.S - self.max_new + 1
        if not 0 < prompt.shape[1] <= limit:
            raise ValueError(
                f"beam_search: prompt length {prompt.shape[1]} must be in "
                f"(0, {limit}] so every step's cache write fits")
        with torch.inference_mode():
            seqs, scores = self._search(
                self.params, torch.from_numpy(prompt).to(self.device))  # nns-lint: disable=NNS113 -- a few prompt ids; the params and the beam cache are the tracked bytes
        return seqs.cpu().numpy(), scores.cpu().numpy()
