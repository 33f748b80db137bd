"""Decoder-only transformer LM — the model behind LM serving.

The JAX package's ``models/transformer.py`` on its single-device path, in
PyTorch: the same parameter dict (layers stacked on a leading L axis),
the same seeded weights, and the same layer math:

- pre-norm RMSNorm and rotary position embeddings, computed in fp32 and
  cast back to the model dtype;
- attention through a pluggable ``attention_fn`` (the plain
  :func:`~nnstreamer_tpu_torch.ops.flash_attention.attention_reference`
  by default; the serving engine plugs in the flash kernel for prefill);
- a dense GELU FFN (tanh form, as ``jax.nn.gelu``'s default) or a top-1
  MoE FFN;
- fp32 logits against the fp32 tied embedding.

Where the JAX package scans one compiled layer body over the stacked
params, this module runs a Python loop over layers; where it relies on
donation to update the KV cache, the decode and chunk steps write the
cache's tensors in place and return it. A cache is a :class:`KVCache`
for both codecs: the raw one (the model dtype) and the int8 one
(per-vector absmax scales, ``kv_codec="int8"``).

The paged KV cache (``serving/kvpool.py``) has its builders here too:
:func:`build_paged_decode_step` and :func:`build_paged_chunk` gather each
row's block table into the contiguous ``[b, S, ...]`` layout the shared
attention core reads, so a paged cache gives the monolithic cache's
tokens. Their scatters never index out of range (a CUDA device-side
assert): a write the JAX package drops (``mode="drop"``) lands in the
arena's private trash block, at the same fixed shape.

Not ported yet, each raising with its ROADMAP item: the sampled path —
``temperature > 0``, ``top_k``, ``min_p`` (A.13.5). The repo-loop stream
steps wait for A.13.6.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from nnstreamer_tpu_torch.ops.flash_attention import (
    NEG_BIG,
    attention_reference,
    flash_attention,
)
from nnstreamer_tpu_torch.pipeline.element import not_ported
from nnstreamer_tpu_torch.tensors.types import TensorsInfo

Params = Dict[str, torch.Tensor]

#: parameters that enter a matmul in the model dtype (``.astype(dtype)`` in
#: the JAX package); every other one stays fp32
MATMUL_WEIGHTS = ("qkv", "proj", "w_in", "w_out")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_seq: int = 2048
    dtype: torch.dtype = torch.bfloat16
    num_experts: int = 0  # 0 → dense FFN; >0 → top-1 MoE

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def init_params(cfg: TransformerConfig, seed: int = 0) -> Params:
    """fp32 master weights on the CPU, drawn in the JAX package's order
    from ``numpy.random.default_rng(seed)`` — bit-identical to its
    ``init_params``."""
    rng = np.random.default_rng(seed)

    def norm(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32) * 0.02)

    L, D, H, Dh, F_ = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim,
                       cfg.d_ff)
    p = {
        "embed": norm(cfg.vocab, D),
        "ln1": torch.ones((L, D), dtype=torch.float32),
        "qkv": norm(L, D, 3, H, Dh),
        "proj": norm(L, H, Dh, D),
        "ln2": torch.ones((L, D), dtype=torch.float32),
        "ln_f": torch.ones((D,), dtype=torch.float32),
    }
    if cfg.num_experts:
        p["router"] = norm(L, D, cfg.num_experts)
        p["w_in"] = norm(L, cfg.num_experts, D, F_)
        p["w_out"] = norm(L, cfg.num_experts, F_, D)
    else:
        p["w_in"] = norm(L, D, F_)
        p["w_out"] = norm(L, F_, D)
    return p


def params_from_jax(np_params: Dict[str, Any]) -> Params:
    """The JAX package's parameter dict, as numpy arrays (``np.asarray`` of
    each leaf), → this module's fp32 tensors on the CPU."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in np_params.items()}


def prepare_params(params: Params, cfg: TransformerConfig,
                   device=None) -> Params:
    """Params for serving: the matmul weights cast to ``cfg.dtype`` once
    (each matmul would cast them anyway: same values), everything else —
    the embedding read by the fp32 logits, the norm scales, the MoE router
    — kept fp32; all on ``device``."""
    return {k: v.to(device=device,
                    dtype=cfg.dtype if k in MATMUL_WEIGHTS else torch.float32)
            for k, v in params.items()}


# -- the shared layer math ---------------------------------------------------
def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary embeddings; x [b, s, h, d], positions [b, s]."""
    half = x.shape[-1] // 2
    ar = torch.arange(half, dtype=torch.float32, device=x.device)
    # torch.full, not torch.tensor: a host-to-card copy cannot be captured
    # in a CUDA graph (serving/engine.py captures the decode step)
    freqs = torch.exp(torch.full((), -math.log(10000.0), dtype=torch.float32,
                                 device=x.device) * ar / half)
    angles = positions[..., None].float() * freqs          # [b, s, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _gelu(h: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to approximate=True: the tanh form
    return F.gelu(h, approximate="tanh")


def _dense_ffn(x, w_in, w_out, dtype):
    h = _gelu(torch.matmul(x, w_in.to(dtype)))
    return torch.matmul(h, w_out.to(dtype))


def _moe_ffn(x, router, w_in, w_out, dtype):
    """Top-1 routed MoE, the JAX package's one-hot dispatch form."""
    logits = torch.einsum("bsd,de->bse", x.float(), router.float())
    gate = torch.softmax(logits, dim=-1)
    top = torch.argmax(gate, dim=-1)                        # [b, s]
    onehot = F.one_hot(top, router.shape[-1]).to(dtype)     # [b, s, e]
    weight = torch.gather(gate, -1, top[..., None])[..., 0].to(dtype)
    h = torch.einsum("bsd,bse,edf->bsef", x, onehot, w_in.to(dtype))
    h = _gelu(h)
    out = torch.einsum("bsef,efd->bsed", h, w_out.to(dtype))
    return torch.sum(out * onehot[..., None], dim=2) * weight[..., None]


def _block_qkv(x, lp, positions, dtype):
    """Pre-norm + qkv projection + rope, shared by every forward variant.
    q and k come back rope'd (new tensors); v is a view of the one
    projection output ``[b, s, 3, h, dh]``."""
    h = _rmsnorm(x, lp["ln1"])
    w = lp["qkv"].to(dtype)                                 # [d, 3, h, c]
    b, s, _ = x.shape
    qkv = torch.matmul(h, w.reshape(w.shape[0], -1)).view(
        b, s, *w.shape[1:])                                 # [b, s, 3, h, c]
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return _rope(q, positions), _rope(k, positions), v


def _block_tail(x, a, lp, cfg):
    """Attention-output projection + residual + FFN block."""
    dtype = cfg.dtype
    b, s = a.shape[:2]
    proj = lp["proj"].to(dtype)                             # [h, c, d]
    x = x + torch.matmul(a.reshape(b, s, -1),
                         proj.reshape(-1, proj.shape[-1]))
    h2 = _rmsnorm(x, lp["ln2"])
    if cfg.num_experts:
        return x + _moe_ffn(h2, lp["router"], lp["w_in"], lp["w_out"],
                            dtype)
    return x + _dense_ffn(h2, lp["w_in"], lp["w_out"], dtype)


def _attend_cache(q, ck, cv, mask, head_dim, dtype):
    """The cached-attention core of decode: fp32 scores (the scale applied
    after QK, as in attention_reference), fp32 softmax and fp32
    probs × values, rounding only the output."""
    scores = torch.einsum("bqhc,bshc->bhqs", q.float(), ck.float())
    scores = scores * head_dim ** -0.5
    scores = torch.where(mask, scores, NEG_BIG)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqs,bshc->bqhc", probs, cv.float()).to(dtype)


def _final_logits(x, params):
    """Final rmsnorm + tied-embedding projection in fp32."""
    x = _rmsnorm(x, params["ln_f"])
    return torch.matmul(x.float(), params["embed"].t())


def _layer(params: Params, l: int) -> Params:
    """Layer ``l``'s slice of the stacked per-layer params."""
    return {k: v[l] for k, v in params.items() if k not in ("embed", "ln_f")}


def _embed(params: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    # embed.astype(dtype)[tokens]: gather then cast gives the same values
    # without casting the whole table
    return params["embed"][tokens.long()].to(dtype)


def make_layer_body(cfg: TransformerConfig,
                    attention_fn: Optional[Callable] = None,
                    capture_kv: bool = False) -> Callable:
    """One transformer block: ``layer_body(x, positions, lp) -> (x, kv)``
    with ``kv`` the layer's rope'd ``stack([k, v])`` when ``capture_kv``
    (prefill seeds the decode cache with it), else None."""
    attn = attention_fn or attention_reference
    dtype = cfg.dtype

    def layer_body(x, positions, lp):
        q, k, v = _block_qkv(x, lp, positions, dtype)
        a = attn(q, k, v)                                   # [b, s, h, dh]
        x = _block_tail(x, a, lp, cfg)
        return x, (torch.stack([k, v]) if capture_kv else None)

    return layer_body


def _positions(b: int, s: int, device, offset=0) -> torch.Tensor:
    return (offset + torch.arange(s, dtype=torch.int32, device=device)
            )[None, :].expand(b, s)


def build_forward(cfg: TransformerConfig,
                  attention_fn: Optional[Callable] = None) -> Callable:
    """``apply_fn(params, tokens[int b, s]) -> logits[b, s, vocab]``."""
    dtype = cfg.dtype
    layer_body = make_layer_body(cfg, attention_fn)

    def apply_fn(params, tokens, position_offset=0):
        b, s = tokens.shape
        positions = _positions(b, s, tokens.device, position_offset)
        x = _embed(params, tokens, dtype)
        for l in range(cfg.n_layers):
            x, _ = layer_body(x, positions, _layer(params, l))
        return _final_logits(x, params)

    return apply_fn


@dataclasses.dataclass
class KVCache:
    """A KV cache: ``values [L, 2, b, S, h, dh]`` (k = 0, v = 1) in the
    model dtype, or int8 beside fp32 per-vector ``scale [L, 2, b, S, h]``
    (the int8 codec). Every tensor has the same leading axes, so a view of
    one layer, one batch slot or the first n slots is the same view of
    each (:meth:`map`), and :meth:`copy_` writes one cache into another in
    place: the decode step a CUDA graph captured keeps reading the same
    storage."""

    values: torch.Tensor
    scale: Optional[torch.Tensor] = None

    def leaves(self) -> Tuple[torch.Tensor, ...]:
        return (self.values,) if self.scale is None else (self.values,
                                                          self.scale)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "KVCache":
        return KVCache(fn(self.values),
                       None if self.scale is None else fn(self.scale))

    def copy_(self, src: "KVCache") -> "KVCache":
        for dst, s in zip(self.leaves(), src.leaves()):
            dst.copy_(s)
        return self

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.leaves())


def _slot_write(leaf: torch.Tensor, upd: torch.Tensor,
                start: torch.Tensor) -> None:
    """Write ``upd [2, b, c, ...]`` into a layer cache leaf ``[2, b, S,
    ...]`` at slots ``[start[r], start[r] + c)`` of each row r (in
    place; the callers keep the run inside the cache)."""
    b, c = upd.shape[1], upd.shape[2]
    rows = torch.arange(b, device=leaf.device)[:, None]
    slots = start[:, None] + torch.arange(c, device=leaf.device)[None, :]
    leaf[:, rows, slots] = upd


def _paged_gather(pages: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Per-layer block gather: ``pages [NTOT + 1, 2, T, ...]`` (the pool's
    blocks, its ZERO block at NTOT - 1, its trash block at NTOT) + block
    table ``bt [b, MB]`` → contiguous ``[b, 2, MB*T, ...]`` k/v in
    global-slot order. Entries ≥ NTOT - 1 (the sentinel) clamp onto the
    ZERO block, so unallocated slots read exact zeros."""
    zero = pages.shape[0] - 2
    g = pages[torch.clamp(bt.long(), max=zero)]          # [b, MB, 2, T, ..]
    g = g.movedim(2, 1)                                  # [b, 2, MB, T, ..]
    b, two, mb, t = g.shape[:4]
    return g.reshape((b, two, mb * t) + tuple(g.shape[4:]))


def _paged_scatter(pages: torch.Tensor, upd: torch.Tensor,
                   blk: torch.Tensor, off: torch.Tensor) -> None:
    """Per-layer block scatter, in place: ``upd [b, c, 2, ...]`` into
    ``pages[blk, :, off]`` (``blk``/``off`` are ``[b, c]``). Block ids at
    or past the sentinel write the trash block (index NTOT, never read):
    the JAX package's dropped write at a fixed shape, so the ZERO block is
    never written and no index leaves the arena."""
    trash = pages.shape[0] - 1
    pages[torch.clamp(blk.long(), max=trash), :, off.long()] = upd


class _RawKVCodec:
    """Cache values in the model dtype."""

    def __init__(self, dtype):
        self.dtype = dtype

    def init(self, L, b, S, h, dh, device=None) -> KVCache:
        return KVCache(torch.zeros((L, 2, b, S, h, dh), dtype=self.dtype,
                                   device=device))

    def write(self, layer_cache: KVCache, kv, start) -> KVCache:
        """kv [2, b, c, h, dh] → slots [start[r], start[r] + c) of each row
        r (in place)."""
        _slot_write(layer_cache.values, kv.to(self.dtype), start)
        return layer_cache

    def read(self, layer_cache: KVCache):
        return layer_cache.values[0], layer_cache.values[1]

    def place_prefix(self, cache: KVCache, kv) -> KVCache:
        """kv [L, 2, b, s, h, dh] → cache slots [0, s) (in place)."""
        cache.values[:, :, :, :kv.shape[3]] = kv.to(self.dtype)
        return cache

    def paged_init(self, L, ntot, T, h, dh, device=None) -> KVCache:
        """Paged arena ``[L, NTOT + 1, 2, T, h, dh]``: leading L so each
        layer takes its own block-pool slice; ``serving/kvpool.py`` owns
        allocation (NTOT - 1 is the permanent ZERO block, NTOT the trash
        block)."""
        return KVCache(torch.zeros((L, ntot + 1, 2, T, h, dh),
                                   dtype=self.dtype, device=device))

    def paged_write(self, pages: KVCache, kv, blk, off) -> KVCache:
        """kv [2, b, c, h, dh] → pages[blk[b, c], :, off[b, c]] (in
        place)."""
        _paged_scatter(pages.values,
                       kv.to(self.dtype).permute(1, 2, 0, 3, 4), blk, off)
        return pages

    def paged_read(self, pages: KVCache, bt):
        g = _paged_gather(pages.values, bt)
        return g[:, 0], g[:, 1]


class _Int8KVCodec(_RawKVCodec):
    """int8 values [L, 2, b, S, h, dh] + per-vector absmax scales [L, 2, b,
    S, h] fp32: half the bytes of a bf16 cache (plus 4/dh for the scales).
    The scale is ``max(amax / 127, 1e-30)`` and the value
    ``clip(round(x / scale), -127, 127)`` with ``torch.round``'s half to
    even, as ``jnp.round``. Reads dequantize in fp32 right before the
    attention einsums, so ``_attend_cache`` is unchanged. Torch ops, as
    the JAX package leaves the codec to XLA (it has no ``pallas_call``):
    kernel B3 is per-tensor absmax, another function."""

    def __init__(self):
        super().__init__(torch.int8)

    @staticmethod
    def _q(kv):
        kf = kv.float()
        amax = torch.amax(torch.abs(kf), dim=-1, keepdim=True)
        scale = torch.clamp(amax / 127.0, min=1e-30)
        q = torch.clamp(torch.round(kf / scale), -127, 127).to(torch.int8)
        return q, scale[..., 0]

    def init(self, L, b, S, h, dh, device=None) -> KVCache:
        return KVCache(
            torch.zeros((L, 2, b, S, h, dh), dtype=torch.int8, device=device),
            torch.zeros((L, 2, b, S, h), dtype=torch.float32, device=device))

    def write(self, layer_cache: KVCache, kv, start) -> KVCache:
        q, s = self._q(kv)                 # [2, b, c, h, dh], [2, b, c, h]
        _slot_write(layer_cache.values, q, start)
        _slot_write(layer_cache.scale, s, start)
        return layer_cache

    def read(self, layer_cache: KVCache):
        deq = layer_cache.values.float() * layer_cache.scale[..., None]
        return deq[0], deq[1]

    def place_prefix(self, cache: KVCache, kv) -> KVCache:
        q, s = self._q(kv)                 # [L, 2, b, s, h, dh], [.., h]
        n = kv.shape[3]
        cache.values[:, :, :, :n] = q
        cache.scale[:, :, :, :n] = s
        return cache

    def paged_init(self, L, ntot, T, h, dh, device=None) -> KVCache:
        return KVCache(
            torch.zeros((L, ntot + 1, 2, T, h, dh), dtype=torch.int8,
                        device=device),
            torch.zeros((L, ntot + 1, 2, T, h), dtype=torch.float32,
                        device=device))

    def paged_write(self, pages: KVCache, kv, blk, off) -> KVCache:
        """The codec applied per written vector with the monolithic
        write's absmax math, so a paged int8 cache holds the monolithic
        int8 cache's bits."""
        q, s = self._q(kv)                 # [2, b, c, h, dh], [2, b, c, h]
        _paged_scatter(pages.values, q.permute(1, 2, 0, 3, 4), blk, off)
        _paged_scatter(pages.scale, s.permute(1, 2, 0, 3), blk, off)
        return pages

    def paged_read(self, pages: KVCache, bt):
        gq = _paged_gather(pages.values, bt)
        gs = _paged_gather(pages.scale, bt)
        deq = gq.float() * gs[..., None]
        return deq[:, 0], deq[:, 1]


def _kv_codec(cfg: TransformerConfig, kv_codec: Optional[str]):
    if kv_codec in (None, "raw"):
        return _RawKVCodec(cfg.dtype)
    if kv_codec == "int8":
        return _Int8KVCodec()
    raise ValueError(
        f"kv_codec must be None/'raw'/'int8', got {kv_codec!r}")


def init_cache(cfg: TransformerConfig, batch: int,
               max_seq: Optional[int] = None,
               kv_codec: Optional[str] = None, device=None) -> KVCache:
    """A zero KV cache of ``batch`` rows; ``kv_codec="int8"`` gives the
    quantized layout the matching ``build_*`` functions take."""
    s = max_seq or cfg.max_seq
    return _kv_codec(cfg, kv_codec).init(
        cfg.n_layers, batch, s, cfg.n_heads, cfg.head_dim, device)


def build_decode_step(cfg: TransformerConfig,
                      max_seq: Optional[int] = None,
                      kv_codec: Optional[str] = None) -> Callable:
    """KV-cached single-token decode: ``step(params, token[int b], cache,
    pos) -> (logits[b, vocab], cache)``. Each layer writes this position's
    k/v into the cache at ``pos`` (in place), then attends over the cache
    under a ``slot <= pos`` mask. ``pos`` is a scalar (all rows in step)
    or a ``[b]`` tensor (one position per row, the continuous-batching
    shape). Positions past the cache are clamped to its last slot, the
    JAX package's cache-length contract. ``kv_codec="int8"`` takes the
    matching ``init_cache(..., kv_codec="int8")`` cache."""
    dtype = cfg.dtype
    s_max = max_seq or cfg.max_seq
    codec = _kv_codec(cfg, kv_codec)

    def step(params, token, cache, pos):
        b = token.shape[0]
        dev = cache.device
        pos = torch.as_tensor(pos, device=dev).long()
        if pos.dim() == 0:
            pos = pos.expand(b)
        pos_c = torch.clamp(pos, max=s_max - 1)
        x = _embed(params, token, dtype)[:, None]           # [b, 1, d]
        positions = pos[:, None]
        slots = torch.arange(s_max, device=dev)
        mask = slots[None, None, None, :] <= pos_c[:, None, None, None]
        for l in range(cfg.n_layers):
            lp = _layer(params, l)
            q, k, v = _block_qkv(x, lp, positions, dtype)   # [b, 1, h, dh]
            layer_cache = codec.write(cache.map(lambda t: t[l]),
                                      torch.stack([k, v]), pos_c)
            ck, cv = codec.read(layer_cache)
            a = _attend_cache(q, ck, cv, mask, cfg.head_dim, dtype)
            x = _block_tail(x, a, lp, cfg)
        return _final_logits(x, params)[:, 0], cache

    return step


def build_chunk_decode(cfg: TransformerConfig,
                       max_seq: Optional[int] = None,
                       kv_codec: Optional[str] = None) -> Callable:
    """KV-cached decode of a whole chunk of c tokens in one pass:
    ``chunk(params, tokens[int b, c], cache, pos0) -> (logits[b, c,
    vocab], cache)`` — :func:`build_decode_step` generalized to c
    positions (chunked prefill, the prefix cache's remainder). Position
    ``pos0 + i`` writes cache slot ``pos0 + i`` before the attend (in
    place) and query i sees slots ``<= pos0 + i``. ``pos0`` is a scalar or
    a ``[b]`` tensor (one origin per row), clamped to ``S - c`` so the
    chunk's writes stay inside the cache."""
    dtype = cfg.dtype
    s_max = max_seq or cfg.max_seq
    codec = _kv_codec(cfg, kv_codec)

    def chunk(params, tokens, cache, pos0):
        b, c = tokens.shape
        dev = cache.device
        pos0 = torch.as_tensor(pos0, device=dev).long()
        if pos0.dim() == 0:
            pos0 = pos0.expand(b)
        pos0 = torch.clamp(pos0, max=s_max - c)
        positions = pos0[:, None] + torch.arange(c, device=dev)[None, :]
        slots = torch.arange(s_max, device=dev)
        # query i of row r (global position pos0[r] + i) sees slots
        # <= pos0[r] + i
        mask = slots[None, None, None, :] <= positions[:, None, :, None]
        x = _embed(params, tokens, dtype)                   # [b, c, d]
        for l in range(cfg.n_layers):
            lp = _layer(params, l)
            q, k, v = _block_qkv(x, lp, positions, dtype)   # [b, c, h, dh]
            layer_cache = codec.write(cache.map(lambda t: t[l]),
                                      torch.stack([k, v]), pos0)
            ck, cv = codec.read(layer_cache)
            a = _attend_cache(q, ck, cv, mask, cfg.head_dim, dtype)
            x = _block_tail(x, a, lp, cfg)
        return _final_logits(x, params), cache

    return chunk


def build_prefill(cfg: TransformerConfig,
                  max_seq: Optional[int] = None,
                  attention_fn: Optional[Callable] = None,
                  kv_codec: Optional[str] = None) -> Callable:
    """Prompt ingestion: ``prefill(params, tokens[int b, s], lengths=None)
    -> (logits[b, vocab], cache)`` — one full-sequence forward with k/v
    captured into the first s slots of a fresh :class:`KVCache` of S
    slots. With ``lengths`` (right-padded prompts, the engine's buckets)
    the logits come from each row's position ``lengths - 1``; the pad k/v
    in slots ``>= length`` is unreachable before decode overwrites it."""
    dtype = cfg.dtype
    s_max = max_seq or cfg.max_seq
    codec = _kv_codec(cfg, kv_codec)
    layer_body = make_layer_body(cfg, attention_fn, capture_kv=True)

    def prefill(params, tokens, lengths=None):
        b, s = tokens.shape
        dev = tokens.device
        positions = _positions(b, s, dev)
        x = _embed(params, tokens, dtype)
        kvs = []
        for l in range(cfg.n_layers):
            x, kv = layer_body(x, positions, _layer(params, l))
            kvs.append(kv)
        cache = codec.place_prefix(
            codec.init(cfg.n_layers, b, s_max, cfg.n_heads, cfg.head_dim,
                       dev), torch.stack(kvs))
        x = _rmsnorm(x, params["ln_f"])
        if lengths is None:
            last = x[:, -1]
        else:
            idx = (torch.as_tensor(lengths, device=dev).long() - 1)
            last = x[torch.arange(b, device=dev), idx]
        logits = torch.matmul(last.float(), params["embed"].t())
        return logits, cache

    return prefill


def _block_tokens(name: str, s_max: int, block_tokens: int) -> int:
    T = int(block_tokens)
    if T <= 0 or s_max % T:
        raise ValueError(
            f"{name}: max_seq ({s_max}) must be a positive multiple of "
            f"block_tokens ({block_tokens})")
    return T


def build_paged_decode_step(cfg: TransformerConfig,
                            block_tokens: int,
                            max_seq: Optional[int] = None,
                            kv_codec: Optional[str] = None) -> Callable:
    """Single-token decode against a paged KV cache
    (``serving/kvpool.py``): ``step(params, token[int b], arena, bt[int
    b, MB], pos[int b]) -> (logits[b, vocab], arena)``.

    ``arena`` is the pool's :class:`KVCache` of ``[L, NTOT + 1, 2, T, h,
    dh]`` leaves; ``bt`` maps each row's logical blocks ``0..MB-1`` (MB =
    S/T) to physical blocks, unallocated entries holding the sentinel.
    Each layer writes k/v into slot ``(bt[pos//T], pos%T)`` in place, then
    gathers the row's table back into the contiguous ``[b, S, ...]``
    layout of :func:`build_decode_step`: the same slot order and
    write-before-attend, masked slots contributing exact zeros, so greedy
    tokens equal the monolithic cache's. A row whose table is all
    sentinel (an empty lane) writes the trash block and reads zeros."""
    dtype = cfg.dtype
    s_max = max_seq or cfg.max_seq
    T = _block_tokens("build_paged_decode_step", s_max, block_tokens)
    codec = _kv_codec(cfg, kv_codec)

    def step(params, token, arena, bt, pos):
        dev = arena.device
        pos = torch.as_tensor(pos, device=dev).long()
        pos_c = torch.clamp(pos, max=s_max - 1)   # cache-length contract
        bt = bt.long()
        x = _embed(params, token, dtype)[:, None]           # [b, 1, d]
        positions = pos[:, None]
        blk = torch.gather(bt, 1, (pos_c // T)[:, None])    # [b, 1]
        off = (pos_c % T)[:, None]
        slots = torch.arange(s_max, device=dev)
        mask = slots[None, None, None, :] <= pos_c[:, None, None, None]
        for l in range(cfg.n_layers):
            lp = _layer(params, l)
            q, k, v = _block_qkv(x, lp, positions, dtype)   # [b, 1, h, dh]
            pages = codec.paged_write(arena.map(lambda t: t[l]),
                                      torch.stack([k, v]), blk, off)
            ck, cv = codec.paged_read(pages, bt)
            a = _attend_cache(q, ck, cv, mask, cfg.head_dim, dtype)
            x = _block_tail(x, a, lp, cfg)
        return _final_logits(x, params)[:, 0], arena

    return step


def build_paged_chunk(cfg: TransformerConfig,
                      block_tokens: int,
                      max_seq: Optional[int] = None,
                      kv_codec: Optional[str] = None) -> Callable:
    """Chunk decode against a paged KV cache, :func:`build_chunk_decode`'s
    paged twin: ``chunk(params, tokens[int b, c], arena, bt[int b, MB],
    pos0[int b], limit[int b]) -> (logits[b, c, vocab], arena)``.

    Row r's token i sits at position ``pos0[r] + i``, writes slot
    ``(bt[r, p//T], p%T)`` and attends under a ``slot <= p`` mask.
    ``limit[r]`` is the row's real chunk length: positions at or past it
    (bucket padding) write the trash block, so a padded warm prefix
    extension never smears pad k/v into blocks another stream could
    inherit. The prefix cache's extension and speculative verification
    use it on the paged path."""
    dtype = cfg.dtype
    s_max = max_seq or cfg.max_seq
    T = _block_tokens("build_paged_chunk", s_max, block_tokens)
    codec = _kv_codec(cfg, kv_codec)

    def chunk(params, tokens, arena, bt, pos0, limit):
        b, c = tokens.shape
        dev = arena.device
        pos0 = torch.clamp(torch.as_tensor(pos0, device=dev).long(),
                           max=s_max - c)
        ar = torch.arange(c, device=dev)
        positions = pos0[:, None] + ar[None, :]             # [b, c]
        valid = ar[None, :] < torch.as_tensor(limit,
                                              device=dev).long()[:, None]
        bt = bt.long()
        trash = arena.values.shape[1] - 1
        blk = torch.gather(bt, 1, positions // T)           # [b, c]
        blk = torch.where(valid, blk, torch.full_like(blk, trash))
        off = positions % T
        slots = torch.arange(s_max, device=dev)
        mask = slots[None, None, None, :] <= positions[:, None, :, None]
        x = _embed(params, tokens, dtype)                   # [b, c, d]
        for l in range(cfg.n_layers):
            lp = _layer(params, l)
            q, k, v = _block_qkv(x, lp, positions, dtype)   # [b, c, h, dh]
            pages = codec.paged_write(arena.map(lambda t: t[l]),
                                      torch.stack([k, v]), blk, off)
            ck, cv = codec.paged_read(pages, bt)
            a = _attend_cache(q, ck, cv, mask, cfg.head_dim, dtype)
            x = _block_tail(x, a, lp, cfg)
        return _final_logits(x, params), arena

    return chunk


def make_sampler(vocab: int, temperature: float = 1.0,
                 top_k: int = 0, min_p: float = 0.0,
                 with_logprobs: bool = False) -> Callable:
    """The sampling function: ``sample(logits[n, vocab], keys=None) ->
    (tokens[int32 n], keys)``, with ``logprobs[float32 n]`` appended when
    ``with_logprobs`` (the chosen token's fp32 log_softmax). Only greedy
    decoding (``temperature <= 0``) is ported: the JAX package draws with
    per-row threefry keys, which a CUDA generator cannot reproduce bit for
    bit."""
    if not 0.0 <= min_p <= 1.0:
        raise ValueError(
            f"make_sampler: min_p must be in [0, 1], got {min_p} "
            f"(it is a probability RATIO vs the top token, not a count "
            f"or percentage)")
    if temperature > 0.0 or top_k > 0 or min_p > 0.0:
        raise not_ported("sampled decoding (temperature > 0, top_k, min_p)",
                         "A.13.5")

    def sample(logits, keys=None):
        toks = torch.argmax(logits, dim=-1).to(torch.int32)
        if not with_logprobs:
            return toks, keys
        logp = torch.log_softmax(logits.float(), dim=-1)
        chosen = torch.gather(logp, 1, toks.long()[:, None])[:, 0]
        return toks, keys, chosen

    return sample


def build_greedy_stream_step(*_args, **_kw):
    raise not_ported("the repo-loop stream step", "A.13.6")


def build_sample_stream_step(*_args, **_kw):
    raise not_ported("the repo-loop stream step", "A.13.6")


class TransformerLM(nn.Module):
    """``build_forward`` as an ``nn.Module`` for ``tensor_filter``: the
    params are buffers (prepared as :func:`prepare_params` does), and
    ``forward(tokens[int b, s]) -> logits[float32 b, s, vocab]``."""

    def __init__(self, cfg: TransformerConfig, params: Params,
                 attention: str = "auto"):
        super().__init__()
        if attention not in ("auto", "reference"):
            raise ValueError(
                f"transformer_lm: attention must be 'auto' or 'reference', "
                f"got {attention!r}")
        self.cfg = cfg
        self._names = sorted(params)
        for k, v in prepare_params(params, cfg).items():
            self.register_buffer(k, v)
        attention_fn = None
        if attention == "auto":
            def attention_fn(q, k, v):
                return flash_attention(q, k, v, causal=True)
        self._fwd = build_forward(cfg, attention_fn)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        params = {k: getattr(self, k) for k in self._names}
        return self._fwd(params, tokens)


def transformer_lm(vocab: int = 32000, d_model: int = 512, n_heads: int = 8,
                   n_layers: int = 4, d_ff: int = 2048, seq: int = 256,
                   batch: int = 1, dtype: torch.dtype = torch.bfloat16,
                   num_experts: int = 0, seed: int = 0,
                   attention: str = "auto"
                   ) -> Tuple[TransformerLM, TensorsInfo, TensorsInfo]:
    """Filter-backend factory: ``(module, in_info, out_info)``, the
    arguments ``register_torch_model(name, ...)`` takes after the name.
    ``attention``: "auto" runs the flash kernel for CUDA tensors,
    "reference" the plain attention."""
    cfg = TransformerConfig(vocab=vocab, d_model=d_model, n_heads=n_heads,
                            n_layers=n_layers, d_ff=d_ff, dtype=dtype,
                            num_experts=num_experts)
    module = TransformerLM(cfg, init_params(cfg, seed), attention).eval()
    in_info = TensorsInfo.from_str(f"{seq}:{batch}", "int32")
    out_info = TensorsInfo.from_str(f"{vocab}:{seq}:{batch}", "float32")
    return module, in_info, out_info
