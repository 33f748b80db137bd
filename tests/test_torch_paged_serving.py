"""The port's paged-KV continuous batching (nnstreamer_tpu_torch/serving/
engine.py with block_tokens > 0, serving/kvpool.py) on the CPU, held
against the JAX package's paged engine: the cases of
tests/test_paged_serving.py (the dp2 mesh case waits for A.24), each
with the JAX paged engine's greedy tokens for the same prompts and seeded
weights (tests/test_serving.py's configuration, float32).

- ``NNSTPU_PAGED_KV=0`` and ``block_tokens=0`` keep the monolithic cache;
- paged tokens equal the JAX paged engine's (and the exact-length
  ``reference_greedy``), single and concurrent streams, ``kv_quant=int8``
  (equal to the monolithic int8 engine's), chunked prefill, and more
  streams than decode lanes;
- the K-step dispatch stays one program per (B, K);
- a starved pool sheds, counts it and returns every block;
- the prefix cache shares blocks copy-on-write, and an entry's blocks
  outlive the stream that made them.

The ``gpu`` tests hold the paged dispatch graph on the card: one capture,
a replay a dispatch, tokens equal to the eager program's.
"""

import functools

import numpy as np
import pytest
import torch

from nnstreamer_tpu.serving import ContinuousBatchingEngine as JaxEngine
from nnstreamer_tpu_torch.models import transformer as ttr
from nnstreamer_tpu_torch.serving import ContinuousBatchingEngine
from nnstreamer_tpu_torch.serving import engine as engine_mod
from tests.test_serving import CFG as JCFG
from tests.test_serving import PARAMS as JPARAMS
from tests.test_serving import reference_greedy

T = 8
# tests/test_serving.py's configuration and seed, written out: the card's
# test runner stubs the JAX package (tools/gpu_tests.py)
CFG = ttr.TransformerConfig(vocab=97, d_model=64, n_heads=4, n_layers=2,
                            d_ff=128, max_seq=64, dtype=torch.float32)
PARAMS = ttr.init_params(CFG, seed=3)

PROMPTS = [[5, 11, 23, 42, 7], [4, 8, 15], [16, 23], [42, 7, 9, 1],
           [2, 2, 2, 2, 2], [31, 59, 26, 53], [9] * 17, [13, 2]]


def _kw(kw):
    out = dict(max_streams=3, steps_per_dispatch=4, block_tokens=T)
    out.update(kw)
    return out


def paged_engine(device="cpu", **kw):
    return ContinuousBatchingEngine(CFG, PARAMS, device=device,
                                    **_kw(kw)).start()


def _serve(eng, prompts, new_tokens, together=True):
    if together:
        streams = [eng.submit(p, max_new_tokens=new_tokens)
                   for p in prompts]
        return [s.result(timeout=480) for s in streams], streams
    streams = []
    out = []
    for p in prompts:
        s = eng.submit(p, max_new_tokens=new_tokens)
        out.append(s.result(timeout=480))
        streams.append(s)
    return out, streams


@functools.lru_cache(maxsize=None)
def jax_paged(prompts, new_tokens, together=True, **kw):
    """The JAX paged engine's tokens, finish reasons and stats for
    ``prompts`` (a tuple of tuples), memoized."""
    eng = JaxEngine(JCFG, JPARAMS, temperature=0.0, **_kw(kw)).start()
    try:
        assert eng.paged
        toks, streams = _serve(eng, [list(p) for p in prompts], new_tokens,
                               together)
    finally:
        eng.stop()
    return toks, [s.finish_reason for s in streams], dict(eng.stats)


def _key(prompts):
    return tuple(tuple(p) for p in prompts)


def test_config_and_weights_are_the_jax_tests():
    assert CFG == ttr.TransformerConfig(
        vocab=JCFG.vocab, d_model=JCFG.d_model, n_heads=JCFG.n_heads,
        n_layers=JCFG.n_layers, d_ff=JCFG.d_ff, max_seq=JCFG.max_seq,
        dtype=torch.float32)
    for k, v in JPARAMS.items():
        assert np.array_equal(PARAMS[k].numpy(), np.asarray(v)), k


# -- the kill switch -----------------------------------------------------------
def test_env_kill_switch_keeps_monolithic_path(monkeypatch):
    monkeypatch.setenv("NNSTPU_PAGED_KV", "0")
    eng = paged_engine()  # block_tokens set, the environment wins
    try:
        assert not eng.paged
        assert eng._cache is not None and eng._pool is None
        got = eng.generate(PROMPTS[0], max_new_tokens=9, timeout=120)
    finally:
        eng.stop()
    assert got == reference_greedy(PROMPTS[0], 9)


def test_block_tokens_zero_is_monolithic():
    eng = paged_engine(block_tokens=0)
    try:
        assert not eng.paged and eng._cache is not None
        assert eng._pool is None and eng._program.bt is None
    finally:
        eng.stop()


def test_block_tokens_must_divide_max_seq():
    with pytest.raises(ValueError, match="divide max_seq"):
        ContinuousBatchingEngine(CFG, PARAMS, device="cpu", block_tokens=7)


# -- greedy parity with the JAX paged engine -----------------------------------
def test_single_stream_matches_the_jax_paged_engine():
    eng = paged_engine()
    try:
        assert eng.paged and eng._cache is None
        got, _ = _serve(eng, PROMPTS[:4], 9, together=False)
    finally:
        eng.stop()
    want, _, _ = jax_paged(_key(PROMPTS[:4]), 9, together=False)
    assert got == want
    for p, g in zip(PROMPTS, got):
        assert g == reference_greedy(p, 9), f"prompt={p}"


def test_concurrent_streams_match_the_jax_paged_engine():
    eng = paged_engine()
    try:
        got, _ = _serve(eng, PROMPTS[:5], 9)
    finally:
        eng.stop()
    want, _, _ = jax_paged(_key(PROMPTS[:5]), 9)
    assert got == want
    for p, g in zip(PROMPTS, got):
        assert g == reference_greedy(p, 9), f"prompt={p}"


def test_int8_paged_matches_int8_monolithic():
    """The per-block int8 codec gives the monolithic int8 cache's tokens
    (the same quantization grid, another layout), as the JAX paged int8
    engine does."""
    mono = ContinuousBatchingEngine(CFG, PARAMS, device="cpu",
                                    max_streams=2, steps_per_dispatch=4,
                                    kv_quant="int8").start()
    try:
        want, _ = _serve(mono, PROMPTS[:3], 9, together=False)
    finally:
        mono.stop()
    eng = paged_engine(kv_quant="int8")
    try:
        got, _ = _serve(eng, PROMPTS[:3], 9, together=False)
    finally:
        eng.stop()
    assert got == want
    jgot, _, _ = jax_paged(_key(PROMPTS[:3]), 9, together=False,
                           kv_quant="int8")
    assert got == jgot


def test_chunked_prefill_composes_with_paging():
    prompts = [PROMPTS[6], list(range(1, 30))]
    eng = paged_engine(prefill_chunk=16)
    try:
        got, _ = _serve(eng, prompts, 6, together=False)
        chunks = eng.stats["prefill_chunks"]
    finally:
        eng.stop()
    want, _, jstats = jax_paged(_key(prompts), 6, together=False,
                                prefill_chunk=16)
    assert got == want
    assert chunks == jstats["prefill_chunks"] == 2 + 2
    for p, g in zip(prompts, got):
        assert g == reference_greedy(p, 6), f"len={len(p)}"


# -- one program ---------------------------------------------------------------
def test_decode_loop_stays_one_program(monkeypatch):
    """Stream churn and block growth never build another program: block
    tables and positions are data in its static buffers, not shape."""
    built = []
    real = engine_mod._DecodeProgram

    class Counted(real):
        def __init__(self, eng):
            super().__init__(eng)
            built.append((eng.B, self.K, tuple(self.bt.shape)))

    monkeypatch.setattr(engine_mod, "_DecodeProgram", Counted)
    eng = paged_engine()
    try:
        got, _ = _serve(eng, PROMPTS[:5], 7)
        assert eng.stats["dispatches"] > 1
    finally:
        eng.stop()
    assert built == [(3, 4, (3, CFG.max_seq // T))]
    want, _, _ = jax_paged(_key(PROMPTS[:5]), 7)
    assert got == want


# -- more streams than decode lanes ------------------------------------------
def test_oversubscribed_streams_stay_exact():
    """12 streams over 2 decode lanes: EDF time-sharing parks and rebinds
    lanes at block granularity, and every stream's tokens are the JAX
    paged engine's."""
    prompts = [PROMPTS[i % len(PROMPTS)] for i in range(12)]
    eng = paged_engine(max_streams=2, kv_blocks=64)
    try:
        got, _ = _serve(eng, prompts, 8)
        assert eng.stats["concurrent_streams_max"] > eng.B
    finally:
        eng.stop()
    want, _, _ = jax_paged(_key(prompts), 8, max_streams=2, kv_blocks=64)
    assert got == want
    for p, g in zip(prompts, got):
        assert g == reference_greedy(p, 8), f"prompt={p}"


def test_starved_pool_sheds_and_recycles_blocks():
    """A pool too small for the offered load sheds (the most late stream
    first), counts it and returns every block — it never wedges admission
    or leaks. The streams that finish by length are exact."""
    prompts = [PROMPTS[i % len(PROMPTS)] for i in range(8)]
    eng = paged_engine(max_streams=2, kv_blocks=6, prefix_cache=0)
    try:
        done, streams = _serve(eng, prompts, 24)
        reasons = [s.finish_reason for s in streams]
        assert eng.stats["kv_sheds"] > 0
        assert all(r in ("length", "shed", "eos") for r in reasons)
        assert all(d is not None for d in done)
        assert eng._pool.live_blocks() == 0
        for s, p, got in zip(streams, prompts, done):
            if s.finish_reason == "length":
                assert got == reference_greedy(p, 24), f"prompt={p}"
    finally:
        eng.stop()
    _, jreasons, jstats = jax_paged(_key(prompts), 24, max_streams=2,
                                    kv_blocks=6, prefix_cache=0)
    assert jstats["kv_sheds"] > 0 and "shed" in jreasons


# -- copy-on-write prefix sharing --------------------------------------------
BASE = [7, 3, 9, 1, 4, 6, 2, 8, 5, 11, 13, 17, 19, 23, 29, 27, 25]


def test_prefix_cache_shares_blocks_copy_on_write():
    prompts = [BASE, BASE, BASE + [31, 37]]
    eng = paged_engine(prefix_cache=4, kv_blocks=64)
    try:
        cold = eng.generate(BASE, max_new_tokens=6, timeout=120)
        assert eng._pool.live_blocks() > 0  # the entry retains its blocks
        hit = eng.generate(BASE, max_new_tokens=6, timeout=120)
        ext = eng.generate(BASE + [31, 37], max_new_tokens=6, timeout=120)
        stats = dict(eng.stats)
    finally:
        eng.stop()
    assert stats["prefix_hits"] >= 2
    assert stats["prefix_tokens_reused"] >= len(BASE) + 16
    want, _, jstats = jax_paged(_key(prompts), 6, together=False,
                                prefix_cache=4, kv_blocks=64)
    assert [cold, hit, ext] == want
    assert hit == cold == reference_greedy(BASE, 6)
    assert ext == reference_greedy(BASE + [31, 37], 6)
    for k in ("prefix_hits", "prefix_tokens_reused", "prefills"):
        assert stats[k] == jstats[k], k


def test_prefix_entry_blocks_survive_donor_stream_exit():
    """A cached prefix stays valid after the stream that made it finishes
    and its private blocks are recycled: the refcount keeps the shared
    full blocks alive."""
    base = list(range(1, 18))
    eng = paged_engine(prefix_cache=8, kv_blocks=64)
    try:
        eng.generate(base, max_new_tokens=4, timeout=120)
        for p in PROMPTS[:4]:  # churn: unrelated streams recycle blocks
            eng.generate(p, max_new_tokens=6, timeout=120)
        got = eng.generate(base, max_new_tokens=9, timeout=120)
        assert eng.stats["prefix_hits"] >= 1
    finally:
        eng.stop()
    assert got == reference_greedy(base, 9)


def test_streams_run_to_the_end_of_the_cache():
    """Streams whose budget reaches the cache's last slot (max_new past
    S - n): a dispatch there spans positions the program clamps to S - 1,
    and the block table never grows past its MB blocks. The tokens equal
    the port's and the JAX package's monolithic engines', and every block
    returns."""
    prompts = [PROMPTS[0], PROMPTS[1], PROMPTS[6]]
    eng = paged_engine(kv_blocks=64)
    try:
        got, streams = _serve(eng, prompts, 100)
        assert eng._pool.live_blocks() == 0
    finally:
        eng.stop()
    assert [s.finish_reason for s in streams] == ["length"] * 3
    assert [len(g) for g in got] == [CFG.max_seq - len(p) for p in prompts]
    mono = ContinuousBatchingEngine(CFG, PARAMS, device="cpu",
                                    **_kw(dict(block_tokens=0))).start()
    try:
        want, _ = _serve(mono, prompts, 100)
    finally:
        mono.stop()
    jeng = JaxEngine(JCFG, JPARAMS, temperature=0.0,
                     **_kw(dict(block_tokens=0))).start()
    try:
        jwant, _ = _serve(jeng, prompts, 100)
    finally:
        jeng.stop()
    assert got == want == jwant


def test_stop_returns_every_block():
    eng = paged_engine(max_streams=2)
    s = eng.submit(PROMPTS[0], max_new_tokens=40)
    next(iter(s))  # decoding: the stream holds blocks
    eng.stop()
    assert s.finish_reason in ("engine-stopped", "length")
    assert eng._pool.live_blocks() == 0 and not eng._sstate
    assert (eng._bt == eng._pool.SENTINEL).all()


# -- on the card ---------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the paged dispatch is captured")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_paged_dispatch_graph_on_the_card(kv_quant):
    """One capture at K, a replay a dispatch, and the eager program's
    tokens, with more streams than lanes; every block returns."""
    _card()
    prompts = [PROMPTS[i % len(PROMPTS)] for i in range(7)]
    eager = ContinuousBatchingEngine(CFG, PARAMS, device="cuda",
                                     kv_quant=kv_quant, **_kw({}))
    eager._eager_dispatch = True
    eager.start()
    try:
        ref, _ = _serve(eager, prompts, 11)
    finally:
        eager.stop()
    eng = paged_engine("cuda", kv_quant=kv_quant)
    try:
        got, _ = _serve(eng, prompts, 11)
    finally:
        eng.stop()
    assert got == ref
    assert eng.graph_stats["captures"] == [4]
    assert eng.graph_stats["replays"] == eng.stats["dispatches"] > 0
    assert eng.stats["concurrent_streams_max"] > eng.B
    assert eng._pool.live_blocks() == 0


@pytest.mark.gpu
def test_paged_equals_monolithic_on_the_card():
    _card()
    prompts = PROMPTS[:6]
    mono = ContinuousBatchingEngine(CFG, PARAMS, device="cuda",
                                    max_streams=3,
                                    steps_per_dispatch=4).start()
    try:
        want, _ = _serve(mono, prompts, 13)
    finally:
        mono.stop()
    eng = paged_engine("cuda")
    try:
        got, _ = _serve(eng, prompts, 13)
    finally:
        eng.stop()
    assert got == want
