"""The port's LM engine and paged arena on a serving mesh
(``ContinuousBatchingEngine(mesh=)``, ``parallel/sharded.ShardedLM``),
held against the JAX package's meshed engines on its 8-device CPU mesh:
the cases of tests/test_serving.py (dp2×tp2, dp-only, tp8 raises, the
dp4×tp2 slot scaling) and tests/test_paged_serving.py (paged × int8 ×
dp2), with tests/test_serving.py's configuration and seeded weights in
float32. Greedy tokens equal the JAX meshed engine's, the exact-length
``reference_greedy`` and the port's unmeshed engine's.

The ``gpu`` test holds the one-card mesh on the card: the K-step dispatch
stays one captured graph per (B, K) and its tokens equal the unmeshed
engine's.
"""

import functools

import numpy as np
import pytest
import torch

import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.parallel.mesh import make_mesh as jmake_mesh
from nnstreamer_tpu.serving import ContinuousBatchingEngine as JaxEngine
from nnstreamer_tpu_torch.models import transformer as ttr
from nnstreamer_tpu_torch.parallel import make_mesh
from nnstreamer_tpu_torch.parallel.mesh import ShardedTensor
from nnstreamer_tpu_torch.serving import ContinuousBatchingEngine
from tests.test_serving import CFG as JCFG
from tests.test_serving import PARAMS as JPARAMS
from tests.test_serving import reference_greedy

# tests/test_serving.py's configuration and seed, written out: the card's
# test runner stubs the JAX package (tools/gpu_tests.py)
CFG = ttr.TransformerConfig(vocab=97, d_model=64, n_heads=4, n_layers=2,
                            d_ff=128, max_seq=64, dtype=torch.float32)
PARAMS = ttr.init_params(CFG, seed=3)
PROMPTS = [[4, 8, 15], [16, 23, 9], [7, 7], [1, 2, 3, 4, 5]]


@pytest.fixture(autouse=True)
def host_mesh():
    tnt.set_device("cpu")
    tnt.set_host_device_count(8)
    yield
    tnt.set_host_device_count(1)
    tnt.set_device(None)


def _serve(eng, prompts, new_tokens):
    streams = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    return [s.result(timeout=240) for s in streams]


@functools.lru_cache(maxsize=None)
def jax_meshed(axes, prompts, new_tokens, **kw):
    """The JAX meshed engine's greedy tokens (memoized)."""
    eng = JaxEngine(JCFG, JPARAMS, temperature=0.0,
                    mesh=jmake_mesh(list(axes)), **kw).start()
    try:
        return _serve(eng, [list(p) for p in prompts], new_tokens)
    finally:
        eng.stop()


def _port(mesh, prompts, new_tokens, **kw):
    kw.setdefault("max_streams", 4)
    kw.setdefault("steps_per_dispatch", 4)
    eng = ContinuousBatchingEngine(CFG, PARAMS, temperature=0.0, mesh=mesh,
                                   **kw).start()
    try:
        return _serve(eng, prompts, new_tokens), eng
    finally:
        eng.stop()


def test_sharded_engine_matches_unsharded_and_jax():
    """A dp=2 × tp=2 mesh engine emits exactly what the single-device
    engine does, and what the JAX meshed engine does."""
    mesh = make_mesh([("dp", 2), ("tp", 2)])
    got, eng = _port(mesh, PROMPTS, 7)
    assert isinstance(eng.params["qkv"], ShardedTensor)
    assert tuple(eng.params["qkv"].sharding.spec) == (None, None, None, "tp")
    assert tuple(eng._cache.values.sharding.spec) == \
        (None, None, "dp", None, "tp")
    plain, _ = _port(None, PROMPTS, 7)
    for p, g in zip(PROMPTS, got):
        assert g == reference_greedy(p, 7), f"prompt={p}"
    assert got == plain
    assert got == jax_meshed((("dp", 2), ("tp", 2)),
                             tuple(map(tuple, PROMPTS)), 7, max_streams=4,
                             steps_per_dispatch=4)


def test_dp_only_mesh_serving():
    """A mesh with no tp axis (pure data-parallel serving) works — param
    specs naming absent axes are pruned to replicated."""
    mesh = make_mesh([("dp", 2)])
    eng = ContinuousBatchingEngine(
        CFG, PARAMS, max_streams=2, steps_per_dispatch=4,
        temperature=0.0, mesh=mesh).start()
    try:
        assert eng.params["qkv"].sharding.replicated
        got = eng.generate([5, 11, 23, 42, 7], max_new_tokens=6,
                           timeout=240)
    finally:
        eng.stop()
    assert got == reference_greedy([5, 11, 23, 42, 7], 6)


def test_sharded_engine_validates_divisibility():
    mesh = make_mesh([("dp", 1), ("tp", 8)])  # CFG.n_heads == 4
    with pytest.raises(ValueError, match="n_heads"):
        ContinuousBatchingEngine(CFG, PARAMS, max_streams=4, mesh=mesh)
    with pytest.raises(ValueError):
        JaxEngine(JCFG, JPARAMS, max_streams=4,
                  mesh=jmake_mesh([("dp", 1), ("tp", 8)]))
    with pytest.raises(ValueError, match="max_streams"):
        ContinuousBatchingEngine(CFG, PARAMS, max_streams=3,
                                 mesh=make_mesh([("dp", 2)]))


def test_speculate_raises_under_a_mesh():
    with pytest.raises(ValueError, match="mesh"):
        ContinuousBatchingEngine(CFG, PARAMS, max_streams=2,
                                 mesh=make_mesh([("dp", 2)]), speculate=2)


def test_meshed_prefill_keeps_plain_attention(monkeypatch):
    """The meshed engine never reaches kernel B2's wrapper (the JAX engine
    keeps XLA attention under a mesh)."""
    from nnstreamer_tpu_torch.ops import flash_attention as fa

    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got, _ = _port(make_mesh([("dp", 2), ("tp", 2)]), PROMPTS[:2], 3)
    assert got == [reference_greedy(p, 3) for p in PROMPTS[:2]]
    assert calls == []


def test_chunked_prefill_and_prefix_cache_on_the_mesh():
    mesh = make_mesh([("dp", 2), ("tp", 2)])
    prompts = PROMPTS + [[4, 8, 15, 16, 23, 42]]
    got, eng = _port(mesh, prompts, 6, prefill_chunk=4, prefix_cache=4)
    assert got == [reference_greedy(p, 6) for p in prompts]
    assert eng.stats["prefill_chunks"] > 0


def test_dp_slot_scaling_throughput():
    """Aggregate tokens per decode dispatch scale with dp-sharded batch
    slots, holding the mesh fixed: a dp4×tp2 engine with 8 slots vs the
    same mesh with 4 slots (tests/test_serving.py's quantity)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, CFG.vocab, 6).tolist() for _ in range(8)]
    mesh = make_mesh([("dp", 4), ("tp", 2)])

    def tokens_per_dispatch(streams):
        eng = ContinuousBatchingEngine(
            CFG, PARAMS, max_streams=streams, steps_per_dispatch=8,
            temperature=0.0, mesh=mesh).start()
        try:
            eng.generate(prompts[0], max_new_tokens=8, timeout=240)
            d0 = eng.stats["dispatches"]
            t0 = eng.stats["tokens_generated"]
            ss = [eng.submit(p, max_new_tokens=24) for p in prompts]
            outs = [s.result(timeout=240) for s in ss]
            assert sum(len(o) for o in outs) == 8 * 24
            assert outs == [reference_greedy(p, 24) for p in prompts]
            d = eng.stats["dispatches"] - d0
            t = eng.stats["tokens_generated"] - t0
            return t / max(d, 1)
        finally:
            eng.stop()

    slots4 = tokens_per_dispatch(4)
    slots8 = tokens_per_dispatch(8)
    assert slots8 > 1.5 * slots4, (slots8, slots4)


# -- paged × int8 × dp2 (tests/test_paged_serving.py) --------------------------
def test_paged_int8_dp2_mesh_matches_single_device_and_jax():
    prompts = [[5, 11, 23, 42, 7], [4, 8, 15], [16, 23]]
    mono = ContinuousBatchingEngine(
        CFG, PARAMS, max_streams=2, steps_per_dispatch=4,
        temperature=0.0, kv_quant="int8").start()
    try:
        want = [mono.generate(p, max_new_tokens=8, timeout=240)
                for p in prompts]
    finally:
        mono.stop()

    eng = ContinuousBatchingEngine(
        CFG, PARAMS, max_streams=2, steps_per_dispatch=4,
        temperature=0.0, kv_quant="int8", block_tokens=8,
        mesh=make_mesh([("dp", 2)])).start()
    try:
        assert eng.paged
        # the arena (incl. zero block) divides over dp ranks
        assert eng._pool.ntot % 2 == 0
        leaf = eng._pool.arena.values
        assert isinstance(leaf, ShardedTensor)
        assert tuple(leaf.sharding.spec) == (None, "dp")
        got = [eng.generate(p, max_new_tokens=8, timeout=240)
               for p in prompts]
        conc = _serve(eng, prompts, 8)
        assert eng._pool.live_blocks() == 0
    finally:
        eng.stop()
    assert got == want
    assert conc == want
    assert got == jax_meshed((("dp", 2),), tuple(map(tuple, prompts)), 8,
                             max_streams=2, steps_per_dispatch=4,
                             kv_quant="int8", block_tokens=8)


def test_paged_dp2xtp2_prefix_cache_shares_blocks():
    """Copy-on-write prefix blocks on a dp2×tp2 arena: the shared prompt's
    blocks serve a second stream and the tokens stay exact."""
    base = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
    mesh = make_mesh([("dp", 2), ("tp", 2)])
    eng = ContinuousBatchingEngine(
        CFG, PARAMS, max_streams=2, steps_per_dispatch=4, temperature=0.0,
        block_tokens=8, prefix_cache=4, mesh=mesh).start()
    try:
        first = eng.generate(base, max_new_tokens=7, timeout=240)
        again = eng.generate(base, max_new_tokens=7, timeout=240)
        assert eng.stats["prefix_hits"] >= 1
    finally:
        eng.stop()
    assert first == again == reference_greedy(base, 7)


# -- on the card -----------------------------------------------------------------
@pytest.mark.gpu
def test_one_card_mesh_keeps_one_graph_per_dispatch_shape():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the captured K-step dispatch")
    tnt.set_device(None)
    tnt.set_host_device_count(1)
    plain = ContinuousBatchingEngine(CFG, PARAMS, max_streams=4,
                                     steps_per_dispatch=4, temperature=0.0,
                                     attention="reference").start()
    try:
        want = _serve(plain, PROMPTS, 7)
    finally:
        plain.stop()
    mesh = make_mesh([("dp", 1), ("tp", 1)])
    eng = ContinuousBatchingEngine(CFG, PARAMS, max_streams=4,
                                   steps_per_dispatch=4, temperature=0.0,
                                   mesh=mesh).start()
    try:
        got = _serve(eng, PROMPTS, 7)
    finally:
        eng.stop()  # the last issued block is processed by now
    assert eng.graph_stats["captures"] == [4]
    assert eng.graph_stats["replays"] == eng.stats["dispatches"] > 0
    assert got == want
