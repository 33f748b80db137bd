"""The port's continuous-batching engine (nnstreamer_tpu_torch/serving/
engine.py) on the CPU, held against the JAX package: greedy tokens EQUAL
to its exact-length prefill + one-at-a-time decode (``reference_greedy``
of tests/test_serving.py) on the same seeded weights, whatever the batch
composition; logprobs within 1e-5 of the JAX engine's. Chunked prefill
and the prefix cache give the JAX engine's tokens and its stats counters
on the same request sequence.
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu.serving import ContinuousBatchingEngine as JaxEngine
from nnstreamer_tpu_torch import device as device_mod
from nnstreamer_tpu_torch.models import transformer as ttr
from nnstreamer_tpu_torch.obs.registry import get_registry
from nnstreamer_tpu_torch.serving import engine as engine_mod
from nnstreamer_tpu_torch.serving import (
    ContinuousBatchingEngine,
    GenerationStream,
    get_engine,
    register_engine,
    unregister_engine,
)
from tests.test_serving import CFG as JCFG
from tests.test_serving import PARAMS as JPARAMS
from tests.test_serving import reference_greedy

CFG = ttr.TransformerConfig(vocab=JCFG.vocab, d_model=JCFG.d_model,
                            n_heads=JCFG.n_heads, n_layers=JCFG.n_layers,
                            d_ff=JCFG.d_ff, max_seq=JCFG.max_seq,
                            dtype=torch.float32)
PARAMS = ttr.init_params(CFG, seed=3)  # tests/test_serving.py's seed


def _engine(**kw):
    kw.setdefault("max_streams", 3)
    kw.setdefault("steps_per_dispatch", 4)
    return ContinuousBatchingEngine(CFG, PARAMS, device="cpu", **kw)


@pytest.fixture(scope="module")
def engine():
    eng = _engine().start()
    yield eng
    eng.stop()


def test_weights_are_the_jax_packages():
    for name, value in JPARAMS.items():
        assert np.array_equal(PARAMS[name].numpy(), np.asarray(value))


def test_single_stream_matches_reference_greedy(engine):
    prompt = [5, 11, 23, 42, 7]
    got = engine.generate(prompt, max_new_tokens=13, timeout=120)
    assert got == reference_greedy(prompt, 13)


def test_bucketed_prefill_matches_exact_length(engine):
    # prompt lengths straddling a bucket edge (the engine pads to 16/32)
    for prompt in ([3], [9, 2, 4] * 5, list(range(1, 18))):
        got = engine.generate(prompt, max_new_tokens=6, timeout=120)
        assert got == reference_greedy(prompt, 6), f"len={len(prompt)}"


def test_concurrent_streams_match_isolated_runs(engine):
    prompts = [[4, 8, 15], [16, 23], [42, 7, 9, 1], [2, 2, 2, 2, 2],
               [31, 59, 26, 53]]
    streams = [engine.submit(p, max_new_tokens=9) for p in prompts]
    results = [s.result(timeout=240) for s in streams]
    for p, got in zip(prompts, results):
        assert got == reference_greedy(p, 9), f"prompt={p}"


def test_more_streams_than_slots_all_complete(engine):
    prompts = [[i + 1, i + 2] for i in range(7)]  # 7 streams on 3 slots
    streams = [engine.submit(p, max_new_tokens=5) for p in prompts]
    for p, s in zip(prompts, streams):
        assert s.result(timeout=240) == reference_greedy(p, 5)
        assert s.finish_reason == "length"
    assert engine.active_streams == 0


def test_eos_truncates_stream():
    prompt = [5, 11, 23, 42, 7]
    ref = reference_greedy(prompt, 12)
    eos = ref[4]  # a token the model will actually emit
    eng = _engine(max_streams=2, eos_id=eos).start()
    try:
        s = eng.submit(prompt, max_new_tokens=12)
        got = s.result(timeout=120)
    finally:
        eng.stop()
    assert got == ref[: ref.index(eos) + 1]
    assert s.finish_reason == "eos"


def test_length_budget_respects_cache_window():
    eng = _engine(max_streams=1).start()
    try:
        prompt = list(range(1, 60))  # 59 tokens, S=64 → at most 5 new
        s = eng.submit(prompt, max_new_tokens=50)
        got = s.result(timeout=120)
    finally:
        eng.stop()
    assert len(got) == CFG.max_seq - len(prompt)
    assert got == reference_greedy(prompt, len(got))
    assert s.finish_reason == "length"


def test_logprobs_match_the_jax_engine():
    prompts = [[5, 11, 23, 42, 7], [16, 23]]
    jeng = JaxEngine(JCFG, JPARAMS, max_streams=2, steps_per_dispatch=4,
                     temperature=0.0).start()
    try:
        jstreams = [jeng.submit(p, max_new_tokens=10) for p in prompts]
        for s in jstreams:
            s.result(timeout=240)
    finally:
        jeng.stop()
    eng = _engine(max_streams=2).start()
    try:
        streams = [eng.submit(p, max_new_tokens=10) for p in prompts]
        for s in streams:
            s.result(timeout=240)
    finally:
        eng.stop()
    for ours, theirs in zip(streams, jstreams):
        assert ours.tokens == theirs.tokens
        assert all(lp <= 0.0 for lp in ours.logprobs)
        np.testing.assert_allclose(ours.logprobs, theirs.logprobs,
                                   rtol=1e-5, atol=1e-5)


def test_attention_auto_equals_reference():
    prompt = np.random.default_rng(4).integers(1, CFG.vocab, 12).tolist()
    outs = {}
    for mode in ("auto", "reference"):
        eng = _engine(max_streams=2, attention=mode).start()
        try:
            outs[mode] = eng.generate(prompt, max_new_tokens=16, timeout=120)
        finally:
            eng.stop()
    assert outs["auto"] == outs["reference"] == reference_greedy(prompt, 16)


def test_auto_k_calibrates_and_generates():
    prompt = np.random.default_rng(5).integers(1, CFG.vocab, 10).tolist()
    eng = _engine(max_streams=2, steps_per_dispatch="auto").start()
    try:
        assert eng.K in (8, 16, 32, 64, 128)
        got = eng.generate(prompt, max_new_tokens=12, timeout=120)
    finally:
        eng.stop()
    assert got == reference_greedy(prompt, 12)


def test_cancel_frees_the_slot():
    eng = _engine(max_streams=1).start()
    try:
        s = eng.submit([1, 2, 3], max_new_tokens=50)
        next(iter(s))  # generation is under way
        s.cancel()
        s.result(timeout=60)
        assert s.finish_reason in ("cancelled", "length")
        # the slot is free again: a second stream completes
        assert eng.generate([4, 5], max_new_tokens=3, timeout=60) == \
            reference_greedy([4, 5], 3)
        queued = eng.submit([6], max_new_tokens=40)
        queued.cancel()
        queued.result(timeout=60)
        assert queued.finish_reason == "cancelled"
    finally:
        eng.stop()


def test_stop_finishes_every_stream_and_refuses_new_ones():
    eng = _engine(max_streams=1).start()
    streams = [eng.submit([1 + i], max_new_tokens=40) for i in range(3)]
    eng.stop()
    for s in streams:
        s.result(timeout=10)
        assert s.finished and s.finish_reason in ("length",
                                                  "engine-stopped")
    with pytest.raises(RuntimeError):
        eng.submit([1], max_new_tokens=2)


def test_submit_before_start_raises():
    eng = _engine()
    with pytest.raises(RuntimeError, match="start"):
        eng.submit([1, 2], max_new_tokens=2)


def test_invalid_prompts_rejected(engine):
    with pytest.raises(ValueError):
        engine.submit([], max_new_tokens=3)
    with pytest.raises(ValueError):
        engine.submit(list(range(CFG.max_seq)), max_new_tokens=3)
    with pytest.raises(ValueError):
        engine.submit([1, 2], max_new_tokens=0)


def test_stats_and_metrics(engine):
    before = dict(engine.stats)
    engine.generate([7, 8, 9], max_new_tokens=6, timeout=60)
    assert engine.stats["prefills"] == before["prefills"] + 1
    assert engine.stats["tokens_generated"] == \
        before["tokens_generated"] + 6
    assert engine.stats["dispatches"] > before["dispatches"]
    snap = get_registry().snapshot()
    text = str(snap)
    assert "nns_lm_ttft_p50_ms" in text
    assert engine.obs_name in text


def test_stream_iterates_tokens(engine):
    s = engine.submit([3, 1, 4], max_new_tokens=5)
    assert list(s) == reference_greedy([3, 1, 4], 5)
    assert isinstance(s, GenerationStream) and s.finish_reason == "length"


def test_registry_round_trip(engine):
    register_engine("lm_registry", engine)
    try:
        assert get_engine("lm_registry") is engine
    finally:
        assert unregister_engine("lm_registry")
    assert get_engine("lm_registry") is None


def test_bf16_engine_runs():
    cfg = ttr.TransformerConfig(vocab=50, d_model=32, n_heads=2, n_layers=2,
                                d_ff=64, max_seq=32)
    eng = ContinuousBatchingEngine(cfg, ttr.init_params(cfg), max_streams=2,
                                   steps_per_dispatch=4,
                                   device="cpu").start()
    try:
        s = eng.submit([1, 2, 3], max_new_tokens=7)
        got = s.result(timeout=60)
    finally:
        eng.stop()
    assert eng._cache.dtype is torch.bfloat16
    assert eng.params["w_in"].dtype is torch.bfloat16
    assert eng.params["embed"].dtype is torch.float32
    assert len(got) == 7 and all(0 <= t < 50 for t in got)
    assert all(np.isfinite(s.logprobs))


def test_default_device_without_cuda_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setattr(device_mod, "_device", None)
    with pytest.raises(RuntimeError, match="set_device"):
        ContinuousBatchingEngine(CFG, PARAMS)


@pytest.mark.parametrize("kw,item", [
    ({"mesh": object()}, "A.24"),
    # the paged cache (A.13.3) and speculation (A.13.4) are ported: with
    # them, the options that remain unported still raise
    ({"block_tokens": 8, "mesh": object()}, "A.24"),
    ({"speculate": 2, "top_k": 8}, "A.13.5"),
    ({"slo_budget_ms": 50.0, "block_tokens": 8, "min_p": 0.1}, "A.13.5"),
    ({"temperature": 0.8}, "A.13.5"),
    ({"temperature": 0.8, "top_k": 8}, "A.13.5"),
    ({"top_k": 8}, "A.13.5"),
    ({"min_p": 0.1}, "A.13.5"),
])
def test_unported_options_raise_with_their_item(kw, item):
    with pytest.raises(NotImplementedError, match=item.replace(".", r"\.")):
        _engine(**kw)


@pytest.mark.parametrize("kw", [{"prefill_chunk": 8}, {"prefix_cache": 2},
                                {"kv_quant": "int8"}])
def test_formerly_unported_options_serve(kw):
    """The three options that raised until A.13.1 and A.13.2 were ported:
    each engine serves, the raw-cache ones the exact greedy tokens and the
    int8 one the JAX int8 engine's."""
    prompt = [5, 11, 23, 42, 7, 9, 14, 27, 5, 18]
    eng = _engine(max_streams=2, **kw).start()
    try:
        got = [eng.generate(prompt, max_new_tokens=7, timeout=120)
               for _ in range(2)]
    finally:
        eng.stop()
    if "kv_quant" in kw:
        jeng = JaxEngine(JCFG, JPARAMS, max_streams=2, steps_per_dispatch=4,
                         temperature=0.0, **kw).start()
        try:
            ref = jeng.generate(prompt, max_new_tokens=7, timeout=240)
        finally:
            jeng.stop()
    else:
        ref = reference_greedy(prompt, 7)
    assert got == [ref, ref]


def test_bad_attention_mode_is_a_value_error():
    with pytest.raises(ValueError):
        _engine(attention="flash")


def test_head_dim_outside_the_kernel_raises_for_the_card_only():
    """On the card "auto" attention is kernel B2 or an error, never the
    plain version behind the caller's back; the check comes before
    anything moves to the device."""
    cfg = ttr.TransformerConfig(vocab=50, d_model=24, n_heads=2, n_layers=1,
                                d_ff=32, max_seq=32, dtype=torch.float32)
    params = ttr.init_params(cfg)
    with pytest.raises(ValueError, match="head_dim 12"):
        ContinuousBatchingEngine(cfg, params, device="cuda")
    eng = ContinuousBatchingEngine(cfg, params, max_streams=1,
                                   steps_per_dispatch=2, device="cpu")
    assert eng.device.type == "cpu"


def test_engine_thread_runs_in_inference_mode(engine):
    seen = {}
    orig = engine._decode

    def spy(*a):
        seen["inference"] = torch.is_inference_mode_enabled()
        return orig(*a)

    engine._decode = spy
    try:
        engine.generate([2, 4], max_new_tokens=5, timeout=60)
    finally:
        engine._decode = orig
    assert seen["inference"] is True


def test_bucket_sizes(engine):
    assert [engine._bucket(n) for n in (1, 16, 17, 33, 63)] == \
        [16, 16, 32, 64, 64]


# -- chunked prefill and the prefix cache, against the JAX engine ------------
#: the counters both engines keep; with one request at a time every one of
#: them follows from the requests alone
STAT_KEYS = ("tokens_generated", "dispatches", "prefills", "prefill_chunks",
             "slot_steps", "active_slot_steps", "prefix_hits",
             "prefix_tokens_reused")


def _run_both(requests, models=((JCFG, JPARAMS), (CFG, PARAMS)), **kw):
    """The same requests, one after another, through the JAX engine and
    the port's (``models``: each one's config and params): the port's
    tokens, stats counters and engine, once both engines agree."""
    (jcfg, jparams), (tcfg, tparams) = models
    kw.setdefault("max_streams", 2)
    kw.setdefault("steps_per_dispatch", 4)
    out = {}
    for name, make in (
            ("jax", lambda: JaxEngine(jcfg, jparams, temperature=0.0, **kw)),
            ("port", lambda: ContinuousBatchingEngine(tcfg, tparams,
                                                      device="cpu", **kw))):
        eng = make().start()
        try:
            toks = [eng.generate(p, max_new_tokens=m, timeout=240)
                    for p, m in requests]
        finally:
            eng.stop()
        out[name] = (toks, {k: eng.stats[k] for k in STAT_KEYS}, eng)
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    return out["port"]


@pytest.mark.parametrize("chunk", [4, 8, 12])
def test_chunked_prefill_matches_the_jax_engine(chunk):
    """Lengths below, at and above chunk boundaries: the tokens of
    whole-prompt prefill, and the JAX engine's chunk count."""
    requests = [([(i * 13 + 5) % CFG.vocab for i in range(n)], 6)
                for n in (1, chunk - 1, chunk, chunk + 1, 2 * chunk, 37)]
    toks, stats, _ = _run_both(requests, prefill_chunk=chunk)
    for (p, m), got in zip(requests, toks):
        assert got == reference_greedy(p, m), f"len={len(p)}"
    assert stats["prefill_chunks"] == sum(-(-len(p) // chunk)
                                          for p, _ in requests)


@pytest.mark.parametrize("chunk,n,limit", [(8, 63, 63), (12, 60, 60)])
def test_chunked_prefill_prompt_limit(chunk, n, limit):
    """The bound is ceil(n/C)*C <= S: C = 8 divides S = 64 and keeps the
    unchunked 63; C = 12 does not, and the limit is (64 // 12) * 12 =
    60. The longest prompt serves S - n tokens."""
    eng = _engine(max_streams=1, prefill_chunk=chunk).start()
    try:
        with pytest.raises(ValueError, match=f"<= {limit}"):
            eng.submit(list(range(1, limit + 2)), max_new_tokens=2)
        prompt = [(i * 7 + 2) % CFG.vocab for i in range(n)]
        got = eng.generate(prompt, max_new_tokens=9, timeout=240)
    finally:
        eng.stop()
    assert got == reference_greedy(prompt, CFG.max_seq - n)


def test_prefill_chunk_validation():
    for bad in (0, CFG.max_seq, -3):
        with pytest.raises(ValueError):
            _engine(prefill_chunk=bad)


def test_chunked_prefill_interleaves_with_decode():
    """A long prompt admitted while another stream decodes: both exact
    (prefill chunks run between decode dispatches)."""
    eng = _engine(max_streams=2, steps_per_dispatch=2,
                  prefill_chunk=4).start()
    try:
        a = eng.submit([5, 11, 23], max_new_tokens=20)
        long_prompt = [(i * 7 + 2) % CFG.vocab for i in range(30)]
        b = eng.submit(long_prompt, max_new_tokens=8)
        ra, rb = a.result(timeout=240), b.result(timeout=240)
    finally:
        eng.stop()
    assert ra == reference_greedy([5, 11, 23], 20)
    assert rb == reference_greedy(long_prompt, 8)
    assert eng.stats["prefill_chunks"] == 8 + 1  # 30/4 → 8, + the short one


def test_reserved_slot_is_not_a_stream():
    """A slot that a chunked prefill reserves counts in no active stream;
    stop() finishes the half-ingested request and frees the slot."""
    eng = _engine(max_streams=2, prefill_chunk=4)
    req = engine_mod._PendingRequest(np.arange(1, 10, dtype=np.int32), 3,
                                     GenerationStream(0, 9))
    with torch.inference_mode():
        eng._begin_partial(req, 1)
    assert eng._slots[1] is eng._RESERVED and eng.active_streams == 0
    eng.stop()
    assert req.stream.finish_reason == "engine-stopped"
    assert eng._slots == [None, None] and eng._partial is None


def test_cancel_during_chunked_prefill_frees_the_slot():
    eng = _engine(max_streams=1, prefill_chunk=4).start()
    try:
        long_prompt = [(i * 7 + 2) % CFG.vocab for i in range(40)]
        s = eng.submit(long_prompt, max_new_tokens=20)
        s.cancel()
        s.result(timeout=60)
        assert s.finish_reason in ("cancelled", "length")
        assert eng.generate([4, 5], max_new_tokens=3, timeout=60) == \
            reference_greedy([4, 5], 3)
    finally:
        eng.stop()


PREFIX_CASES = {
    # an exact repeat: no prefill compute, the stored logits
    "exact_hit": [([5, 11, 23, 42], 7), ([5, 11, 23, 42], 7)],
    # A, then A + B: only B is prefilled
    "extension": [([7, 3, 11, 30, 2, 9], 3),
                  ([7, 3, 11, 30, 2, 9, 14, 27, 5], 9)],
    # two prompts sharing a preamble reuse the common prefix
    "shared_preamble": [([9, 21, 33, 45, 2, 17, 8, 30, 50, 51], 3),
                        ([9, 21, 33, 45, 2, 17, 8, 30, 60, 61, 62], 8)],
    # a prompt inside a longer entry: n - 1 positions reused
    "inside_longer": [([5, 11, 23, 42, 7, 9, 14], 3),
                      ([5, 11, 23, 42, 7, 9], 6)],
    # with [1..5] and [1..3] stored, [1..3] again takes the exact entry
    # (its first admission reuses 2 < PREFIX_MIN_REUSE: a miss)
    "exact_over_longer": [([1, 2, 3, 4, 5], 3), ([1, 2, 3], 3),
                          ([1, 2, 3], 3)],
    # LRU of one: the oldest is evicted, so the repeat misses
    "evicted": [([1, 2], 3), ([3, 4], 3), ([5, 6], 3), ([1, 2], 3)],
}


@pytest.mark.parametrize("case", sorted(PREFIX_CASES))
def test_prefix_cache_matches_the_jax_engine(case):
    requests = PREFIX_CASES[case]
    toks, stats, eng = _run_both(
        requests, prefix_cache=1 if case == "evicted" else 4)
    for (p, m), got in zip(requests, toks):
        assert got == reference_greedy(p, m), f"prompt={p}"
    hits = {"exact_hit": 1, "extension": 1, "shared_preamble": 1,
            "inside_longer": 1, "exact_over_longer": 1, "evicted": 0}[case]
    assert stats["prefix_hits"] == hits
    assert len(eng._prefix) == (1 if case == "evicted" else
                                len({tuple(p) for p, _ in requests}))


def test_prefix_cache_with_chunked_prefill_matches_the_jax_engine():
    """A 17-token prompt, then it + 9: the second resumes at chunk
    boundary 16 — two chunks, not ceil(26/8) = 4."""
    base = [(i * 13 + 5) % CFG.vocab for i in range(17)]
    full = base + [(i * 7 + 1) % CFG.vocab for i in range(9)]
    toks, stats, _ = _run_both([(base, 3), (full, 6), (full, 4)],
                               prefix_cache=4, prefill_chunk=8)
    assert toks[1] == reference_greedy(full, 6)
    assert toks[2] == reference_greedy(full, 4)
    assert stats["prefill_chunks"] == 3 + 2  # the exact repeat: none
    assert stats["prefix_tokens_reused"] == 16 + len(full)


def test_prefix_entries_hold_only_their_slots():
    """An entry keeps the prompt's n slots, copied out of the S-slot
    admission cache (a view would keep all S alive)."""
    eng = _engine(max_streams=1, prefix_cache=2).start()
    try:
        eng.generate([4, 8, 15, 16, 23], max_new_tokens=2, timeout=120)
    finally:
        eng.stop()
    (kv, logits), = eng._prefix.values()
    assert kv.values.shape[3] == 5 and logits.shape == (1, CFG.vocab)
    assert kv.values.untyped_storage().nbytes() == kv.nbytes


def test_prefix_cache_validation():
    with pytest.raises(ValueError):
        _engine(prefix_cache=-1)
    with pytest.raises(ValueError):
        _engine(kv_quant="int4")
