"""The port's continuous-batching engine (nnstreamer_tpu_torch/serving/
engine.py) on the CPU, held against the JAX package: greedy tokens EQUAL
to its exact-length prefill + one-at-a-time decode (``reference_greedy``
of tests/test_serving.py) on the same seeded weights, whatever the batch
composition; logprobs within 1e-5 of the JAX engine's.
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu.serving import ContinuousBatchingEngine as JaxEngine
from nnstreamer_tpu_torch import device as device_mod
from nnstreamer_tpu_torch.models import transformer as ttr
from nnstreamer_tpu_torch.obs.registry import get_registry
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
    ({"block_tokens": 8}, "A.13.3"),
    ({"prefill_chunk": 8}, "A.13.2"),
    ({"prefix_cache": 2}, "A.13.2"),
    ({"kv_quant": "int8"}, "A.13.1"),
    ({"speculate": 2}, "A.13.4"),
    # the request-path budget is ported; the paged engine's deadlines
    # and shedding come with the paged cache
    ({"slo_budget_ms": 50.0, "block_tokens": 8}, "A.13.3"),
    ({"temperature": 0.8}, "A.13.5"),
    ({"temperature": 0.8, "top_k": 8}, "A.13.5"),
    ({"top_k": 8}, "A.13.5"),
    ({"min_p": 0.1}, "A.13.5"),
])
def test_unported_options_raise_with_their_item(kw, item):
    with pytest.raises(NotImplementedError, match=item.replace(".", r"\.")):
        _engine(**kw)


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
