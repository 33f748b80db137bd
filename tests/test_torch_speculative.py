"""The port's speculative decoding (nnstreamer_tpu_torch/models/
speculative.py and the engine's ``speculate``) on the CPU, held against
the JAX package's: the cases of tests/test_speculative.py and
tests/test_speculative_engine.py, on their configurations and the JAX
package's seeded weights (``params_from_jax``), float32.

- The chunk pass equals sequential steps (logits within rtol = atol =
  2e-5, the JAX test's bound).
- :class:`SpeculativeDecoder` gives the JAX decoder's tokens — equal to
  target-only greedy — for γ 1, 3 and 5, a perfect draft (every round
  emits γ+1), the cache window, a depth-pruned draft, ``fused=True``
  (one dispatch a generation, host-driven), R rounds a dispatch and an
  MoE target; and the JAX decoder's ``rounds``, ``tokens`` and
  ``dispatches``.
- The engine with ``speculate=2`` gives the JAX speculative engine's
  tokens, the non-speculative greedy tokens, in both cache modes, with
  drafts accepted; the greedy-only and ``set_speculate`` guards; and
  ``tensor_lm_serve speculate=`` reaching the engine.

The ``gpu`` tests hold the captured round (engine) and the captured
R-round dispatch (decoder) on the card against their eager bodies.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.models.speculative import SpeculativeDecoder as JaxDecoder
from nnstreamer_tpu.serving import ContinuousBatchingEngine as JaxEngine
from nnstreamer_tpu_torch.models import speculative as tsp
from nnstreamer_tpu_torch.models import transformer as ttr
from nnstreamer_tpu_torch.serving import (
    ContinuousBatchingEngine,
    register_engine,
    unregister_engine,
)
from tests.test_serving import CFG as S_JCFG
from tests.test_serving import PARAMS as S_JPARAMS
from tests.test_serving import reference_greedy
from tests.test_speculative import D_PARAMS as JD_PARAMS
from tests.test_speculative import DRAFT as JDRAFT
from tests.test_speculative import T_PARAMS as JT_PARAMS
from tests.test_speculative import TARGET as JTARGET
from tests.test_speculative import target_greedy


def tcfg(c):
    return ttr.TransformerConfig(vocab=c.vocab, d_model=c.d_model,
                                 n_heads=c.n_heads, n_layers=c.n_layers,
                                 d_ff=c.d_ff, max_seq=c.max_seq,
                                 dtype=torch.float32,
                                 num_experts=c.num_experts)


def tparams(p):
    return ttr.params_from_jax({k: np.asarray(v) for k, v in p.items()})


# tests/test_speculative.py's configurations and seeds, written out: the
# card's test runner stubs the JAX package (tools/gpu_tests.py)
TARGET = ttr.TransformerConfig(vocab=128, d_model=64, n_heads=4, n_layers=3,
                               d_ff=128, max_seq=96, dtype=torch.float32)
DRAFT = ttr.TransformerConfig(vocab=128, d_model=32, n_heads=2, n_layers=1,
                              d_ff=64, max_seq=96, dtype=torch.float32)
T_PARAMS = ttr.init_params(TARGET, seed=1)
D_PARAMS = ttr.init_params(DRAFT, seed=2)


def decoder(target=TARGET, tp=T_PARAMS, draft=DRAFT, dp=D_PARAMS, **kw):
    return tsp.SpeculativeDecoder(target, tp, draft, dp, device="cpu", **kw)


def both(prompt, n, fused=False, jargs=(JTARGET, JT_PARAMS, JDRAFT,
                                        JD_PARAMS), targs=None, **kw):
    """The port's and the JAX decoder's tokens and stats."""
    dec = decoder(*(targs or ()), **kw)
    got = dec.generate(prompt, max_new_tokens=n, fused=fused)
    jdec = JaxDecoder(*jargs, **kw)
    want = jdec.generate(prompt, max_new_tokens=n, fused=fused)
    assert got == want
    for k in ("rounds", "tokens", "dispatches"):
        assert dec.stats[k] == jdec.stats[k], k
    return got, dec


def test_configs_and_weights_are_the_jax_tests():
    assert (TARGET, DRAFT) == (tcfg(JTARGET), tcfg(JDRAFT))
    assert S_CFG == tcfg(S_JCFG)
    for mine, theirs in ((T_PARAMS, JT_PARAMS), (D_PARAMS, JD_PARAMS),
                         (S_PARAMS, S_JPARAMS)):
        assert sorted(mine) == sorted(theirs)
        for k, v in theirs.items():
            assert np.array_equal(mine[k].numpy(), np.asarray(v)), k


def test_chunk_decode_matches_sequential_steps():
    """One c-token chunk pass == c single-token steps (logits and
    cache)."""
    params = ttr.prepare_params(T_PARAMS, TARGET, "cpu")
    prefill = ttr.build_prefill(TARGET)
    decode = ttr.build_decode_step(TARGET)
    chunk = ttr.build_chunk_decode(TARGET)
    prompt = torch.tensor([[3, 1, 4, 1, 5]], dtype=torch.int32)
    toks = torch.tensor([[9, 2, 6, 5]], dtype=torch.int32)
    with torch.inference_mode():
        _, cache_a = prefill(params, prompt)
        _, cache_b = prefill(params, prompt)
        chunk_logits, _ = chunk(params, toks, cache_a, 5)
        seq = [decode(params, toks[:, i], cache_b, 5 + i)[0]
               for i in range(4)]
    np.testing.assert_allclose(chunk_logits.numpy(),
                               torch.stack(seq, 1).numpy(), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(cache_a.values.numpy(),
                               cache_b.values.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("gamma", [1, 3, 5])
def test_speculative_matches_target_greedy(gamma):
    prompt = [7, 21, 9, 63, 2]
    got, dec = both(prompt, 24, gamma=gamma)
    assert got == target_greedy(prompt, 24)
    assert dec.stats["rounds"] >= 1


def test_perfect_draft_accepts_everything():
    """Draft == target: every round emits γ+1 tokens (the full-acceptance
    path, with the d_γ draft-cache write)."""
    prompt = [5, 8, 13]
    got, dec = both(prompt, 21, jargs=(JTARGET, JT_PARAMS, JTARGET,
                                       JT_PARAMS),
                    targs=(TARGET, T_PARAMS, TARGET, T_PARAMS), gamma=4)
    assert got == target_greedy(prompt, 21)
    assert dec.mean_accepted == pytest.approx(5.0)  # γ+1 a round


def test_speculative_respects_cache_window():
    """Generation stops before a round's writes would spill past S."""
    prompt = list(range(1, 80))  # 79 of S = 96
    got, _ = both(prompt, 64, gamma=6)
    assert got == target_greedy(prompt, len(got))
    assert 1 <= len(got) < 64


def test_self_speculative_draft_matches_target_greedy():
    from nnstreamer_tpu.models.speculative import draft_from_target

    d_cfg, d_params = tsp.draft_from_target(TARGET, T_PARAMS, 1)
    jd_cfg, jd_params = draft_from_target(JTARGET, JT_PARAMS, 1)
    assert d_cfg.n_layers == jd_cfg.n_layers == 1
    for k, v in d_params.items():
        assert np.array_equal(v.numpy(), np.asarray(jd_params[k]))
        if k not in ("embed", "ln_f"):
            assert v.data_ptr() == T_PARAMS[k].data_ptr()  # a view
    prompt = [11, 3, 77, 19]
    got, dec = both(prompt, 20, jargs=(JTARGET, JT_PARAMS, jd_cfg,
                                       jd_params),
                    targs=(TARGET, T_PARAMS, d_cfg, d_params), gamma=3,
                    rounds_per_dispatch=3)
    assert got == target_greedy(prompt, 20)
    assert dec.mean_accepted >= 1.0


def test_fused_generation_matches_target_greedy():
    """``fused=True`` (the JAX one-program while loop, driven from the
    host here) is exact too and counts one dispatch a generation."""
    prompt = [7, 21, 9, 63, 2]
    dec = decoder(gamma=3)
    jdec = JaxDecoder(JTARGET, JT_PARAMS, JDRAFT, JD_PARAMS, gamma=3)
    got = dec.generate(prompt, max_new_tokens=24, fused=True)
    assert got == jdec.generate(prompt, max_new_tokens=24, fused=True)
    assert got == target_greedy(prompt, 24)
    assert dec.stats["dispatches"] == 1 and dec.stats["rounds"] >= 1
    assert dec.stats["host_reads"] == -(-dec.stats["rounds"] // dec.R)
    long_prompt = list(range(1, 80))  # window-limited, still exact
    got2 = dec.generate(long_prompt, max_new_tokens=64, fused=True)
    assert got2 == jdec.generate(long_prompt, max_new_tokens=64, fused=True)
    assert got2 == target_greedy(long_prompt, len(got2))
    assert 1 <= len(got2) < 64
    for k in ("rounds", "tokens", "dispatches"):
        assert dec.stats[k] == jdec.stats[k], k


def test_build_speculative_generate_matches_jax():
    from nnstreamer_tpu.models import speculative as jsp
    from nnstreamer_tpu.models import transformer as jtr

    prompt = np.asarray([[7, 21, 9, 63, 2]], np.int32)
    jl, jtc = jax.jit(jtr.build_prefill(JTARGET))(JT_PARAMS,
                                                  jnp.asarray(prompt))
    _, jdc = jax.jit(jtr.build_prefill(JDRAFT))(JD_PARAMS,
                                                jnp.asarray(prompt))
    first = int(jnp.argmax(jl[0]))
    jbuf, jcr = jax.jit(jsp.build_speculative_generate(
        JTARGET, JDRAFT, 3, 16))(JT_PARAMS, JD_PARAMS,
                                 jnp.asarray([first], jnp.int32), jtc, jdc,
                                 jnp.asarray(5, jnp.int32))
    tp = ttr.prepare_params(T_PARAMS, TARGET, "cpu")
    dp = ttr.prepare_params(D_PARAMS, DRAFT, "cpu")
    with torch.inference_mode():
        _, tc = ttr.build_prefill(TARGET)(tp, torch.from_numpy(prompt))
        _, dc = ttr.build_prefill(DRAFT)(dp, torch.from_numpy(prompt))
        buf, cr = tsp.build_speculative_generate(TARGET, DRAFT, 3, 16)(
            tp, dp, torch.tensor([first], dtype=torch.int32), tc, dc,
            torch.tensor([5]))
    count = int(cr[0])
    assert cr.tolist() == np.asarray(jcr).tolist()
    assert buf.shape == jbuf.shape
    assert buf[0, :count].tolist() == np.asarray(jbuf)[0, :count].tolist()


def test_multi_round_dispatch_counts():
    """R rounds a dispatch: host reads = dispatches <= rounds <= R ×
    dispatches."""
    prompt = [2, 4, 6]
    got, dec = both(prompt, 16, gamma=2, rounds_per_dispatch=4)
    assert got == target_greedy(prompt, 16)
    assert dec.stats["dispatches"] <= dec.stats["rounds"]
    assert dec.stats["rounds"] <= dec.stats["dispatches"] * 4
    assert dec.stats["host_reads"] == dec.stats["dispatches"]


def test_moe_target_speculative_exact():
    """MoE target and a depth-pruned MoE draft: the chunk verify routes
    experts as sequential decode does."""
    from nnstreamer_tpu.models.speculative import draft_from_target
    from nnstreamer_tpu.models.transformer import TransformerConfig
    from nnstreamer_tpu.models.transformer import init_params as jinit

    jmoe = TransformerConfig(vocab=128, d_model=64, n_heads=4, n_layers=2,
                             d_ff=64, max_seq=96, dtype=jnp.float32,
                             num_experts=4)
    jmoe_params = jinit(jmoe, seed=9)
    jd_cfg, jd_params = draft_from_target(jmoe, jmoe_params, 1)
    moe, moe_params = tcfg(jmoe), tparams(jmoe_params)
    d_cfg, d_params = tsp.draft_from_target(moe, moe_params, 1)
    prompt = [7, 21, 9]
    got, _ = both(prompt, 15, jargs=(jmoe, jmoe_params, jd_cfg, jd_params),
                  targs=(moe, moe_params, d_cfg, d_params), gamma=3)
    assert got == target_greedy(prompt, 15, cfg=jmoe, params=jmoe_params)


def test_config_validation():
    with pytest.raises(ValueError):
        tsp.build_speculative_round(
            TARGET, ttr.TransformerConfig(vocab=64, d_model=32, n_heads=2,
                                          n_layers=1, d_ff=64), gamma=2)
    with pytest.raises(ValueError):
        tsp.build_speculative_round(TARGET, DRAFT, gamma=0)
    dec = decoder(gamma=2)
    with pytest.raises(ValueError):
        dec.generate([], max_new_tokens=4)
    with pytest.raises(ValueError):
        tsp.draft_from_target(TARGET, T_PARAMS, 0)
    with pytest.raises(ValueError, match="batch must be 1"):
        spec_round = tsp.build_speculative_round(TARGET, DRAFT, gamma=2)
        spec_round(None, None, torch.zeros(2, dtype=torch.int32), None,
                   None, torch.zeros(2))


# -- the engine's speculate=, against the JAX engine ---------------------------
S_CFG = ttr.TransformerConfig(vocab=97, d_model=64, n_heads=4, n_layers=2,
                              d_ff=128, max_seq=64, dtype=torch.float32)
S_PARAMS = ttr.init_params(S_CFG, seed=3)  # tests/test_serving.py's seed
PROMPTS = [[5, 11, 23, 42, 7], [4, 8, 15], [16, 23], [2, 2, 2, 2, 2]]


def spec_engine(device="cpu", **kw):
    kw.setdefault("max_streams", 2)
    kw.setdefault("steps_per_dispatch", 4)
    kw.setdefault("speculate", 2)
    return ContinuousBatchingEngine(S_CFG, S_PARAMS, device=device, **kw)


def _serve_both_ways(eng):
    one = [eng.generate(p, max_new_tokens=9, timeout=240) for p in PROMPTS]
    streams = [eng.submit(p, max_new_tokens=9) for p in PROMPTS]
    return one, [s.result(timeout=240) for s in streams]


@pytest.mark.parametrize("block_tokens", [0, 8],
                         ids=["monolithic", "paged"])
def test_speculative_greedy_parity(block_tokens):
    eng = spec_engine(block_tokens=block_tokens).start()
    try:
        assert eng.paged == (block_tokens > 0)
        one, conc = _serve_both_ways(eng)
        stats = dict(eng.stats)
    finally:
        eng.stop()
    jeng = JaxEngine(S_JCFG, S_JPARAMS, max_streams=2, steps_per_dispatch=4,
                     temperature=0.0, speculate=2,
                     block_tokens=block_tokens).start()
    try:
        jone, jconc = _serve_both_ways(jeng)
        jstats = dict(jeng.stats)
    finally:
        jeng.stop()
    assert one == jone and conc == jconc
    for p, a, b in zip(PROMPTS, one, conc):
        assert a == b == reference_greedy(p, 9), f"prompt={p}"
    assert stats["spec_drafted"] > 0
    # the 1-layer draft tracks the 2-layer target at this size: some
    # acceptance guards against a verifier that silently rejects all
    assert stats["spec_accepted"] > 0
    # one request at a time, both engines run the same rounds
    assert eng.stats["prefills"] == jstats["prefills"] == 2 * len(PROMPTS)


def test_speculate_requires_greedy():
    with pytest.raises(ValueError, match="greedy"):
        spec_engine(temperature=0.8)


def test_set_speculate_guards():
    eng = ContinuousBatchingEngine(S_CFG, S_PARAMS, max_streams=2,
                                   device="cpu")
    with pytest.raises(ValueError):
        eng.set_speculate(-1)
    with pytest.raises(ValueError):
        eng.set_speculate(S_CFG.max_seq)
    eng.start()
    try:
        with pytest.raises(RuntimeError, match="stopped"):
            eng.set_speculate(3)
    finally:
        eng.stop()


def test_speculate_prompt_limit_and_budget():
    """A verify chunk writes through pos + γ: prompts are held to S - 1 -
    γ and a stream's budget to S - n - γ, as in the JAX engine."""
    eng = spec_engine(max_streams=1, speculate=3).start()
    try:
        with pytest.raises(ValueError, match=f"<= {S_CFG.max_seq - 4}"):
            eng.submit(list(range(1, S_CFG.max_seq - 2)), max_new_tokens=2)
        prompt = list(range(1, 55))
        got = eng.generate(prompt, max_new_tokens=50, timeout=240)
    finally:
        eng.stop()
    assert got == reference_greedy(prompt, S_CFG.max_seq - len(prompt) - 3)


def test_lm_serve_speculate_property_configures_engine():
    """``tensor_lm_serve speculate=K`` reaches the engine at element
    start: the pipeline string is the opt-in surface."""
    engine = ContinuousBatchingEngine(S_CFG, S_PARAMS, max_streams=2,
                                      steps_per_dispatch=4, device="cpu")
    register_engine("lm_spec_port", engine)
    tnt.set_device("cpu")
    server = tnt.parse_launch(
        "tensor_query_serversrc name=ssrc port=0 ! "
        "tensor_lm_serve engine=lm_spec_port max-new-tokens=4 "
        "speculate=2 speculate-layers=1 name=serve ! "
        "tensor_query_serversink")
    try:
        server.start()
        assert engine.speculate == 2
        assert engine._speculate_layers == 1
        assert engine._spec["dcfg"].n_layers == 1
    finally:
        server.stop()
        unregister_engine("lm_spec_port")
        tnt.set_device(None)


# -- on the card ---------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the round is captured")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("block_tokens", [0, 8],
                         ids=["monolithic", "paged"])
def test_speculative_round_graph_on_the_card(block_tokens):
    """One capture of the round (tagged γ), a replay a round, and the
    tokens of the eager round and of the non-speculative engine."""
    _card()
    eager = spec_engine("cuda", block_tokens=block_tokens)
    eager._eager_dispatch = True
    eager.start()
    try:
        ref = _serve_both_ways(eager)
    finally:
        eager.stop()
    plain = ContinuousBatchingEngine(S_CFG, S_PARAMS, device="cuda",
                                     max_streams=2,
                                     steps_per_dispatch=4).start()
    try:
        greedy = _serve_both_ways(plain)
    finally:
        plain.stop()
    eng = spec_engine("cuda", block_tokens=block_tokens).start()
    try:
        got = _serve_both_ways(eng)
    finally:
        eng.stop()
    assert got == ref == greedy
    assert eng.graph_stats["captures"] == [2]
    assert eng.graph_stats["replays"] == eng.stats["dispatches"] > 0
    assert eng.stats["spec_accepted"] > 0


@pytest.mark.gpu
def test_decoder_dispatch_graph_on_the_card():
    _card()
    prompt = [7, 21, 9, 63, 2]
    outs = {}
    for fused in (False, True):
        dec = tsp.SpeculativeDecoder(TARGET, T_PARAMS, DRAFT, D_PARAMS,
                                     gamma=3, device="cuda")
        outs[fused] = dec.generate(prompt, max_new_tokens=24, fused=fused)
        assert dec.graph_stats["captures"] == 1
        assert dec.graph_stats["replays"] == dec.stats["host_reads"] > 0
    ref = decoder(gamma=3).generate(prompt, max_new_tokens=24)
    assert outs[False] == outs[True] == ref
