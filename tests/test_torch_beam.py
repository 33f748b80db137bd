"""The port's beam search (``nnstreamer_tpu_torch/models/beam.py``,
ROADMAP A.13.8) on the CPU: the five cases of tests/test_beam.py on the
same model (tests/test_serving.py's configuration and seed, float32),
and the port held against the JAX package's ``BeamSearcher``: sequences
identical, scores within 1e-4. The load-bearing check is teacher-forced
re-scoring: every hypothesis's score equals the sum of its tokens'
log-probabilities under an independent full forward (within 2e-3, the
JAX test's bound), which catches parent-gather and cache-reorder bugs.
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu.models.beam import BeamSearcher as JaxBeamSearcher
from nnstreamer_tpu_torch.models import BeamSearcher
from nnstreamer_tpu_torch.models import transformer as ttr
from tests.test_serving import CFG as JCFG
from tests.test_serving import PARAMS as JPARAMS
from tests.test_serving import reference_greedy

CFG = ttr.TransformerConfig(vocab=97, d_model=64, n_heads=4, n_layers=2,
                            d_ff=128, max_seq=64, dtype=torch.float32)
PARAMS = ttr.init_params(CFG, seed=3)  # tests/test_serving.py's seed
RESCORE_TOL = 2e-3  # tests/test_beam.py's bound
JAX_SCORE_TOL = 1e-4

FWD = ttr.build_forward(CFG)


def rescore(prompt, seq):
    """Teacher-forced sum of the emitted tokens' log-probs."""
    toks = torch.tensor([list(prompt) + list(seq)], dtype=torch.int32)
    with torch.inference_mode():
        logp = torch.log_softmax(FWD(PARAMS, toks)[0].float(), dim=-1)
    n = len(prompt)
    return float(sum(logp[n + j - 1, seq[j]] for j in range(len(seq))))


def _searcher(**kw):
    return BeamSearcher(CFG, PARAMS, device="cpu", **kw)


def test_weights_are_the_jax_packages():
    for name, value in JPARAMS.items():
        assert np.array_equal(PARAMS[name].numpy(), np.asarray(value))


def test_width_one_is_greedy():
    prompt = [5, 11, 23, 42]
    seqs, scores = _searcher(beam_width=1, max_new=10).search(prompt)
    assert seqs.shape == (1, 10) and seqs.dtype == np.int32
    assert scores.dtype == np.float32
    assert seqs[0].tolist() == reference_greedy(prompt, 10)


def test_scores_match_teacher_forced_rescoring():
    prompt = [7, 3, 11, 30]
    seqs, scores = _searcher(beam_width=4, max_new=8).search(prompt)
    assert list(scores) == sorted(scores, reverse=True)
    for seq, score in zip(seqs, scores):
        assert score == pytest.approx(rescore(prompt, seq.tolist()),
                                      abs=RESCORE_TOL), seq
    greedy = reference_greedy(prompt, 8)
    assert scores[0] >= rescore(prompt, greedy) - RESCORE_TOL


def test_beams_are_distinct_hypotheses():
    seqs, _ = _searcher(beam_width=4, max_new=6).search([9, 21, 33])
    assert len({tuple(s) for s in seqs.tolist()}) == len(seqs)


def test_eos_freezes_beam():
    prompt = [5, 11, 23, 42]
    eos = reference_greedy(prompt, 8)[2]  # a token the search will emit
    seqs, scores = _searcher(beam_width=3, max_new=8,
                             eos_id=eos).search(prompt)
    for seq in seqs.tolist():
        if eos in seq:
            first = seq.index(eos)
            assert all(t == eos for t in seq[first:]), seq
    best = seqs[0].tolist()
    if eos in best:
        upto = best.index(eos) + 1
        assert scores[0] == pytest.approx(rescore(prompt, best[:upto]),
                                          abs=RESCORE_TOL)


def test_validation():
    # capacity boundary: n = S - max_new + 1 is EXACTLY admissible
    with pytest.raises(ValueError):
        _searcher(beam_width=0)
    with pytest.raises(ValueError):
        _searcher(beam_width=CFG.vocab + 1)
    with pytest.raises(ValueError):
        _searcher(max_new=0)
    bs = _searcher(beam_width=2, max_new=10)
    with pytest.raises(ValueError):
        bs.search(list(range(1, CFG.max_seq)))  # no room for max_new
    n_edge = CFG.max_seq - 10 + 1  # last decode write lands on slot S-1
    seqs, _ = bs.search(list(range(1, n_edge + 1)))
    assert seqs.shape == (2, 10)


@pytest.mark.parametrize("prompt,eos_at", [
    ([7, 3, 11, 30], None), ([5, 11, 23, 42], 2), ([9, 21, 33], None),
    ([1, 2, 3, 4, 5, 6, 7, 8, 9], 0)])
def test_matches_the_jax_beam_searcher(prompt, eos_at):
    """W = 4, max_new = 8, fp32: the JAX package's sequences, in its order
    (lax.top_k's and argsort's ties: the lower index first), and its
    scores within 1e-4; ``eos_at`` makes EOS the greedy continuation's
    token at that index."""
    eos_id = None if eos_at is None else \
        reference_greedy(prompt, 8)[eos_at]
    want_seqs, want_scores = JaxBeamSearcher(
        JCFG, JPARAMS, beam_width=4, max_new=8, eos_id=eos_id).search(prompt)
    seqs, scores = _searcher(beam_width=4, max_new=8,
                             eos_id=eos_id).search(prompt)
    assert seqs.tolist() == np.asarray(want_seqs).tolist()
    np.testing.assert_allclose(scores, np.asarray(want_scores), rtol=0,
                               atol=JAX_SCORE_TOL)


def test_ties_keep_the_lower_index_first():
    """The reselection's top W over [W·V] keeps lax.top_k's order on ties:
    equal candidates come out lower flat index first."""
    from nnstreamer_tpu_torch.models.beam import _top_k

    x = torch.tensor([1.0, 3.0, 3.0, 0.5, 3.0, 2.0])
    values, idx = _top_k(x, 4)
    assert idx.tolist() == [1, 2, 4, 5]
    assert values.tolist() == [3.0, 3.0, 3.0, 2.0]


def test_reorder_gathers_every_leaf_of_an_int8_cache():
    """The beams' reorder takes each beam's parent row in every leaf of
    the cache: the int8 codec's scales move with its values."""
    from nnstreamer_tpu_torch.models.beam import _reorder

    cache = ttr.init_cache(CFG, 3, kv_codec="int8")
    for row in range(3):
        cache.values[:, :, row] = row + 1
        cache.scale[:, :, row] = 0.5 * (row + 1)
    out = _reorder(cache, torch.tensor([2, 0, 0]))
    assert out is cache
    for row, parent in enumerate([2, 0, 0]):
        assert bool((cache.values[:, :, row] == parent + 1).all())
        assert bool((cache.scale[:, :, row] == 0.5 * (parent + 1)).all())


# -- on the card ---------------------------------------------------------------
@pytest.mark.gpu
def test_search_on_the_card_matches_the_cpu():
    """fp32 with TF32 off: the card's search gives the CPU's sequences and
    scores within 1e-4; its params and outputs live on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    prompt = [7, 3, 11, 30]
    card = BeamSearcher(CFG, PARAMS, beam_width=4, max_new=8)
    assert card.device.type == "cuda"
    seqs, scores = card.search(prompt)
    want_seqs, want_scores = _searcher(beam_width=4, max_new=8).search(prompt)
    assert seqs.tolist() == want_seqs.tolist()
    np.testing.assert_allclose(scores, want_scores, rtol=0,
                               atol=JAX_SCORE_TOL)
