"""The port's sampler (``nnstreamer_tpu_torch/models/transformer.py::
make_sampler``, ROADMAP A.13.5) against the JAX package's, on the CPU.

The filter is the JAX sampler's, so the support a row may draw from is
held to JAX's formula exactly, ties at the k-th largest included, and to
the set JAX's own draws reach. The draw is Philox4x32-10 keyed by (seed,
stream id) at the token's position, where JAX draws with threefry: the
two are held to the same distribution (a chi-square over 20,000
fixed-seed draws against the exact filtered softmax, p >= 1e-3; the
seeds are fixed, so the test is deterministic), not bit for bit.
Greedy ignores ``top_k`` and ``min_p`` as JAX does (ROADMAP C.5).
Logprobs within 1e-5 of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from nnstreamer_tpu.models import transformer as jtr
from nnstreamer_tpu_torch.models import transformer as ttr
from nnstreamer_tpu_torch.ops.quantize import philox4x32_10

V = 61
LP_TOL = 1e-5
CHI2_DRAWS = 20000
CHI2_P_MIN = 1e-3


def _logits(rows, seed, step=None):
    """Seeded fp32 logits [rows, V]; ``step`` rounds them to a grid so
    that rows hold ties."""
    x = np.random.default_rng(seed).normal(0, 2, (rows, V))
    if step:
        x = np.round(x / step) * step
    return x.astype(np.float32)


def _jax_support(logits, temperature, top_k, min_p):
    """The JAX sampler's filter (nnstreamer_tpu/models/transformer.py:
    742-753), computed with its own formula: True where a token may be
    drawn."""
    scaled = jnp.asarray(logits) / temperature
    if top_k > 0:
        kth = jax.lax.top_k(scaled, min(top_k, V))[0][:, -1:]
        scaled = jnp.where(scaled >= kth, scaled, -1e30)
    if min_p > 0.0:
        smax = jnp.max(scaled, axis=-1, keepdims=True)
        scaled = jnp.where(scaled >= smax + np.log(min_p), scaled, -1e30)
    return np.asarray(scaled) > -1e30


def _jax_draws(logits_row, n, temperature, top_k, min_p):
    """JAX's own draws: n rows of one logit row, n threefry keys."""
    sample = jtr.make_sampler(V, temperature, top_k, min_p)
    keys = np.stack([np.arange(n, dtype=np.uint32),
                     np.full(n, 9, np.uint32)], 1)
    toks, _ = jax.jit(sample)(jnp.asarray(np.repeat(logits_row[None], n, 0)),
                              jnp.asarray(keys))
    return np.asarray(toks)


def _port_draws(logits_row, n, temperature, top_k, min_p, seed=11, sid=0):
    """The port's draws of one stream at counters 0..n-1."""
    sample = ttr.make_sampler(V, temperature, top_k, min_p)
    keys = ttr.sampling_keys(seed, [sid] * n, np.arange(n))
    toks, _ = sample(torch.from_numpy(np.repeat(logits_row[None], n, 0)),
                     keys)
    return toks.numpy()


@pytest.mark.parametrize("temperature,top_k,min_p", [
    (0.0, 5, 0.0), (0.0, 0, 0.3), (0.0, 3, 0.9), (-1.0, 1, 1.0),
    (0.0, 0, 0.0)])
def test_greedy_ignores_top_k_and_min_p_as_jax_does(temperature, top_k,
                                                    min_p):
    """ROADMAP C.5: at temperature <= 0 the JAX sampler is argmax whatever
    top_k and min_p say, and passes the keys through; the port no longer
    raises there. Tokens equal, logprobs within 1e-5."""
    logits = _logits(6, seed=1)
    jkeys = jnp.asarray(np.arange(12, dtype=np.uint32).reshape(6, 2))
    jt, jk, jlp = jtr.make_sampler(V, temperature, top_k, min_p,
                                   with_logprobs=True)(jnp.asarray(logits),
                                                       jkeys)
    keys = ttr.sampling_keys(3, range(6), 5)
    tt, tk, tlp = ttr.make_sampler(V, temperature, top_k, min_p,
                                   with_logprobs=True)(
        torch.from_numpy(logits), keys)
    assert np.array_equal(np.asarray(jk), np.asarray(jkeys))
    assert tk is keys
    assert tt.dtype == torch.int32 and tt.tolist() == np.asarray(jt).tolist()
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=0,
                               atol=LP_TOL)


SUPPORT_CASES = [
    # temperature, top_k, min_p, grid step of the logits (ties)
    (1.0, 5, 0.0, 0.5), (0.7, 8, 0.0, 0.25), (1.0, 0, 0.2, 0.5),
    (0.8, 12, 0.05, 0.25), (1.3, 3, 0.5, 1.0), (1.0, 100, 0.0, None),
    (0.5, 1, 0.0, 0.5), (1.0, 0, 1.0, 0.5),
]


@pytest.mark.parametrize("temperature,top_k,min_p,step", SUPPORT_CASES)
def test_support_matches_the_jax_formula(temperature, top_k, min_p, step):
    """The port's filtered logits keep exactly the tokens JAX's formula
    keeps (ties at the k-th largest stay in, so a support can exceed k),
    over rows that hold ties."""
    logits = _logits(16, seed=2, step=step)
    want = _jax_support(logits, temperature, top_k, min_p)
    sampler = ttr.make_sampler(V, temperature, top_k, min_p)
    got = sampler.filter(torch.from_numpy(logits)).numpy() > -1e30
    assert np.array_equal(got, want)
    if top_k and step and not min_p:
        # ties at the k-th largest: some row keeps more than k tokens
        assert (want.sum(1) > top_k).any()


@pytest.mark.parametrize("temperature,top_k,min_p,step", [
    (1.0, 5, 0.0, 0.5), (0.8, 8, 0.1, 0.25), (1.0, 0, 0.3, 0.5),
    (0.5, 1, 0.0, 0.5)])
def test_drawn_sets_equal_the_jax_samplers(temperature, top_k, min_p, step):
    """Over 4,000 draws of one row, the port's drawn tokens and JAX's own
    are the same set, and it is the support of JAX's formula (each token
    in it holds at least about 1 % of the mass here)."""
    logits = _logits(1, seed=4, step=step)
    support = set(np.flatnonzero(
        _jax_support(logits, temperature, top_k, min_p)[0]).tolist())
    mine = set(_port_draws(logits[0], 4000, temperature, top_k,
                           min_p).tolist())
    theirs = set(_jax_draws(logits[0], 4000, temperature, top_k,
                            min_p).tolist())
    assert mine == theirs == support


@pytest.mark.parametrize("temperature,top_k,min_p", [
    (0.8, 20, 0.01), (1.0, 0, 0.0), (1.5, 40, 0.0), (0.6, 0, 0.02)])
def test_chi_square_against_the_filtered_softmax(temperature, top_k, min_p):
    """20,000 draws of one stream (counters 0..19,999) on one logit row:
    no token outside the support, and the counts pass a chi-square
    against the exact filtered softmax at p >= 1e-3 (bins expecting fewer
    than 5 draws pooled)."""
    logits = _logits(1, seed=5)
    support = _jax_support(logits, temperature, top_k, min_p)[0]
    scaled = np.where(support, logits[0].astype(np.float64) / temperature,
                      -np.inf)
    probs = np.exp(scaled - scaled.max())
    probs /= probs.sum()
    toks = _port_draws(logits[0], CHI2_DRAWS, temperature, top_k, min_p)
    assert support[toks].all()
    counts = np.bincount(toks, minlength=V).astype(np.float64)
    expected = probs * CHI2_DRAWS
    big = expected >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    p = stats.chisquare(obs, exp).pvalue
    assert p >= CHI2_P_MIN, (p, obs, exp)


def test_logprobs_of_sampled_tokens_match_jax():
    """Sampled, the logprob is the chosen token's fp32 log_softmax of the
    unmodified logits (JAX's convention), within 1e-5."""
    logits = _logits(8, seed=6)
    toks, _, lp = ttr.make_sampler(V, 0.9, 10, 0.05, with_logprobs=True)(
        torch.from_numpy(logits), ttr.sampling_keys(2, range(8), 40))
    ref = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    np.testing.assert_allclose(lp.numpy(), ref[np.arange(8), toks.numpy()],
                               rtol=0, atol=LP_TOL)


def test_min_p_draws_respect_the_ratio():
    """tests/test_serving.py::test_min_p_sampling's sampler half: drawn
    tokens satisfy p >= min_p · p_max."""
    logits = _logits(1, seed=0)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits[0])))
    drawn = set(_port_draws(logits[0], 64, 1.0, 0, 0.5).tolist())
    assert all(probs[t] >= 0.5 * probs.max() - 1e-9 for t in drawn), drawn


def test_a_rows_draws_do_not_depend_on_the_other_rows():
    """Row 0's tokens over 200 counters are the same whatever the rows
    beside it hold (their logits and their keys) and however many there
    are."""
    sample = ttr.make_sampler(V, 0.9, 12, 0.02)
    row = _logits(1, seed=7)
    alone, together = [], []
    for c in range(200):
        keys = ttr.sampling_keys(5, [0], c)
        alone.append(int(sample(torch.from_numpy(row), keys)[0][0]))
        others = _logits(4, seed=100 + c)
        batch = np.concatenate([row, others])
        bkeys = torch.cat([keys, ttr.sampling_keys(5, [1, 2, 3, 9], c + 3)])
        together.append(int(sample(torch.from_numpy(batch), bkeys)[0][0]))
    assert alone == together
    assert len(set(alone)) > 1


def test_keys_advance_and_draws_repeat():
    """The returned keys keep the Philox key and count one further; the
    same keys draw the same tokens, another seed or stream other ones."""
    sample = ttr.make_sampler(V, 1.0)
    logits = torch.from_numpy(np.repeat(_logits(1, seed=8), 64, 0))
    keys = ttr.sampling_keys(7, range(64), 10)
    a, k2 = sample(logits, keys)
    b, _ = sample(logits, keys)
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert torch.equal(k2[:, 0], keys[:, 0])
    assert torch.equal(k2[:, 1], keys[:, 1] + 1)
    c, _ = sample(logits, ttr.sampling_keys(8, range(64), 10))
    assert not torch.equal(a, c)


@pytest.mark.parametrize("seed,stream_id,counter", [
    (0, 0, 0), (7, 3, 41), (2 ** 32 - 1, 2 ** 32 - 1, 2 ** 40 + 5),
    (2 ** 40 + 9, 2 ** 31, 2 ** 32), (12345, 2 ** 33 + 1, 1023)])
def test_philox_uniforms_are_quantizes_philox(seed, stream_id, counter):
    """The sampler's Philox (one int64 multiply a product) gives the words
    of ops/quantize.py's (16-bit limbs, no overflow), bit for bit: its
    uniform is the top 24 bits of word 0 under key (seed lo, stream id
    lo) at counter (counter lo, counter hi, 0, 0)."""
    keys = ttr.sampling_keys(seed, [stream_id], counter)
    got = int(ttr.philox_uniforms(keys)[0])
    t = torch.tensor
    words = philox4x32_10(
        (t(counter & 0xFFFFFFFF), t(counter >> 32), t(0), t(0)),
        (seed & 0xFFFFFFFF, stream_id & 0xFFFFFFFF))
    assert got == int(words[0]) >> 8
    assert 0 <= got < 2 ** 24


def test_inverse_cdf_never_draws_a_dropped_token():
    """Extreme uniforms (0 and 2**24 - 1) land on the first and the last
    token of positive probability, never on a dropped one."""
    filtered = torch.full((2, V), -1e30)
    filtered[:, [3, 17, 40]] = torch.tensor([0.0, 1.0, 2.0])
    u = torch.tensor([0, 2 ** 24 - 1])
    assert ttr.inverse_cdf(filtered, u).tolist() == [3, 40]
