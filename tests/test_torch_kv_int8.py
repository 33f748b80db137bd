"""The port's int8 KV cache (``models/transformer.py::_Int8KVCodec``,
the engine's ``kv_quant="int8"``) held against the JAX package's on the
configuration of tests/test_kv_int8.py, in float32 on the CPU, with the
JAX package's seeded weights (``params_from_jax``).

- The codec's int8 values and fp32 scales are bit-identical to the JAX
  codec's for the same k/v: the same per-vector absmax, the same division
  and round-half-to-even.
- Int8 prefill and decode logits within rtol = atol = 1e-5 of the JAX int8
  path's; the port's int8 against its raw cache within the JAX test's
  0.08 drift bound; chunk and sequential steps fill an identical int8
  cache (tests/test_kv_int8.py:76-96).
- The int8 engine's greedy tokens and stats equal the JAX int8 engine's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.models import transformer as jtr
from nnstreamer_tpu_torch.models import transformer as ttr
from tests.test_kv_int8 import CFG as JCFG
from tests.test_kv_int8 import PARAMS as JPARAMS
from tests.test_torch_serving import _run_both

CFG = ttr.TransformerConfig(vocab=JCFG.vocab, d_model=JCFG.d_model,
                            n_heads=JCFG.n_heads, n_layers=JCFG.n_layers,
                            d_ff=JCFG.d_ff, max_seq=JCFG.max_seq,
                            dtype=torch.float32)
PARAMS = ttr.params_from_jax({k: np.asarray(v) for k, v in JPARAMS.items()})
PROMPT = [[7, 3, 11, 30, 2]]
STEPS = [9, 14, 27, 5, 18, 40]
TOL = 1e-5


def _kv(kind: str, shape=(2, 3, 5, 4, 16)) -> np.ndarray:
    rng = np.random.default_rng(len(kind))
    if kind == "normal":
        return rng.standard_normal(shape).astype(np.float32)
    if kind == "magnitudes":  # per-vector scales from 1e-3 to 1e4
        mag = 10.0 ** rng.uniform(-3, 4, shape[:-1] + (1,))
        return (rng.standard_normal(shape) * mag).astype(np.float32)
    if kind == "zeros":  # amax 0: the 1e-30 floor, q = 0
        kv = rng.standard_normal(shape).astype(np.float32)
        kv[:, 1] = 0.0
        return kv
    if kind == "tiny":  # below the floor's reach: scale = 1e-30
        return (rng.standard_normal(shape) * 1e-33).astype(np.float32)
    # "halves": amax 127 makes the scale 1.0, so k + 0.5 rounds to even
    kv = rng.integers(-120, 120, shape).astype(np.float32) + 0.5
    kv[..., 0] = 127.0
    return kv


@pytest.mark.parametrize("kind", ["normal", "magnitudes", "zeros", "tiny",
                                  "halves"])
def test_codec_quantize_is_bit_identical_to_jax(kind):
    kv = _kv(kind)
    jq, js = jtr._Int8KVCodec()._q(jnp.asarray(kv))
    tq, ts = ttr._Int8KVCodec._q(torch.from_numpy(kv))
    assert tq.dtype is torch.int8 and ts.dtype is torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy().view(np.uint32),
                          np.asarray(js).view(np.uint32))


@pytest.mark.parametrize("per_row", [False, True])
def test_codec_write_is_bit_identical_to_jax(per_row):
    """A 3-slot run into a layer cache [2, b, S, h, dh], at one position or
    one per row: every value and scale of the cache as the JAX codec
    writes it."""
    kv = _kv("magnitudes", (2, 3, 3, 4, 16))
    pos = np.asarray([4, 0, 9], np.int32) if per_row else np.int32(6)
    jcache = jtr.init_cache(JCFG, 3, max_seq=16, kv_codec="int8")
    jlayer = {k: v[0] for k, v in jcache.items()}
    jout = jtr._Int8KVCodec().write(jlayer, jnp.asarray(kv),
                                    jnp.asarray(pos), per_row)
    tcache = ttr.init_cache(CFG, 3, max_seq=16, kv_codec="int8")
    start = torch.as_tensor(pos).long().expand(3)
    ttr._Int8KVCodec().write(tcache.map(lambda t: t[0]),
                             torch.from_numpy(kv), start)
    assert np.array_equal(tcache.values[0].numpy(), np.asarray(jout["q"]))
    assert np.array_equal(tcache.scale[0].numpy(),
                          np.asarray(jout["scale"]))
    assert not tcache.values[1].any()  # the other layer untouched


def test_place_prefix_is_bit_identical_to_jax():
    kv = _kv("normal", (2, 2, 2, 7, 4, 16))
    codec = jtr._Int8KVCodec()
    jout = codec.place_prefix(codec.init(2, 2, 16, 4, 16), jnp.asarray(kv))
    tout = ttr._Int8KVCodec().place_prefix(
        ttr.init_cache(CFG, 2, max_seq=16, kv_codec="int8"),
        torch.from_numpy(kv))
    assert np.array_equal(tout.values.numpy(), np.asarray(jout["q"]))
    assert np.array_equal(tout.scale.numpy(), np.asarray(jout["scale"]))


def test_int8_cache_halves_bytes():
    """int8 values are half of bf16; the scales add 4/dh a value."""
    bf16 = dataclasses.replace(CFG, dtype=torch.bfloat16)
    raw = ttr.init_cache(bf16, 2)
    q8 = ttr.init_cache(bf16, 2, kv_codec="int8")
    assert q8.nbytes < raw.nbytes * (0.5 + 4 / bf16.head_dim + 0.05)
    assert q8.nbytes == raw.nbytes // 2 + raw.nbytes // bf16.head_dim * 2


def _steps(decode, params, cache, start, to_tensor):
    logits = []
    tok, pos = STEPS[0], start
    for nxt in STEPS[1:] + [0]:
        lg, cache = decode(params, to_tensor([tok]), cache, pos)
        logits.append(np.asarray(lg))
        tok, pos = nxt, pos + 1
    return np.stack(logits, 1), cache


def _port_steps(codec):
    prefill = ttr.build_prefill(CFG, kv_codec=codec)
    l0, cache = prefill(PARAMS, torch.tensor(PROMPT, dtype=torch.int32))
    ls, cache = _steps(ttr.build_decode_step(CFG, kv_codec=codec), PARAMS,
                       cache, 5, lambda t: torch.tensor(t,
                                                        dtype=torch.int32))
    return l0.numpy(), ls, cache


def test_int8_prefill_and_decode_match_jax():
    """Prefill, then six steps on the int8 cache: the JAX int8 path's
    logits within 1e-5 at every step."""
    l0, cache = jtr.build_prefill(JCFG, kv_codec="int8")(
        JPARAMS, jnp.asarray(PROMPT, jnp.int32))
    ref, _ = _steps(jtr.build_decode_step(JCFG, kv_codec="int8"), JPARAMS,
                    cache, jnp.asarray(5, jnp.int32),
                    lambda t: jnp.asarray(t, jnp.int32))
    got0, got, _ = _port_steps("int8")
    np.testing.assert_allclose(got0, np.asarray(l0), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_int8_stays_near_the_raw_cache():
    """The JAX test's bound (tests/test_kv_int8.py:69-73): the int8 cache's
    logits within 0.08 × max|logit| of the raw cache's on every step."""
    _, raw, _ = _port_steps(None)
    _, q8, _ = _port_steps("int8")
    assert np.abs(raw - q8).max() < 0.08 * np.abs(raw).max()


def test_int8_chunk_matches_sequential_steps_exactly():
    """Same cache content → the same quantization: a 4-token chunk and
    four single steps fill identical int8 values (the scales carry the
    two matmul shapes' fp32 rounding of k and v), logits within 2e-5."""
    prefill = ttr.build_prefill(CFG, kv_codec="int8")
    prompt = torch.tensor([[3, 1, 4]], dtype=torch.int32)
    _, cache_a = prefill(PARAMS, prompt)
    _, cache_b = prefill(PARAMS, prompt)
    toks = torch.tensor([[9, 2, 6, 5]], dtype=torch.int32)
    chunk_logits, cache_a = ttr.build_chunk_decode(CFG, kv_codec="int8")(
        PARAMS, toks, cache_a, 3)
    step = ttr.build_decode_step(CFG, kv_codec="int8")
    seq = []
    for i in range(4):
        lg, cache_b = step(PARAMS, toks[:, i], cache_b, 3 + i)
        seq.append(lg)
    np.testing.assert_allclose(chunk_logits.numpy(),
                               torch.stack(seq, 1).numpy(),
                               rtol=2e-5, atol=2e-5)
    assert torch.equal(cache_a.values, cache_b.values)


def test_int8_chunk_matches_jax():
    _, jcache = jtr.build_prefill(JCFG, kv_codec="int8")(
        JPARAMS, jnp.asarray([[3, 1, 4]], jnp.int32))
    ref, _ = jtr.build_chunk_decode(JCFG, kv_codec="int8")(
        JPARAMS, jnp.asarray([[9, 2, 6, 5]], jnp.int32), jcache, 3)
    _, tcache = ttr.build_prefill(CFG, kv_codec="int8")(
        PARAMS, torch.tensor([[3, 1, 4]], dtype=torch.int32))
    got, _ = ttr.build_chunk_decode(CFG, kv_codec="int8")(
        PARAMS, torch.tensor([[9, 2, 6, 5]], dtype=torch.int32), tcache, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


MODELS = ((JCFG, JPARAMS), (CFG, PARAMS))


@pytest.mark.parametrize("kw", [{}, {"prefill_chunk": 4},
                                {"prefix_cache": 2}],
                         ids=["bucketed", "chunked", "prefix"])
def test_int8_engine_matches_the_jax_engine(kw):
    """kv_quant="int8": the JAX int8 engine's greedy tokens and stats,
    with bucketed prefill, chunked prefill and the prefix cache."""
    requests = [([5, 11, 23], 8), ([5, 11, 23, 42, 7, 9], 6),
                ([(i * 13 + 5) % CFG.vocab for i in range(19)], 5)]
    toks, _, eng = _run_both(requests, models=MODELS, kv_quant="int8", **kw)
    assert eng._cache.dtype is torch.int8
    assert [len(t) for t in toks] == [8, 6, 5]


def test_int8_first_token_equals_the_raw_engines():
    """The first token comes from the prefill's activations, before any
    cache read: the same with either cache."""
    requests = [([5, 11, 23], 4), ([40, 2, 17, 8, 1], 4)]
    q8, _, _ = _run_both(requests, models=MODELS, kv_quant="int8")
    raw, _, _ = _run_both(requests, models=MODELS)
    assert [t[0] for t in q8] == [t[0] for t in raw]
