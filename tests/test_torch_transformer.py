"""The port's decoder-only transformer (nnstreamer_tpu_torch/models/
transformer.py), held against the JAX package's on the same seeded
weights and the same numpy-made tokens, in float32 on the CPU.

The bound, rtol = atol = 2e-4, is the JAX package's own for a flash
prefill against the reference prefill (tests/test_flash_prefill.py:46-52).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.models import transformer as jtr
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.models import transformer as ttr

TOL = 2e-4

JCFG = jtr.TransformerConfig(vocab=97, d_model=64, n_heads=4, n_layers=2,
                             d_ff=128, max_seq=64, dtype=jnp.float32)
TCFG = ttr.TransformerConfig(vocab=97, d_model=64, n_heads=4, n_layers=2,
                             d_ff=128, max_seq=64, dtype=torch.float32)
JMOE = jtr.TransformerConfig(vocab=61, d_model=32, n_heads=2, n_layers=2,
                             d_ff=64, max_seq=32, dtype=jnp.float32,
                             num_experts=4)
TMOE = ttr.TransformerConfig(vocab=61, d_model=32, n_heads=2, n_layers=2,
                             d_ff=64, max_seq=32, dtype=torch.float32,
                             num_experts=4)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab, (b, s)).astype(np.int32)


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("jcfg,tcfg", [(JCFG, TCFG), (JMOE, TMOE)])
def test_init_params_bit_identical(jcfg, tcfg):
    jp = jtr.init_params(jcfg, seed=5)
    tp = ttr.init_params(tcfg, seed=5)
    assert sorted(jp) == sorted(tp)
    for name in jp:
        assert tp[name].dtype == torch.float32
        assert np.array_equal(tp[name].numpy(), np.asarray(jp[name])), name


def test_params_from_jax_round_trip():
    jp = jtr.init_params(JCFG, seed=6)
    carried = ttr.params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    own = ttr.init_params(TCFG, seed=6)
    for name in own:
        assert torch.equal(carried[name], own[name]), name
        assert np.array_equal(carried[name].numpy(), np.asarray(jp[name]))


@pytest.mark.parametrize("jcfg,tcfg", [(JCFG, TCFG), (JMOE, TMOE)])
def test_forward_matches_jax(jcfg, tcfg):
    tp = ttr.init_params(tcfg, seed=1)
    jp = jtr.init_params(jcfg, seed=1)
    toks = _tokens(jcfg, 2, 12, seed=1)
    ref = jtr.build_forward(jcfg)(jp, jnp.asarray(toks))
    got = ttr.build_forward(tcfg)(tp, torch.from_numpy(toks))
    assert tuple(got.shape) == (2, 12, jcfg.vocab)
    _close(got, ref)


@pytest.mark.parametrize("jcfg,tcfg", [(JCFG, TCFG), (JMOE, TMOE)])
def test_prefill_right_padded_matches_jax(jcfg, tcfg):
    tp = ttr.init_params(tcfg, seed=2)
    jp = jtr.init_params(jcfg, seed=2)
    toks = _tokens(jcfg, 2, 16, seed=2)
    lengths = np.asarray([11, 16], np.int32)
    toks[0, 11:] = 0  # right padding
    ref_logits, ref_cache = jtr.build_prefill(jcfg)(
        jp, jnp.asarray(toks), jnp.asarray(lengths))
    logits, cache = ttr.build_prefill(tcfg)(
        tp, torch.from_numpy(toks), torch.from_numpy(lengths))
    assert tuple(cache.values.shape) == tuple(ref_cache.shape)
    _close(logits, ref_logits)
    _close(cache.values, ref_cache)


def test_prefill_without_lengths_takes_the_last_position():
    tp = ttr.init_params(TCFG, seed=3)
    jp = jtr.init_params(JCFG, seed=3)
    toks = _tokens(JCFG, 1, 9, seed=3)
    ref_logits, _ = jtr.build_prefill(JCFG)(jp, jnp.asarray(toks))
    logits, _ = ttr.build_prefill(TCFG)(tp, torch.from_numpy(toks))
    _close(logits, ref_logits)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("jcfg,tcfg", [(JCFG, TCFG), (JMOE, TMOE)])
def test_decode_steps_match_jax(jcfg, tcfg, per_row):
    """Three decode steps off one prefill, with a scalar position for the
    whole batch or one position per row (different depths)."""
    tp = ttr.init_params(tcfg, seed=4)
    jp = jtr.init_params(jcfg, seed=4)
    toks = _tokens(jcfg, 2, 8, seed=4)
    _, jcache = jtr.build_prefill(jcfg)(jp, jnp.asarray(toks))
    _, tcache = ttr.build_prefill(tcfg)(tp, torch.from_numpy(toks))
    jstep = jtr.build_decode_step(jcfg)
    tstep = ttr.build_decode_step(tcfg)
    nxt = _tokens(jcfg, 3, 2, seed=5)
    for i in range(3):
        pos = np.asarray([8 + i, 5 + i], np.int32) if per_row \
            else np.int32(8 + i)
        ref, jcache = jstep(jp, jnp.asarray(nxt[i]), jcache,
                            jnp.asarray(pos))
        got, tcache = tstep(tp, torch.from_numpy(nxt[i]), tcache,
                            torch.as_tensor(pos))
        _close(got, ref)
    _close(tcache.values, jcache)


def test_decode_position_past_the_cache_is_clamped():
    tp = ttr.init_params(TCFG, seed=7)
    jp = jtr.init_params(JCFG, seed=7)
    toks = _tokens(JCFG, 1, 4, seed=7)
    _, jcache = jtr.build_prefill(JCFG)(jp, jnp.asarray(toks))
    _, tcache = ttr.build_prefill(TCFG)(tp, torch.from_numpy(toks))
    tok = np.asarray([3], np.int32)
    ref, _ = jtr.build_decode_step(JCFG)(jp, jnp.asarray(tok), jcache,
                                         jnp.asarray(np.int32(70)))
    got, _ = ttr.build_decode_step(TCFG)(tp, torch.from_numpy(tok), tcache,
                                         70)
    _close(got, ref)


def test_flash_prefill_equals_reference_prefill():
    """``attention_fn=flash_attention`` (the engine's "auto") and the
    default plain attention give the same prefill."""
    from nnstreamer_tpu_torch.ops.flash_attention import flash_attention

    tp = ttr.init_params(TCFG, seed=8)
    toks = torch.from_numpy(_tokens(TCFG, 2, 16, seed=8))
    a, ca = ttr.build_prefill(TCFG, attention_fn=flash_attention)(tp, toks)
    b, cb = ttr.build_prefill(TCFG)(tp, toks)
    assert torch.equal(a, b) and torch.equal(ca.values, cb.values)


def test_gelu_is_the_tanh_form(monkeypatch):
    """jax.nn.gelu defaults to approximate=True; the erf form gives other
    logits than the JAX package's: some 300 times further off than the
    tanh form's float32 noise."""
    tp = ttr.init_params(TCFG, seed=9)
    tp["w_in"] = tp["w_in"] * 20.0  # FFN inputs of order one
    jp = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
    toks = _tokens(JCFG, 1, 10, seed=9)
    ref = np.asarray(jtr.build_forward(JCFG)(jp, jnp.asarray(toks)))
    h = torch.linspace(-4, 4, 101)
    assert torch.equal(ttr._gelu(h), F.gelu(h, approximate="tanh"))
    tanh = ttr.build_forward(TCFG)(tp, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(tanh, ref, rtol=TOL, atol=TOL)
    monkeypatch.setattr(ttr, "_gelu", lambda x: F.gelu(x))
    erf = ttr.build_forward(TCFG)(tp, torch.from_numpy(toks)).numpy()
    assert np.abs(erf - ref).max() > 20 * np.abs(tanh - ref).max()


def test_greedy_sampler_matches_jax():
    rng = np.random.default_rng(10)
    logits = rng.normal(size=(5, 97)).astype(np.float32)
    jtoks, _, jlp = jtr.make_sampler(97, temperature=0.0,
                                     with_logprobs=True)(
        jnp.asarray(logits), jnp.zeros((5, 2), jnp.uint32))
    toks, keys, lp = ttr.make_sampler(97, temperature=0.0,
                                      with_logprobs=True)(
        torch.from_numpy(logits))
    assert toks.dtype == torch.int32 and keys is None
    assert toks.tolist() == np.asarray(jtoks).tolist()
    _close(lp, jlp, 1e-6)


def test_bf16_model_runs_in_bf16():
    cfg = ttr.TransformerConfig(vocab=50, d_model=32, n_heads=2, n_layers=1,
                                d_ff=64, max_seq=32)
    assert cfg.dtype is torch.bfloat16 and cfg.head_dim == 16
    params = ttr.prepare_params(ttr.init_params(cfg), cfg)
    assert params["qkv"].dtype is torch.bfloat16
    assert params["embed"].dtype is torch.float32
    assert params["ln1"].dtype is torch.float32
    toks = torch.from_numpy(_tokens(cfg, 1, 5, seed=11))
    logits, cache = ttr.build_prefill(cfg)(params, toks)
    assert logits.dtype is torch.float32 and cache.dtype is torch.bfloat16
    out, cache = ttr.build_decode_step(cfg)(
        params, torch.tensor([1], dtype=torch.int32), cache, 5)
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("call,item", [
    (lambda: ttr.make_sampler(97, temperature=0.8), "A.13.5"),
    (lambda: ttr.make_sampler(97, temperature=0.0, top_k=5), "A.13.5"),
    (lambda: ttr.make_sampler(97, temperature=0.0, min_p=0.1), "A.13.5"),
    # the paged builders and codec methods (A.13.3) are ported and held to
    # the JAX package in tests/test_torch_kvpool.py; these still raise
    (lambda: ttr.make_sampler(97, temperature=0.5, top_k=3), "A.13.5"),
    (lambda: ttr.make_sampler(97, temperature=0.5, min_p=0.2,
                              with_logprobs=True), "A.13.5"),
    (lambda: ttr.build_greedy_stream_step(TCFG, steps=4), "A.13.6"),
    (lambda: ttr.build_sample_stream_step(TCFG, temperature=0.5), "A.13.6"),
    (lambda: ttr.build_greedy_stream_step(TCFG), "A.13.6"),
    (lambda: ttr.build_sample_stream_step(TCFG), "A.13.6"),
])
def test_unported_parts_raise_with_their_item(call, item):
    with pytest.raises(NotImplementedError, match=item.replace(".", r"\.")):
        call()


@pytest.mark.parametrize("codec", [None, "int8"])
def test_init_cache_layouts(codec):
    """One cache type for both codecs: values [L, 2, b, S, h, dh] in the
    model dtype, or int8 with fp32 per-vector scales [L, 2, b, S, h]."""
    cache = ttr.init_cache(TCFG, 3, max_seq=16, kv_codec=codec)
    jcache = jtr.init_cache(JCFG, 3, max_seq=16, kv_codec=codec)
    assert isinstance(cache, ttr.KVCache)
    if codec is None:
        assert cache.scale is None and cache.dtype is torch.float32
        assert tuple(cache.values.shape) == tuple(jcache.shape)
    else:
        assert cache.dtype is torch.int8
        assert cache.scale.dtype is torch.float32
        assert tuple(cache.values.shape) == tuple(jcache["q"].shape)
        assert tuple(cache.scale.shape) == tuple(jcache["scale"].shape)
    assert cache.nbytes == sum(t.numel() * t.element_size()
                               for t in cache.leaves())
    assert all(not t.any() for t in cache.leaves())
    with pytest.raises(ValueError):
        ttr.init_cache(TCFG, 1, kv_codec="int4")


@pytest.mark.parametrize("pos0", [9, [9, 4], 70],
                         ids=["scalar", "per_row", "clamped"])
@pytest.mark.parametrize("codec", [None, "int8"])
def test_chunk_decode_matches_jax(codec, pos0):
    """build_chunk_decode against the JAX package's off one prefill: one
    origin for the batch, one per row, and an origin past the cache
    (clamped to S - c); raw and int8 caches. Logits within 2e-5, the JAX
    package's own chunk-against-steps bound (tests/test_kv_int8.py:93-94);
    the raw cache within it too."""
    tp = ttr.init_params(TCFG, seed=12)
    jp = jtr.init_params(JCFG, seed=12)
    toks = _tokens(JCFG, 2, 9, seed=12)
    _, jcache = jtr.build_prefill(JCFG, kv_codec=codec)(jp, jnp.asarray(toks))
    _, tcache = ttr.build_prefill(TCFG, kv_codec=codec)(
        tp, torch.from_numpy(toks))
    chunk = _tokens(JCFG, 2, 5, seed=13)
    ref, jcache = jtr.build_chunk_decode(JCFG, kv_codec=codec)(
        jp, jnp.asarray(chunk), jcache, jnp.asarray(pos0, jnp.int32))
    got, tcache = ttr.build_chunk_decode(TCFG, kv_codec=codec)(
        tp, torch.from_numpy(chunk), tcache, torch.as_tensor(pos0))
    assert tuple(got.shape) == (2, 5, JCFG.vocab)
    _close(got, ref, 2e-5)
    if codec is None:
        _close(tcache.values, jcache, 2e-5)


def test_chunk_of_one_equals_the_decode_step():
    """c = 1 is the decode step: the same logits and the same cache, bit
    for bit (one code path writes both)."""
    tp = ttr.init_params(TCFG, seed=14)
    toks = torch.from_numpy(_tokens(TCFG, 2, 6, seed=14))
    _, c1 = ttr.build_prefill(TCFG)(tp, toks)
    _, c2 = ttr.build_prefill(TCFG)(tp, toks)
    nxt = torch.from_numpy(_tokens(TCFG, 2, 1, seed=15))
    pos = torch.tensor([6, 3])
    a, c1 = ttr.build_decode_step(TCFG)(tp, nxt[:, 0], c1, pos)
    b, c2 = ttr.build_chunk_decode(TCFG)(tp, nxt, c2, pos)
    assert torch.equal(a, b[:, 0]) and torch.equal(c1.values, c2.values)


@pytest.mark.parametrize("part", ["init_cache_int8", "decode_step_int8",
                                  "chunk_decode"])
def test_formerly_unported_parts_run(part):
    """The three calls that raised until A.13.1 and A.13.2 were ported
    now build what the JAX package's build: the int8 cache, the int8 decode
    step and chunk decode, each run once against a prefill."""
    tp = ttr.init_params(TCFG, seed=16)
    toks = torch.from_numpy(_tokens(TCFG, 1, 6, seed=16))
    codec = None if part == "chunk_decode" else "int8"
    if part == "init_cache_int8":
        cache = ttr.init_cache(TCFG, 1, kv_codec="int8")
        assert cache.values.dtype is torch.int8
        assert tuple(cache.scale.shape) == (2, 2, 1, TCFG.max_seq, 4)
        return
    _, cache = ttr.build_prefill(TCFG, kv_codec=codec)(tp, toks)
    if part == "decode_step_int8":
        out, _ = ttr.build_decode_step(TCFG, kv_codec="int8")(
            tp, torch.tensor([3], dtype=torch.int32), cache, 6)
        assert tuple(out.shape) == (1, TCFG.vocab)
    else:
        out, _ = ttr.build_chunk_decode(TCFG)(
            tp, torch.tensor([[3, 4]], dtype=torch.int32), cache, 6)
        assert tuple(out.shape) == (1, 2, TCFG.vocab)
    assert bool(torch.isfinite(out).all())


def test_min_p_out_of_range_is_a_value_error():
    with pytest.raises(ValueError):
        ttr.make_sampler(97, temperature=0.0, min_p=2.0)


def test_transformer_lm_through_tensor_filter():
    """``appsrc ! tensor_filter framework=jax model=<transformer_lm> !
    tensor_sink`` on the CPU gives the JAX factory's logits."""
    kw = dict(vocab=32, d_model=16, n_heads=2, n_layers=1, d_ff=32, seq=8,
              seed=4)
    fn, jparams, _, _ = jtr.transformer_lm(dtype=jnp.float32,
                                           attention="reference", **kw)
    module, in_info, out_info = ttr.transformer_lm(dtype=torch.float32, **kw)
    register_torch_model("lm_filter", module, in_info, out_info)
    toks = _tokens(ttr.TransformerConfig(vocab=32), 1, 8, seed=12)
    try:
        pipe = tnt.parse_launch(
            "appsrc name=src ! tensor_filter framework=jax model=lm_filter "
            "accelerator=true:cpu ! tensor_sink name=out to-host=true")
        outs = []
        pipe.get("out").connect(lambda buf: outs.append(buf))
        pipe.start()
        pipe.get("src").push([toks])
        pipe.get("src").end_of_stream()
        pipe.run(timeout=120)
    finally:
        unregister_torch_model("lm_filter")
    assert len(outs) == 1
    got = np.asarray(outs[0].tensors[0])
    ref = np.asarray(fn(jparams, jnp.asarray(toks)))
    assert got.shape == (1, 8, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
