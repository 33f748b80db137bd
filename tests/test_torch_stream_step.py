"""The port's repo-loop stream steps (``nnstreamer_tpu_torch/models/
transformer.py::build_greedy_stream_step``, ``build_sample_stream_step``
and the filter model :class:`TransformerStreamStep`, ROADMAP A.13.6) on
the CPU, held against the JAX package's: the cases of
tests/test_models_parallel.py:597-700 (greedy tokens equal to the JAX
step's over 6 fp32 steps, ``steps=6`` equal to 6 single steps, the
sampled step deterministic and greedy at temperature 0 and at top_k=1,
the ``tensor_reposrc ! tensor_filter ! tee ! tensor_reposink`` loop equal
to the direct loop). The small configuration's matmul weights are scaled
×20 so that the greedy chain does not just repeat its input token. The
``gpu`` tests hold the captured step to the eager one on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.models import transformer as jtr
from nnstreamer_tpu_torch.elements.repo import GLOBAL_REPO
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.models import transformer as ttr
from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline
from nnstreamer_tpu_torch.serving import ContinuousBatchingEngine
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer, transfer_snapshot

TCFG = ttr.TransformerConfig(vocab=61, d_model=32, n_heads=4, n_layers=2,
                             d_ff=64, max_seq=32, dtype=torch.float32)
SCALE = 20.0
SCALED = ("qkv", "proj", "w_in", "w_out")
PROMPT = [7, 42, 3, 19]
STEPS = 6


def _scaled(params):
    return {k: v * SCALE if k in SCALED else v for k, v in params.items()}


# the port's own seeded weights, written out (the card's test runner
# stubs the JAX package: tools/gpu_tests.py)
PARAMS = _scaled(ttr.init_params(TCFG, seed=5))


@pytest.fixture(scope="module")
def jax_side():
    jcfg = jtr.TransformerConfig(vocab=61, d_model=32, n_heads=4,
                                 n_layers=2, d_ff=64, max_seq=32,
                                 dtype=jnp.float32)
    jp = _scaled(jtr.init_params(jcfg, seed=5))
    return jcfg, jp


def _prefilled(device="cpu"):
    """The prompt's cache as one tensor [L, 2, 1, S, h, dh], its greedy
    first token [1] and the position after it."""
    logits, cache = ttr.build_prefill(TCFG)(
        ttr.prepare_params(PARAMS, TCFG, device),
        torch.tensor([PROMPT], dtype=torch.int32, device=device))
    tok = torch.argmax(logits, -1).to(torch.int32)
    return tok, cache.values, torch.tensor(len(PROMPT), dtype=torch.int32,
                                           device=device)


def _chain(step, state, n, params=None):
    """n calls of a stream step (a ``build_*_stream_step`` function with
    ``params``, or a module), each fed the last one's state; the tokens
    it emitted (a steps > 1 step's block, else each call's next token)
    and the last call's outputs."""
    toks = []
    width = len(state)
    with torch.inference_mode():
        for _ in range(n):
            out = step(*state) if params is None else step(params, *state)
            block = len(out) > width  # the [steps] token block
            toks.extend((out[3] if block else out[0]).tolist())
            state = out[:width]
    return toks, out


def test_greedy_stream_step_matches_jax(jax_side):
    jcfg, jp = jax_side
    logits, cache = jtr.build_prefill(jcfg)(jp, jnp.asarray([PROMPT],
                                                           jnp.int32))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    pos = jnp.asarray(len(PROMPT), jnp.int32)
    one = jax.jit(jtr.build_greedy_stream_step(jcfg))
    want = []
    for _ in range(STEPS):
        tok, cache, pos = one(jp, tok, cache, pos)
        want.append(int(tok[0]))
    got, out = _chain(ttr.build_greedy_stream_step(TCFG), _prefilled(),
                      STEPS, ttr.prepare_params(PARAMS, TCFG))
    assert got == want and len(set(want)) > 1
    ntok, ncache, npos = out
    assert ntok.dtype == torch.int32 and tuple(ntok.shape) == (1,)
    assert npos.dtype == torch.int32 and npos.dim() == 0
    assert int(npos) == len(PROMPT) + STEPS
    np.testing.assert_allclose(ncache.numpy(), np.asarray(cache),
                               rtol=1e-4, atol=1e-4)


def test_multi_step_matches_single_steps_and_jax(jax_side):
    """steps=6 runs six decode steps in one call: its token block equals
    six single steps (the port's and the JAX package's steps=6 block);
    the state comes out six positions on."""
    jcfg, jp = jax_side
    multi = jax.jit(jtr.build_greedy_stream_step(jcfg, steps=STEPS))
    _, _, jpos, jtoks = multi(jp, jnp.asarray([3], jnp.int32),
                              jtr.init_cache(jcfg, batch=1),
                              jnp.asarray(0, jnp.int32))
    params = ttr.prepare_params(PARAMS, TCFG)
    state = (torch.tensor([3], dtype=torch.int32),
             ttr.init_cache(TCFG, 1).values,
             torch.tensor(0, dtype=torch.int32))
    singles, _ = _chain(ttr.build_greedy_stream_step(TCFG),
                        tuple(x.clone() for x in state), STEPS, params)
    tok, _, pos, toks = ttr.build_greedy_stream_step(TCFG, steps=STEPS)(
        params, *state)
    assert toks.tolist() == singles == np.asarray(jtoks).tolist()
    assert int(tok[0]) == singles[-1]
    assert int(pos) == int(jpos) == STEPS


def _sampled_run(step_fn, key, n=STEPS):
    params = ttr.prepare_params(PARAMS, TCFG)
    state = (torch.tensor([3], dtype=torch.int32),
             ttr.init_cache(TCFG, 1).values,
             torch.tensor(0, dtype=torch.int32), key)
    toks, _ = _chain(step_fn, state, n, params)
    return toks


def test_sampled_stream_step_deterministic_and_greedy_limits():
    """tests/test_models_parallel.py::test_sampled_stream_step: the same
    key draws the same stream; temperature 0 and top_k=1 give the greedy
    step's tokens."""
    key = ttr.sampling_keys(0, [0], 1)[0]
    sampled = ttr.build_sample_stream_step(TCFG, temperature=1.0)
    a = _sampled_run(sampled, key)
    assert a == _sampled_run(sampled, key)
    assert a != _sampled_run(sampled, ttr.sampling_keys(1, [0], 1)[0])
    params = ttr.prepare_params(PARAMS, TCFG)
    greedy, _ = _chain(ttr.build_greedy_stream_step(TCFG), (
        torch.tensor([3], dtype=torch.int32), ttr.init_cache(TCFG, 1).values,
        torch.tensor(0, dtype=torch.int32)), STEPS, params)
    assert _sampled_run(ttr.build_sample_stream_step(TCFG, temperature=0.0),
                        key) == greedy
    assert _sampled_run(ttr.build_sample_stream_step(
        TCFG, temperature=0.5, top_k=1), key) == greedy


def test_sampled_stream_step_draws_what_the_engine_draws():
    """Seeded with counter pos + 1, the key's counter stays the position
    of the token being drawn: the stream step continues a prompt with the
    engine's sampled tokens for the same (seed, stream id)."""
    kw = dict(temperature=0.9, top_k=12, min_p=0.02)
    eng = ContinuousBatchingEngine(TCFG, PARAMS, max_streams=2,
                                   steps_per_dispatch=4, seed=7,
                                   device="cpu", **kw).start()
    try:
        want = eng.generate(PROMPT, max_new_tokens=STEPS + 1, timeout=120)
    finally:
        eng.stop()
    params = ttr.prepare_params(PARAMS, TCFG)
    logits, cache = ttr.build_prefill(TCFG)(
        params, torch.tensor([PROMPT], dtype=torch.int32))
    n = len(PROMPT)
    first, keys = ttr.make_sampler(TCFG.vocab, **kw)(
        logits, ttr.sampling_keys(7, [0], n))
    got, _ = _chain(ttr.build_sample_stream_step(TCFG, **kw), (
        first, cache.values, torch.tensor(n, dtype=torch.int32), keys[0]),
        STEPS, params)
    assert [int(first[0])] + got == want


def test_model_leaves_its_inputs_and_matches_the_function():
    """The filter model returns new tensors (its input cache unchanged)
    equal to ``build_greedy_stream_step``'s outputs; the int8 cache
    passes as a KVCache."""
    model = ttr.greedy_stream_model(TCFG, PARAMS, steps=3)
    tok, cache, pos = _prefilled()
    before = cache.clone()
    with torch.inference_mode():
        out = model(tok, cache, pos)
    assert torch.equal(cache, before)
    ref = ttr.build_greedy_stream_step(TCFG, steps=3)(
        ttr.prepare_params(PARAMS, TCFG), tok, cache.clone(), pos)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert out[1].data_ptr() != cache.data_ptr()

    q = ttr.init_cache(TCFG, 1, kv_codec="int8")
    step8 = ttr.build_greedy_stream_step(TCFG, kv_codec="int8", steps=3)
    _, c8, _, toks8 = step8(ttr.prepare_params(PARAMS, TCFG), tok, q,
                            torch.tensor(0))
    assert isinstance(c8, ttr.KVCache) and c8.scale is not None
    chain = ttr.build_decode_step(TCFG, kv_codec="int8")
    q2 = ttr.init_cache(TCFG, 1, kv_codec="int8")
    t, want = tok, []
    for p in range(3):
        logits, q2 = chain(ttr.prepare_params(PARAMS, TCFG), t, q2, p)
        t = torch.argmax(logits, -1).to(torch.int32)
        want.append(int(t[0]))
    assert toks8.tolist() == want


def _loop_desc(model, slot, num, combination=""):
    """bench.py's ``decode`` string (bench.py:1030-1036)."""
    return (f"tensor_reposrc slot={slot} num-buffers={num} timeout=30 ! "
            f"tensor_filter framework=jax model={model} name=filter "
            f"{combination}! tee name=t  t. ! tensor_reposink slot={slot}  "
            "t. ! tensor_sink name=out to-host=false")


def _repo_loop(model, state, num, combination="", slot="lm_loop",
               name="lm_loop"):
    """Run the loop ``num`` times from ``state``; the sink's buffers and
    the final slot."""
    register_torch_model("lm_loop_model", model)
    GLOBAL_REPO.set(slot, TensorBuffer(list(state), pts=0))
    try:
        pipe = tnt.parse_launch(
            _loop_desc("lm_loop_model", slot, num, combination),
            pipeline=Pipeline(name=name))
        got = []
        pipe.get("out").connect(got.append)
        msg = pipe.run(timeout=120)
        assert msg is not None and msg.kind == "eos", msg
        return pipe, got, GLOBAL_REPO.get(slot)
    finally:
        unregister_torch_model("lm_loop_model")
        GLOBAL_REPO.remove(slot)


@pytest.fixture
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


@pytest.mark.parametrize("kind", ["greedy", "greedy_steps", "sampled"])
def test_repo_loop_equals_the_direct_loop(cpu_device, kind):
    """tensor_reposrc ! tensor_filter ! tee ! tensor_reposink with the
    state tuple in the slot: the sink's tokens equal the direct loop's,
    and the final slot holds the direct loop's cache and position."""
    n = 4
    tok, cache, pos = _prefilled()
    state = [tok.numpy(), cache, pos.numpy()]
    combination = ""
    if kind == "sampled":
        model = ttr.sample_stream_model(TCFG, PARAMS, temperature=0.9,
                                        top_k=12)
        state.append(ttr.sampling_keys(3, [0], len(PROMPT) + 1)[0].numpy())
    elif kind == "greedy":
        model = ttr.greedy_stream_model(TCFG, PARAMS)
    else:
        model = ttr.greedy_stream_model(TCFG, PARAMS, steps=STEPS)
        combination = "input-combination=i0,i1,i2 "
    direct = [torch.as_tensor(x).clone() for x in state]
    want, last = _chain(model, tuple(direct), n)
    pipe, got, final = _repo_loop(model, state, n, combination)
    if kind == "greedy_steps":
        toks = [t for b in got for t in np.asarray(b.tensors[3]).tolist()]
    else:
        toks = [int(np.asarray(b.tensors[0]).reshape(-1)[0]) for b in got]
    assert toks == want and len(got) == n
    assert torch.equal(torch.as_tensor(final.tensors[1]), last[1])
    assert int(np.asarray(final.tensors[2])) == int(last[2])


# -- on the card ---------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the step is captured on the card")
    tnt.set_device(None)
    yield torch.device("cuda:0")


def _eager_step(step, device):
    """A ``build_*_stream_step`` function run eagerly on ``device`` with
    the prepared params, on copies of its inputs (as the module runs)."""
    params = ttr.prepare_params(PARAMS, TCFG, device)
    return lambda *xs: tuple(step(params, *[x.clone() for x in xs]))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["greedy_steps", "sampled"])
def test_captured_step_equals_eager_on_the_card(card, kind):
    """One capture over repeated calls; every call's outputs equal the
    step function's, run eagerly on the card, bit for bit; an output is
    not rewritten by a later call."""
    if kind == "sampled":
        kw = dict(temperature=0.9, top_k=12)
        cap = ttr.sample_stream_model(TCFG, PARAMS, **kw).to(card)
        eager = _eager_step(ttr.build_sample_stream_step(TCFG, **kw), card)
    else:
        cap = ttr.greedy_stream_model(TCFG, PARAMS, steps=STEPS).to(card)
        eager = _eager_step(
            ttr.build_greedy_stream_step(TCFG, steps=STEPS), card)
    torch.backends.cuda.matmul.allow_tf32 = False
    state = list(_prefilled(card))
    if kind == "sampled":
        state.append(ttr.sampling_keys(3, [0], len(PROMPT) + 1, card)[0])
    width = len(state)
    a, b = tuple(state), tuple(x.clone() for x in state)
    with torch.inference_mode():
        for i in range(5):
            out_a, out_b = cap(*a), eager(*b)
            for x, y in zip(out_a, out_b):
                assert torch.equal(x, y), i
            if i == 0:
                held, first = out_a, [x.clone() for x in out_a]
            a, b = out_a[:width], out_b[:width]
    for x, y in zip(held, first):
        assert torch.equal(x, y)  # not rewritten by the later replays
    assert cap.graph_stats == {"captures": 1, "replays": 5}


@pytest.mark.gpu
def test_decode_loop_keeps_the_cache_on_the_card(card):
    """bench.py's decode string on the card: the cache never crosses to
    the host in the loop, one capture, tokens equal the step function's
    run eagerly on the card."""
    model = ttr.greedy_stream_model(TCFG, PARAMS, steps=STEPS)
    eager = _eager_step(ttr.build_greedy_stream_step(TCFG, steps=STEPS),
                        card)
    state = list(_prefilled(card))
    want, _ = _chain(eager, tuple(x.clone() for x in state), 4)
    x0 = transfer_snapshot()
    _, got, final = _repo_loop(model, state, 4,
                               "input-combination=i0,i1,i2 ",
                               slot="lm_card", name="lm_card")
    x1 = transfer_snapshot()
    assert x1["d2h_events"] == x0["d2h_events"]
    assert final.tensors[1].device.type == "cuda"
    toks = [t for b in got for t in b.tensors[3].cpu().tolist()]
    assert toks == want
    assert model.graph_stats["captures"] == 1
