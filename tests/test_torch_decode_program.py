"""The serving engine's K-step program (``serving/engine.py::
_DecodeProgram``): its body is the engine's eager ``_dispatch`` loop over
static device buffers, the advanced token and positions written back into
its inputs.

On the CPU the program runs in static-buffer mode, with no capture: its
tokens, logprobs and cache equal those of the eager ``_dispatch`` chained
by hand, across admissions, a recovery and a change of K, bit for bit;
and the engine serves a plain greedy loop's tokens through it. The
``gpu`` tests hold the captured program on the card: one capture per
(B, K), one ``add_replay`` per replay, and a new capture (against the new
cache) after a recovery.
"""

import inspect

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch.models import transformer as ttr
from nnstreamer_tpu_torch.ops import _counts
from nnstreamer_tpu_torch.serving import ContinuousBatchingEngine

CFG = ttr.TransformerConfig(vocab=97, d_model=64, n_heads=4, n_layers=2,
                            d_ff=128, max_seq=64, dtype=torch.float32)
PARAMS = ttr.init_params(CFG, seed=3)


def _engine(device="cpu", **kw):
    kw.setdefault("max_streams", 3)
    kw.setdefault("steps_per_dispatch", 4)
    return ContinuousBatchingEngine(CFG, PARAMS, device=device, **kw)


def greedy(prompt, n, device="cpu"):
    """Exact-length prefill and one decode step at a time."""
    params = ttr.prepare_params(PARAMS, CFG, device)
    with torch.inference_mode():
        logits, cache = ttr.build_prefill(CFG)(
            params, torch.tensor([prompt], dtype=torch.int32, device=device))
        step = ttr.build_decode_step(CFG)
        out = [int(logits[0].argmax())]
        for i in range(n - 1):
            logits, cache = step(
                params, torch.tensor(out[-1:], dtype=torch.int32,
                                     device=device),
                cache, len(prompt) + i)
            out.append(int(logits[0].argmax()))
    return out


def _drive(eng, use_program: bool):
    """Admissions, dispatches, a recovery and a K change on an unstarted
    engine, through its program or through ``_dispatch`` chained by hand.
    Returns every block's tokens and logprobs and the final cache."""
    blocks = []

    def admit(slot, prompt):
        logits, cache1 = eng._prefill_fn(
            eng.params, torch.tensor([prompt], dtype=torch.int32))
        eng._cache.map(lambda t: t[:, :, slot]).copy_(
            cache1.map(lambda t: t[:, :, 0]))
        eng._last[slot] = int(logits[0].argmax())
        eng._pos[slot] = len(prompt)

    def run(n):
        if use_program:
            prog = eng._ensure_program(warm=False)
            assert prog.K == eng.K and prog.graph is None
            prog.load(eng._last, eng._pos)
            for _ in range(n):
                prog.run()
                blocks.append((prog.toks.clone(), prog.lps.clone()))
            token, pos = prog.token, prog.pos
        else:
            token = torch.from_numpy(eng._last.copy())
            pos = torch.from_numpy(eng._pos.copy())
            for _ in range(n):
                toks, lps, token, pos = eng._dispatch(token, pos)
                blocks.append((toks, lps))
        eng._last[:] = token.numpy()
        eng._pos[:] = pos.numpy()

    with torch.inference_mode():
        admit(0, [5, 11, 23])
        run(2)
        admit(1, [4, 8, 15, 16, 23, 42])  # an admission between dispatches
        run(3)
        eng._recover(RuntimeError("injected"))  # a fresh cache
        assert eng._program is None
        admit(2, [42, 7])
        run(2)
        eng.K = 2  # a K change: a new program
        run(3)
    return blocks, eng._cache


def test_program_equals_eager_dispatch():
    got, got_cache = _drive(_engine(), use_program=True)
    ref, ref_cache = _drive(_engine(), use_program=False)
    assert len(got) == len(ref) == 10
    assert [b[0].shape[1] for b in got] == [4] * 5 + [4] * 2 + [2] * 3
    for (gt, gl), (rt, rl) in zip(got, ref):
        assert torch.equal(gt, rt) and torch.equal(gl, rl)
    assert torch.equal(got_cache.values, ref_cache.values)


def test_body_writes_the_advanced_state_back():
    eng = _engine()
    with torch.inference_mode():
        prog = eng._ensure_program(warm=False)
        prog.load(np.asarray([3, 9, 1], np.int32),
                  np.asarray([4, 0, 17], np.int64))
        prog.run()
    assert torch.equal(prog.token, prog.toks[:, -1])
    assert prog.pos.tolist() == [8, 4, 21]
    assert eng._ensure_program(warm=False) is prog  # same K: kept


def test_fetched_block_is_a_copy():
    """Blocks are processed one behind: the host copy of a block must not
    be the program's buffer, which the next dispatch overwrites."""
    eng = _engine()
    with torch.inference_mode():
        prog = eng._ensure_program(warm=False)
        prog.load(np.asarray([3, 9, 1], np.int32),
                  np.asarray([4, 0, 17], np.int64))
        prog.run()
        (toks_h, lps_h), event = eng._fetch_async(prog.toks, prog.lps)
        first = toks_h.clone(), lps_h.clone()
        prog.toks.fill_(-1)  # what the next dispatch may do to it
        prog.lps.fill_(1.0)
    assert event is None
    assert torch.equal(toks_h, first[0]) and torch.equal(lps_h, first[1])


def test_engine_serves_through_the_program_across_recovery_and_k():
    eng = _engine(max_streams=2).start()
    try:
        assert eng._program is not None and eng._program.K == 4
        assert eng.generate([5, 11, 23], max_new_tokens=9, timeout=120) == \
            greedy([5, 11, 23], 9)
        real_run = eng._program.run
        state = {"raised": False}

        def flaky():
            if not state["raised"]:
                state["raised"] = True
                raise RuntimeError("injected device failure")
            real_run()

        eng._program.run = flaky
        s = eng.submit([4, 8, 15], max_new_tokens=8)
        s.result(timeout=120)
        assert s.finish_reason == "error: injected device failure"
        # recovered: a new program over a new cache
        assert eng.generate([16, 23], max_new_tokens=6, timeout=120) == \
            greedy([16, 23], 6)
    finally:
        eng.stop()
    eng.K = 2
    eng.start()
    try:
        assert eng._program.K == 2
        assert eng.generate([42, 7, 9], max_new_tokens=7, timeout=120) == \
            greedy([42, 7, 9], 7)
    finally:
        eng.stop()
    assert eng.graph_stats == {"captures": [], "capture_s": 0.0,
                               "replays": 0}  # nothing captured on the CPU


def test_auto_k_builds_at_most_two_programs(monkeypatch):
    """"auto" times the program at the initial K and builds it again only
    if K changed: at most two programs (on a card, two captures) in an
    engine's life, restarts included — as the JAX engine pins its
    retraces."""
    from nnstreamer_tpu_torch.serving import engine as engine_mod

    built = []
    real = engine_mod._DecodeProgram

    class Counted(real):
        def __init__(self, eng):
            super().__init__(eng)
            built.append(self.K)

    monkeypatch.setattr(engine_mod, "_DecodeProgram", Counted)
    eng = _engine(max_streams=2, steps_per_dispatch="auto").start()
    try:
        got = eng.generate([5, 11, 23], max_new_tokens=10, timeout=120)
        eng.stop()
        eng.start()  # a restart neither calibrates nor builds again
        again = eng.generate([5, 11, 23], max_new_tokens=10, timeout=120)
    finally:
        eng.stop()
    assert 1 <= len(built) <= 2 and built[0] == 8 and built[-1] == eng.K
    assert built.count(eng.K) == 1
    assert got == again == greedy([5, 11, 23], 10)


def test_eager_dispatch_is_not_an_option():
    """Like the JAX engine, the engine takes no switch for eager dispatch;
    the private attribute exists for the card's comparisons only."""
    params = inspect.signature(ContinuousBatchingEngine).parameters
    assert not any("eager" in name or "graph" in name for name in params)
    assert ContinuousBatchingEngine._eager_dispatch is False


# -- on the card ---------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the program captures a CUDA graph")
    torch.backends.cuda.matmul.allow_tf32 = False


def _serve(eng, prompts, n):
    streams = [eng.submit(p, max_new_tokens=n) for p in prompts]
    return [s.result(timeout=300) for s in streams]


PROMPTS = [[5, 11, 23], [4, 8, 15, 16], [42, 7], [9, 2, 4, 9, 2, 4, 1]]


@pytest.mark.gpu
def test_one_capture_and_a_replay_a_dispatch_on_the_card():
    _card()
    eager = _engine("cuda")
    eager._eager_dispatch = True
    eager.start()
    try:
        ref = _serve(eager, PROMPTS, 11)
    finally:
        eager.stop()
    assert eager.graph_stats["captures"] == []
    eng = _engine("cuda").start()
    try:
        got = _serve(eng, PROMPTS, 11)
        got += _serve(eng, PROMPTS[:2], 5)
    finally:
        eng.stop()
    assert got[:4] == ref
    assert eng.graph_stats["captures"] == [4]
    assert eng.graph_stats["replays"] == eng.stats["dispatches"] > 0


@pytest.mark.gpu
def test_each_replay_adds_the_capture_tally(monkeypatch):
    """A wrapper launch inside the body is tallied at the capture and
    added to LAUNCHES once a replay (the warm-up at start() runs it
    eagerly once)."""
    _card()
    eng = _engine("cuda", max_streams=2)
    decode = eng._decode

    def counted(*args):
        _counts.count_launch("quantize_int8")
        return decode(*args)

    eng._decode = counted
    adds = []
    real_add = _counts.add_replay
    monkeypatch.setattr(_counts, "add_replay",
                        lambda tally: (adds.append(dict(tally)),
                                       real_add(tally)))
    _counts.reset_launches()
    eng.start()
    try:
        _serve(eng, PROMPTS[:2], 9)
    finally:
        eng.stop()
    replays = eng.graph_stats["replays"]
    assert adds == [{"quantize_int8": 4}] * replays
    assert _counts.LAUNCHES["quantize_int8"] == 4 * (1 + replays)


@pytest.mark.gpu
def test_recapture_after_recover_on_the_card():
    _card()
    eng = _engine("cuda", max_streams=2).start()
    try:
        first = eng._program
        real_run = first.run
        state = {"raised": False}

        def flaky():
            if not state["raised"]:
                state["raised"] = True
                raise RuntimeError("injected device failure")
            real_run()

        first.run = flaky
        s = eng.submit([4, 8, 15], max_new_tokens=8)
        s.result(timeout=120)
        assert s.finish_reason == "error: injected device failure"
        got = eng.generate([16, 23], max_new_tokens=6, timeout=120)
    finally:
        eng.stop()
    assert first.graph is None  # released: it read the freed cache
    assert eng._program is not first and eng._program.graph is not None
    assert eng.graph_stats["captures"] == [4, 4]
    assert got == greedy([16, 23], 6, device="cuda")


@pytest.mark.gpu
def test_auto_k_captures_at_most_twice_on_the_card():
    _card()
    eng = _engine("cuda", max_streams=2, steps_per_dispatch="auto").start()
    try:
        got = _serve(eng, PROMPTS[:2], 12)
    finally:
        eng.stop()
    caps = eng.graph_stats["captures"]
    assert 1 <= len(caps) <= 2 and caps[-1] == eng.K
    assert caps.count(eng.K) == 1
    assert got == [greedy(p, 12, device="cuda") for p in PROMPTS[:2]]
