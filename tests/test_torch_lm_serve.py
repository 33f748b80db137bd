"""``appsrc ! tensor_lm_serve ! tensor_sink`` in one process on the CPU
(nnstreamer_tpu_torch/elements/lm_serve.py), the pattern of
tests/test_lm_serve_drainer.py: responses hold the JAX package's greedy
tokens, in FIFO order per client, with one response per request."""

import queue as _queue
import threading
import time

import numpy as np
import pytest

import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu_torch.serving import register_engine, unregister_engine
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer
from tests.test_serving import reference_greedy
from tests.test_torch_serving import _engine


@pytest.fixture
def rig():
    engine = _engine(max_streams=2).start()
    register_engine("lm_t", engine)
    pipe = tnt.parse_launch(
        "appsrc name=src ! tensor_lm_serve engine=lm_t max-new-tokens=4 "
        "idle-timeout=0.05 name=serve ! tensor_sink name=out to-host=true")
    outs = []
    pipe.get("out").connect(lambda b: outs.append(b))
    pipe.start()
    yield engine, pipe, outs
    pipe.stop()
    engine.stop()
    unregister_engine("lm_t")


def _send(serve, tensors, cid=0, pts=0, **meta):
    serve._chain_entry(serve.sinkpads[0], TensorBuffer(
        [np.asarray(t) for t in tensors], pts=pts,
        meta={"query_client_id": cid, **meta}))


def _wait(outs, n, timeout=120):
    deadline = time.monotonic() + timeout
    while len(outs) < n and time.monotonic() < deadline:
        time.sleep(0.02)
    return outs


def test_responses_are_fifo_per_client(rig):
    _engine_, pipe, outs = rig
    serve = pipe.get("serve")
    prompts = [[4, 8, 15], [16, 23], [42, 7, 9, 1], [2, 2], [9, 9, 9]]
    for i, p in enumerate(prompts):
        _send(serve, [np.asarray(p, np.int32)], cid=7, pts=i)
    _wait(outs, len(prompts))
    assert [b.pts for b in outs] == list(range(len(prompts)))
    assert [np.asarray(b.tensors[0]).tolist() for b in outs] == \
        [reference_greedy(p, 4) for p in prompts]


def test_clients_are_served_independently(rig):
    _engine_, pipe, outs = rig
    serve = pipe.get("serve")
    _send(serve, [np.asarray([3, 1, 4], np.int32)], cid=1, pts=0)
    _send(serve, [np.asarray([1, 5], np.int32)], cid=2, pts=1)
    _wait(outs, 2)
    got = {b.meta["query_client_id"]: np.asarray(b.tensors[0]).tolist()
           for b in outs}
    assert got == {1: reference_greedy([3, 1, 4], 4),
                   2: reference_greedy([1, 5], 4)}


def test_second_tensor_is_the_budget_and_meta_is_set(rig):
    _engine_, pipe, outs = rig
    serve = pipe.get("serve")
    prompt = [5, 11, 23, 42, 7]
    _send(serve, [np.asarray(prompt, np.int32), np.asarray([2], np.int32)],
          tag="kept")
    _wait(outs, 1)
    buf = outs[0]
    toks, lps = (np.asarray(t) for t in buf.tensors)
    assert toks.dtype == np.int32 and toks.tolist() == \
        reference_greedy(prompt, 2)
    assert lps.dtype == np.float32 and lps.shape == (2,)
    assert np.all(lps <= 0.0)
    assert buf.meta["lm_finish_reason"] == "length"
    assert buf.meta["lm_prompt_len"] == len(prompt)
    assert buf.meta["tag"] == "kept"


def test_lm_max_new_meta_caps_generation(rig):
    _engine_, pipe, outs = rig
    _send(pipe.get("serve"), [np.asarray([8, 9], np.int32)], lm_max_new=3)
    _wait(outs, 1)
    assert np.asarray(outs[0].tensors[0]).tolist() == \
        reference_greedy([8, 9], 3)


def test_empty_prompt_answers_minus_one_in_order(rig):
    _engine_, pipe, outs = rig
    serve = pipe.get("serve")
    _send(serve, [np.asarray([2, 3], np.int32)], cid=3, pts=0)
    _send(serve, [np.zeros((0,), np.int32)], cid=3, pts=1)
    _send(serve, [np.asarray([4], np.int32)], cid=3, pts=2)
    _wait(outs, 3)
    assert [b.pts for b in outs] == [0, 1, 2]
    assert np.asarray(outs[1].tensors[0]).tolist() == [-1]
    assert outs[1].meta["lm_finish_reason"].startswith("error")
    assert np.asarray(outs[2].tensors[0]).tolist() == reference_greedy([4], 4)


def test_pushed_prompts_drain_before_eos():
    """The launch-string form end to end: push, end the stream, run."""
    engine = _engine(max_streams=2).start()
    register_engine("lm_eos", engine)
    try:
        pipe = tnt.parse_launch(
            "appsrc name=src ! tensor_lm_serve engine=lm_eos "
            "max-new-tokens=5 ! tensor_sink name=out to-host=true")
        outs = []
        pipe.get("out").connect(lambda b: outs.append(b))
        prompts = [[1, 2, 3], [7], [5, 5, 5, 5]]
        src = pipe.get("src")
        for p in prompts:
            src.push([np.asarray(p, np.int32)])
        src.end_of_stream()
        pipe.run(timeout=120)
    finally:
        engine.stop()
        unregister_engine("lm_eos")
    assert [np.asarray(b.tensors[0]).tolist() for b in outs] == \
        [reference_greedy(p, 5) for p in prompts]


def test_missing_engine_fails_at_start():
    pipe = tnt.parse_launch(
        "appsrc name=src ! tensor_lm_serve engine=nope ! tensor_sink")
    with pytest.raises(Exception, match="no engine registered"):
        pipe.start()
    pipe.stop()


@pytest.mark.parametrize("prop", ["speculate=2", "speculate-layers=2"])
def test_speculate_is_not_ported(prop):
    """Until A.13.4 the properties raised at parse time; now they parse,
    as the JAX element's do, and reach the engine at start()
    (tests/test_torch_speculative.py)."""
    pipe = tnt.parse_launch(f"appsrc ! tensor_lm_serve engine=x {prop} "
                            "name=serve ! tensor_sink")
    key, value = prop.split("=")
    assert pipe.get("serve").get_property(key) == int(value)


class RacyQueue(_queue.Queue):
    """First blocking get() plants ``late_item`` then raises Empty — the
    completion arrives exactly as the idle window closes."""

    def __init__(self, late_item):
        super().__init__()
        self._late = late_item
        self._raced = False

    def get(self, block=True, timeout=None):
        if block and not self._raced:
            self._raced = True
            super().put(self._late)
            raise _queue.Empty
        return super().get(block=block, timeout=timeout)


def test_completion_racing_retirement_is_not_dropped(rig):
    engine, pipe, outs = rig
    serve = pipe.get("serve")
    prompt = [5, 11, 23]
    stream = engine.submit(prompt, max_new_tokens=4)
    deadline = time.monotonic() + 120
    while not stream.finished and time.monotonic() < deadline:
        time.sleep(0.01)
    assert stream.finished
    buf = TensorBuffer([np.asarray(prompt, np.int32)], pts=0,
                       meta={"query_client_id": 9})
    fifo = RacyQueue((stream, buf, None, time.monotonic()))
    with serve._state_lock:
        serve._fifos[9] = fifo
        serve._inflight += 1
        t = threading.Thread(target=serve._drain, args=(9, fifo),
                             daemon=True)
        serve._drainers[9] = t
    t.start()
    _wait(outs, 1, timeout=30)
    assert outs, "late completion was dropped at drainer retirement"
    assert np.asarray(outs[0].tensors[0]).tolist() == \
        reference_greedy(prompt, 4)
    deadline = time.monotonic() + 10
    while 9 in serve._fifos and time.monotonic() < deadline:
        time.sleep(0.02)
    assert 9 not in serve._fifos and 9 not in serve._drainers
