"""``tensor_lm_serve`` behind the query pair in the PyTorch port, on the CPU:
``tensor_query_serversrc ! tensor_lm_serve ! tensor_query_serversink``
served to three ``appsrc ! tensor_query_client ! tensor_sink`` clients
over 127.0.0.1. Every response holds the JAX package's greedy tokens
(``tests/test_serving.py::reference_greedy``), in each client's own order.
"""

import numpy as np
import pytest

import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu_torch.serving import register_engine, unregister_engine
from tests.test_serving import reference_greedy
from tests.test_torch_serving import _engine

NEW = 4
PROMPTS = {  # client → its prompts, in push order
    0: [[4, 8, 15], [16, 23], [42, 7, 9, 1]],
    1: [[2, 2], [9, 9, 9]],
    2: [[5, 11, 23, 42, 7], [3, 1, 4], [1, 5]],
}


@pytest.fixture
def lm_server():
    tnt.set_device("cpu")
    engine = _engine(max_streams=3).start()
    register_engine("lm_q", engine)
    server = tnt.parse_launch(
        "tensor_query_serversrc name=ss port=0 id=61 ! "
        f"tensor_lm_serve engine=lm_q max-new-tokens={NEW} ! "
        "tensor_query_serversink id=61")
    server.start()
    yield server.get("ss").port
    server.stop()
    engine.stop()
    unregister_engine("lm_q")
    tnt.set_device(None)


@pytest.mark.parametrize("window", [1, 3])
def test_clients_get_greedy_tokens_in_their_own_order(lm_server, window):
    clients = {}
    outs = {}
    for cid in PROMPTS:
        pipe = tnt.parse_launch(
            "appsrc name=src ! tensor_query_client dest-host=127.0.0.1 "
            f"dest-port={lm_server} max-in-flight={window} timeout=60 ! "
            "tensor_sink name=out")
        outs[cid] = []
        pipe.get("out").connect(lambda buf, cid=cid: outs[cid].append(buf))
        clients[cid] = pipe
    try:
        for pipe in clients.values():
            pipe.start()
        for cid, pipe in clients.items():
            src = pipe.get("src")
            for i, p in enumerate(PROMPTS[cid]):
                src.push([np.asarray(p, np.int32)], pts=i)
            src.end_of_stream()
        for pipe in clients.values():
            msg = pipe.wait(timeout=120)
            assert msg is not None and msg.kind == "eos", msg
    finally:
        for pipe in clients.values():
            pipe.stop()
    for cid, prompts in PROMPTS.items():
        got = outs[cid]
        assert [b.pts for b in got] == list(range(len(prompts)))
        assert [np.asarray(b.tensors[0]).tolist() for b in got] == \
            [reference_greedy(p, NEW) for p in prompts]
        for b in got:  # the logprobs cross the wire as the second tensor
            lps = np.asarray(b.tensors[1])
            assert lps.dtype == np.float32 and lps.shape == (NEW,)
            assert np.isfinite(lps).all() and (lps <= 0).all()


def test_budget_tensor_crosses_the_wire(lm_server):
    """A second int32 tensor in the request caps that prompt's tokens."""
    pipe = tnt.parse_launch(
        "appsrc name=src ! tensor_query_client dest-host=127.0.0.1 "
        f"dest-port={lm_server} timeout=60 ! tensor_sink name=out")
    got = []
    pipe.get("out").connect(lambda buf: got.append(buf))
    pipe.start()
    try:
        pipe.get("src").push([np.asarray([5, 11, 23], np.int32),
                              np.asarray([2], np.int32)])
        pipe.get("src").end_of_stream()
        msg = pipe.wait(timeout=120)
        assert msg is not None and msg.kind == "eos", msg
    finally:
        pipe.stop()
    assert np.asarray(got[0].tensors[0]).tolist() == \
        reference_greedy([5, 11, 23], 2)
