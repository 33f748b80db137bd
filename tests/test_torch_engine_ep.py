"""The LM engine's expert-parallel axis (``ContinuousBatchingEngine(mesh=)``
with ``ep``, ``parallel/sharded.ShardedLM``) against the JAX package's
meshed engine on its 8-device CPU mesh, in tests/test_torch_mesh_engine.py's
style: a MoE model with tests/test_serving.py's widths and four experts,
float32, seeded weights carried across with ``params_from_jax``. Greedy
tokens at dp2×ep2 (and dp2×tp2×ep2, the monolithic and the paged int8
cache) equal the port's unmeshed engine's and the JAX meshed engine's.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.models.transformer import TransformerConfig as JCfg
from nnstreamer_tpu.models.transformer import init_params as jinit
from nnstreamer_tpu.parallel.mesh import make_mesh as jmake_mesh
from nnstreamer_tpu.serving import ContinuousBatchingEngine as JaxEngine
from nnstreamer_tpu_torch.models import transformer as ttr
from nnstreamer_tpu_torch.parallel import make_mesh
from nnstreamer_tpu_torch.serving import ContinuousBatchingEngine

MOE = dict(vocab=97, d_model=64, n_heads=4, n_layers=2, d_ff=128,
           max_seq=64, num_experts=4)
JCFG = JCfg(**MOE, dtype=jnp.float32)
CFG = ttr.TransformerConfig(**MOE, dtype=torch.float32)
JPARAMS = jinit(JCFG, seed=3)
PARAMS = ttr.params_from_jax({k: np.asarray(v) for k, v in JPARAMS.items()})
PROMPTS = ((4, 8, 15), (16, 23, 9), (7, 7), (1, 2, 3, 4, 5))
NEW = 7


@pytest.fixture(autouse=True)
def host_mesh():
    tnt.set_device("cpu")
    tnt.set_host_device_count(8)
    yield
    tnt.set_host_device_count(1)
    tnt.set_device(None)


def _serve(eng, prompts, new_tokens):
    streams = [eng.submit(list(p), max_new_tokens=new_tokens)
               for p in prompts]
    return [s.result(timeout=240) for s in streams]


@functools.lru_cache(maxsize=None)
def jax_meshed(axes):
    eng = JaxEngine(JCFG, JPARAMS, temperature=0.0, max_streams=4,
                    steps_per_dispatch=4, mesh=jmake_mesh(list(axes))).start()
    try:
        return _serve(eng, PROMPTS, NEW)
    finally:
        eng.stop()


def _port(mesh, **kw):
    eng = ContinuousBatchingEngine(CFG, PARAMS, temperature=0.0,
                                   max_streams=4, steps_per_dispatch=4,
                                   mesh=mesh, **kw).start()
    try:
        return _serve(eng, PROMPTS, NEW), eng
    finally:
        eng.stop()


@pytest.mark.parametrize("axes", [(("dp", 2), ("ep", 2)),
                                  (("dp", 2), ("tp", 2), ("ep", 2))])
def test_ep_engine_matches_unmeshed_and_jax(axes):
    got, eng = _port(make_mesh(list(axes)))
    assert tuple(eng.params["w_in"].sharding.spec)[:2] == (None, "ep")
    assert tuple(eng.params["router"].sharding.spec) == (None, None, "ep")
    # each ep rank holds half the experts
    assert eng.params["w_in"].shards[0].shape[1] == 2
    plain, _ = _port(None)
    assert got == plain
    assert got == jax_meshed(axes)


def test_ep_paged_int8_engine_matches_unmeshed():
    """The paged arena (replicated over ep: each ep rank writes its own
    copy) with the int8 codec at dp2×ep2."""
    kw = dict(kv_quant="int8", block_tokens=8)
    got, _ = _port(make_mesh([("dp", 2), ("ep", 2)]), **kw)
    plain, _ = _port(None, **kw)
    assert got == plain


def test_ep_chunked_prefill_matches_unmeshed():
    """Chunked prefill on the batch-1 cache: the second ep rank works on
    a private copy of its heads, the first writes the cache."""
    kw = dict(prefill_chunk=2)
    got, _ = _port(make_mesh([("ep", 2), ("tp", 2)]), **kw)
    plain, _ = _port(None, **kw)
    assert got == plain


def test_ep_must_divide_the_experts():
    with pytest.raises(ValueError, match="num_experts"):
        ContinuousBatchingEngine(CFG, PARAMS, max_streams=4,
                                 mesh=make_mesh([("ep", 8)]))


@pytest.mark.parametrize("axis", ["sp", "pp"])
def test_the_engine_does_not_serve_sp_or_pp(axis):
    with pytest.raises(ValueError, match=f"does not serve a {axis}"):
        ContinuousBatchingEngine(CFG, PARAMS, max_streams=4,
                                 mesh=make_mesh([(axis, 2)]))
