"""The port's pipeline parallelism (parallel/pipeline.py,
``make_pp_train_step``, ``shard_params(pipelined=True)``) against the
JAX package's on its 8-device CPU mesh, at dp1×pp2×sp2×tp2×ep1: the cases
of tests/test_models_parallel.py::TestPipelineParallel.

- the pipelined forward against JAX's pipelined forward and the dense
  forward (atol 2e-5, the JAX test's);
- the MoE ``make_pp_train_step``: the loss (rtol 1e-5) and every
  parameter (rtol 1e-5, atol 1e-7) after each of two steps against
  JAX's from the same ``init_params``;
- the wrong-``num_mb`` ValueError, in JAX's words;
- ``shard_params(pipelined=True)``'s per-stage placement and its bytes
  under the HBM accountant.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.models.transformer import TransformerConfig as JCfg
from nnstreamer_tpu.models.transformer import build_forward as jforward
from nnstreamer_tpu.models.transformer import init_params as jinit
from nnstreamer_tpu.parallel.mesh import make_mesh as jmake_mesh
from nnstreamer_tpu.parallel.pipeline import (
    build_pipelined_forward as jpipelined,
)
from nnstreamer_tpu.parallel.pipeline import (
    pipeline_param_specs as jpp_specs,
)
from nnstreamer_tpu.parallel.sharded import make_pp_train_step as jpp_step
from nnstreamer_tpu.parallel.sharded import shard_params as jshard_params
from nnstreamer_tpu_torch.models import transformer as ttr
from nnstreamer_tpu_torch.parallel import make_mesh
from nnstreamer_tpu_torch.parallel.pipeline import (
    build_pipelined_forward,
    pipeline_param_specs,
    pipelined_block_forward,
)
from nnstreamer_tpu_torch.parallel.sharded import (
    make_pp_train_step,
    make_train_step,
    shard_params,
)
from nnstreamer_tpu_torch.tensors import memory

AXES = [("dp", 1), ("pp", 2), ("sp", 2), ("tp", 2), ("ep", 1)]
DENSE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
MOE = dict(DENSE, num_experts=2)
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-7


@pytest.fixture(autouse=True)
def host_mesh():
    tnt.set_device("cpu")
    tnt.set_host_device_count(8)
    yield
    tnt.set_host_device_count(1)
    tnt.set_device(None)


def cfgs(kw):
    return (ttr.TransformerConfig(**kw, dtype=torch.float32),
            JCfg(**kw, dtype=jnp.float32))


def np_init(jcfg):
    return {k: np.array(v) for k, v in jinit(jcfg).items()}


def test_specs_equal_jax():
    for kw in (DENSE, MOE):
        cfg, jcfg = cfgs(kw)
        assert {k: tuple(v) for k, v in pipeline_param_specs(cfg).items()} \
            == {k: tuple(v) for k, v in jpp_specs(jcfg).items()}


def test_pp_forward_matches_jax_pipelined_and_dense():
    cfg, jcfg = cfgs(DENSE)
    init = np_init(jcfg)
    num_mb, mb, seq = 2, 2, 8
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab, (num_mb, mb, seq)).astype(np.int32)
    dense = np.asarray(jforward(jcfg)(
        {k: jnp.asarray(v) for k, v in init.items()},
        jnp.asarray(tokens.reshape(num_mb * mb, seq))))
    jmesh = jmake_mesh(AXES)
    with jax.set_mesh(jmesh):
        theirs = np.asarray(jax.jit(jpipelined(jcfg, jmesh, num_mb))(
            jshard_params({k: jnp.asarray(v) for k, v in init.items()},
                          jmesh, jcfg, pipelined=True),
            jnp.asarray(tokens)))
    mesh = make_mesh(AXES)
    ours = build_pipelined_forward(cfg, mesh, num_mb)(
        shard_params(ttr.params_from_jax(init), mesh, cfg, pipelined=True),
        torch.from_numpy(tokens)).numpy()
    assert ours.shape == (num_mb, mb, seq, cfg.vocab)
    np.testing.assert_allclose(ours.reshape(num_mb * mb, seq, -1), dense,
                               atol=2e-5)
    np.testing.assert_allclose(ours, theirs, atol=2e-5)


@pytest.mark.parametrize("axes,num_mb", [
    ([("pp", 2)], 3), ([("pp", 2), ("dp", 2)], 2),
    ([("dp", 2), ("pp", 2), ("tp", 2)], 4)])
def test_pp_forward_other_meshes_match_dense(axes, num_mb):
    cfg, jcfg = cfgs(DENSE)
    params = ttr.params_from_jax(np_init(jcfg))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (num_mb, 4, 8)).astype(np.int32))
    mesh = make_mesh(axes)
    ours = build_pipelined_forward(cfg, mesh, num_mb)(
        shard_params(params, mesh, cfg, pipelined=True), tokens)
    dense = ttr.build_forward(cfg)(params, tokens.reshape(-1, 8))
    np.testing.assert_allclose(ours.reshape(dense.shape).numpy(),
                               dense.numpy(), atol=2e-5)


def test_pipelined_block_forward_matches_the_layer_stack():
    """``blocks`` alone: the stages' layers over embedded activations
    equal the dense forward's layer loop."""
    cfg, jcfg = cfgs(DENSE)
    params = ttr.params_from_jax(np_init(jcfg))
    mesh = make_mesh(AXES)
    placed = shard_params(params, mesh, cfg, pipelined=True)
    stage = {k: v for k, v in placed.items() if k not in ("embed", "ln_f")}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 2, 8, cfg.d_model)).astype(np.float32))
    positions = torch.arange(8, dtype=torch.int32)[None, None].expand(
        2, 2, 8)
    got = pipelined_block_forward(cfg, mesh)(stage, x, positions)
    body = ttr.make_layer_body(cfg)
    want = x.reshape(4, 8, -1)
    for l in range(cfg.n_layers):
        want, _ = body(want, positions.reshape(4, 8), ttr._layer(params, l))
    np.testing.assert_allclose(got.reshape(4, 8, -1).numpy(), want.numpy(),
                               atol=2e-5)


def test_pp_moe_train_step_matches_jax():
    """tests/test_models_parallel.py::test_pp_moe_train_step: two steps;
    the loss and every parameter after each equal JAX's, and the loss
    falls."""
    cfg, jcfg = cfgs(MOE)
    init = np_init(jcfg)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 2, 8)) \
        .astype(np.int32)
    jmesh = jmake_mesh(AXES)
    jparams = jshard_params({k: jnp.asarray(v) for k, v in init.items()},
                            jmesh, jcfg, pipelined=True)
    jstep = jpp_step(jcfg, jmesh, num_microbatches=2)
    mesh = make_mesh(AXES)
    params = shard_params(ttr.params_from_jax(init), mesh, cfg,
                          pipelined=True)
    step = make_pp_train_step(cfg, mesh, num_microbatches=2)
    losses = []
    for _ in range(2):
        with jax.set_mesh(jmesh):
            jparams, jloss = jstep(jparams, jnp.asarray(tokens))
        params, loss = step(params, torch.from_numpy(tokens))
        np.testing.assert_allclose(float(loss), float(jloss),
                                   rtol=LOSS_RTOL)
        for k in init:
            np.testing.assert_allclose(
                params[k].gather().numpy(), np.asarray(jparams[k]),
                rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=k)
        losses.append(float(loss))
    assert np.isfinite(losses[0]) and losses[1] < losses[0]


def test_pp_step_equals_the_dense_step():
    """The GPipe step (its microbatches' gradients summed) leaves the
    parameters the one-device step leaves on the same batch."""
    cfg, jcfg = cfgs(DENSE)
    init = ttr.params_from_jax(np_init(jcfg))
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 2, 8)).astype(np.int32))
    one = make_mesh([("dp", 1)])
    dense = shard_params({k: v.clone() for k, v in init.items()}, one, cfg)
    dense, dloss = make_train_step(cfg, one, learning_rate=1e-2)(
        dense, tokens.reshape(8, 8))
    mesh = make_mesh([("pp", 2), ("sp", 2), ("tp", 2)])
    piped = shard_params(init, mesh, cfg, pipelined=True)
    piped, ploss = make_pp_train_step(cfg, mesh, num_microbatches=4,
                                      learning_rate=1e-2)(piped, tokens)
    np.testing.assert_allclose(float(ploss), float(dloss), rtol=LOSS_RTOL)
    for k in init:
        np.testing.assert_allclose(piped[k].gather().numpy(),
                                   dense[k].gather().numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)


def test_wrong_num_microbatches_raises_as_jax():
    cfg, jcfg = cfgs(DENSE)
    tokens = np.zeros((3, 2, 8), np.int32)
    jmesh = jmake_mesh(AXES)
    with pytest.raises(ValueError) as theirs:
        with jax.set_mesh(jmesh):
            jax.jit(jpipelined(jcfg, jmesh, 2))(
                jshard_params(jinit(jcfg), jmesh, jcfg, pipelined=True),
                jnp.asarray(tokens))
    mesh = make_mesh(AXES)
    with pytest.raises(ValueError) as ours:
        build_pipelined_forward(cfg, mesh, 2)(
            shard_params(ttr.init_params(cfg), mesh, cfg, pipelined=True),
            torch.from_numpy(tokens))
    assert str(ours.value) == str(theirs.value) == \
        "tokens leading dim 3 != num_microbatches 2 the step was built for"


def test_pipelined_placement_is_per_stage_and_accounted():
    cfg, _ = cfgs(DENSE)
    params = ttr.init_params(cfg, seed=1)
    mesh = make_mesh(AXES)
    acct = memory.activate(1 << 30)
    try:
        placed = shard_params(params, mesh, cfg, pipelined=True)
        shards = placed["qkv"].addressable_shards
        # [L, D, 3, H, dh]: a stage's layer, half the heads
        assert [tuple(s.data.shape) for s in shards] == [(1, 32, 3, 2, 8)] * 8
        for coord, shard in zip(mesh.coords(), shards):
            t = coord["tp"]
            want = params["qkv"][coord["pp"]:coord["pp"] + 1, :, :,
                                 2 * t:2 * t + 2]
            assert torch.equal(shard.data, want)
        assert tuple(placed["ln1"].sharding.spec) == ("pp",)
        per_device = sum(s.data.numel() * 4 for v in placed.values()
                         for s in v.addressable_shards)
        assert acct._used.get("weights", 0) == per_device
    finally:
        memory.deactivate()


def test_blocks_need_every_stage_param():
    cfg, _ = cfgs(DENSE)
    mesh = make_mesh(AXES)
    placed = shard_params(ttr.init_params(cfg), mesh, cfg, pipelined=True)
    stage = {k: v for k, v in placed.items()
             if k not in ("embed", "ln_f", "w_out")}
    with pytest.raises(ValueError, match="w_out"):
        pipelined_block_forward(cfg, mesh)(
            stage, torch.zeros((2, 2, 8, cfg.d_model)),
            torch.zeros((2, 2, 8), dtype=torch.int32))
