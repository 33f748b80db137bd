"""The port's sharded forward and train step (parallel/sharded.py) against
the JAX package's on its 8-device CPU mesh: the cases of
tests/test_models_parallel.py::TestShardedTrainStep.

- the dp2×tp2×sp2 forward (ring attention over sp, each sp rank at its
  global rotary positions) against JAX's sharded and unsharded forward
  (rtol = atol = 5e-4, the JAX test's);
- one ``make_train_step`` at dp2×tp2×sp2 on TINY from the same
  ``init_params``, carried across with ``params_from_jax``: the loss
  (rtol 1e-5) and every parameter after the step (rtol 1e-5, atol 1e-7:
  the step moves them by 1e-4 to 1e-3, so this holds the update to well
  under a percent);
- six steps on one batch, where the loss falls;
- the dp2×ep4 MoE step of ``test_ep_moe_step`` (and the same step on
  random tokens, where the router spreads them over the experts).

The port's mesh is logical host devices (``set_host_device_count(8)``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.models.transformer import TransformerConfig as JCfg
from nnstreamer_tpu.models.transformer import build_forward as jforward
from nnstreamer_tpu.models.transformer import init_params as jinit
from nnstreamer_tpu.parallel.mesh import make_mesh as jmake_mesh
from nnstreamer_tpu.parallel.sharded import make_sharded_forward as jsharded
from nnstreamer_tpu.parallel.sharded import make_train_step as jtrain_step
from nnstreamer_tpu.parallel.sharded import shard_params as jshard_params
from nnstreamer_tpu_torch.models import transformer as ttr
from nnstreamer_tpu_torch.parallel import make_mesh
from nnstreamer_tpu_torch.parallel.mesh import ShardedTensor
from nnstreamer_tpu_torch.parallel.sharded import (
    lm_loss,
    make_sharded_forward,
    make_train_step,
    shard_params,
)

TINY = dict(vocab=128, d_model=32, n_heads=4, n_layers=2, d_ff=64)
MOE = dict(vocab=64, d_model=16, n_heads=2, n_layers=1, d_ff=32,
           num_experts=4)
DTS = [("dp", 2), ("tp", 2), ("sp", 2)]
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
    """The JAX package's seeded params as numpy (a copy: the JAX step
    donates what it is given)."""
    return {k: np.array(v) for k, v in jinit(jcfg).items()}


def gathered(params):
    return {k: (v.gather() if isinstance(v, ShardedTensor) else v).numpy()
            for k, v in params.items()}


def jax_steps(jcfg, axes, tokens, lr, steps):
    """The JAX step's (loss, params) after each of ``steps`` steps."""
    mesh = jmake_mesh(axes)
    params = jshard_params({k: jnp.asarray(v)
                            for k, v in np_init(jcfg).items()}, mesh, jcfg)
    step = jtrain_step(jcfg, mesh, learning_rate=lr)
    out = []
    for _ in range(steps):
        params, loss = step(params, jnp.asarray(tokens))
        out.append((float(loss), {k: np.asarray(v)
                                  for k, v in params.items()}))
    return out


def port_steps(cfg, jcfg, axes, tokens, lr, steps):
    mesh = make_mesh(axes)
    params = shard_params(ttr.params_from_jax(np_init(jcfg)), mesh, cfg)
    step = make_train_step(cfg, mesh, learning_rate=lr)
    out = []
    for _ in range(steps):
        params, loss = step(params, torch.from_numpy(tokens))
        out.append((float(loss), gathered(params)))
    return out


def assert_steps_match(ours, theirs, init):
    for (l1, p1), (l2, p2) in zip(ours, theirs):
        np.testing.assert_allclose(l1, l2, rtol=LOSS_RTOL)
        assert set(p1) == set(p2)
        for k in p2:
            np.testing.assert_allclose(p1[k], p2[k], rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=k)
    # the step moved every parameter
    for k in init:
        assert not np.array_equal(ours[-1][1][k], init[k]), k


def test_dp_tp_sp_forward_matches_jax_sharded_and_unsharded():
    cfg, jcfg = cfgs(TINY)
    tokens = np.random.default_rng(3).integers(0, 128, (2, 32)) \
        .astype(np.int32)
    init = np_init(jcfg)
    ref = np.asarray(jforward(jcfg)({k: jnp.asarray(v)
                                     for k, v in init.items()},
                                    jnp.asarray(tokens)))
    jmesh = jmake_mesh(DTS)
    theirs = np.asarray(jsharded(jcfg, jmesh)(
        jshard_params({k: jnp.asarray(v) for k, v in init.items()}, jmesh,
                      jcfg), jnp.asarray(tokens)))
    mesh = make_mesh(DTS)
    ours = make_sharded_forward(cfg, mesh)(
        shard_params(ttr.params_from_jax(init), mesh, cfg),
        torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(ours, theirs, rtol=5e-4, atol=5e-4)
    single = ttr.build_forward(cfg)(ttr.params_from_jax(init),
                                    torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(ours, single, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("axes", [[("sp", 4)], [("dp", 1), ("sp", 8)],
                                  [("dp", 2), ("ep", 2), ("sp", 2)]])
def test_sequence_parallel_forward_matches_one_device(axes):
    """Each sp rank's rotary positions are global: the ring over 4 and 8
    shards gives the one-device logits."""
    cfg, jcfg = cfgs(TINY)
    params = ttr.params_from_jax(np_init(jcfg))
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, 128, (2, 32)).astype(np.int32))
    mesh = make_mesh(axes)
    ours = make_sharded_forward(cfg, mesh)(shard_params(params, mesh, cfg),
                                           tokens)
    single = ttr.build_forward(cfg)(params, tokens)
    np.testing.assert_allclose(ours.numpy(), single.numpy(), rtol=5e-4,
                               atol=5e-4)


def test_sequence_must_divide_by_sp():
    cfg, _ = cfgs(TINY)
    mesh = make_mesh([("sp", 4)])
    with pytest.raises(ValueError, match="sp"):
        make_sharded_forward(cfg, mesh)(
            shard_params(ttr.init_params(cfg), mesh, cfg),
            torch.zeros((1, 10), dtype=torch.int32))


def test_dp_tp_sp_train_step_matches_jax():
    """One step: the loss and every parameter after it equal the JAX
    step's from the same init."""
    cfg, jcfg = cfgs(TINY)
    tokens = np.random.default_rng(0).integers(0, 128, (4, 32)) \
        .astype(np.int32)
    assert_steps_match(port_steps(cfg, jcfg, DTS, tokens, 1e-2, 1),
                       jax_steps(jcfg, DTS, tokens, 1e-2, 1),
                       np_init(jcfg))


def test_dp_tp_sp_step_runs_and_learns():
    """tests/test_models_parallel.py::test_dp_tp_sp_step_runs_and_learns:
    six steps memorising one batch; the first step's loss equals
    ``lm_loss`` of the one-device forward on the same params."""
    cfg, jcfg = cfgs(TINY)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 128, (4, 32)).astype(np.int32))
    init = ttr.params_from_jax(np_init(jcfg))
    ref = float(lm_loss(ttr.build_forward(cfg), init, tokens))
    mesh = make_mesh(DTS)
    params = shard_params({k: v.clone() for k, v in init.items()}, mesh, cfg)
    step = make_train_step(cfg, mesh, learning_rate=1e-2)
    params, loss0 = step(params, tokens)
    np.testing.assert_allclose(float(loss0), ref, rtol=LOSS_RTOL)
    for _ in range(5):
        params, loss = step(params, tokens)
    assert float(loss) < float(loss0)


def test_replicated_copies_stay_equal_after_a_step():
    """Every copy of a replicated slice holds the same updated value."""
    cfg, jcfg = cfgs(TINY)
    mesh = make_mesh(DTS)
    params = shard_params(ttr.params_from_jax(np_init(jcfg)), mesh, cfg)
    step = make_train_step(cfg, mesh, learning_rate=1e-2)
    params, _ = step(params, torch.from_numpy(np.random.default_rng(1)
                                              .integers(0, 128, (4, 32))
                                              .astype(np.int32)))
    for name in ("ln1", "ln_f", "qkv"):
        st = params[name]
        by_slice = {}
        for sl, t in zip(st.sharding.local_slices(st.shape), st.shards):
            key = tuple((s.start, s.stop) for s in sl)
            by_slice.setdefault(key, []).append(t)
        for copies in by_slice.values():
            for t in copies[1:]:
                assert torch.equal(t, copies[0]), name


@pytest.mark.parametrize("tokens", [
    np.zeros((2, 16), np.int32),   # test_ep_moe_step's batch
    np.random.default_rng(2).integers(0, 64, (2, 16)).astype(np.int32),
], ids=["zeros", "random"])
def test_dp_ep_moe_step_matches_jax(tokens):
    cfg, jcfg = cfgs(MOE)
    axes = [("dp", 2), ("tp", 1), ("ep", 4)]
    ours = port_steps(cfg, jcfg, axes, tokens, 1e-3, 1)
    assert np.isfinite(ours[0][0])
    assert_steps_match(ours, jax_steps(jcfg, axes, tokens, 1e-3, 1),
                       np_init(jcfg))


def test_ep_forward_matches_one_device():
    """Experts over ep (each rank its experts' share, the router's top-1
    taken from the gathered logits) give the one-device logits."""
    cfg, jcfg = cfgs(MOE)
    params = ttr.params_from_jax(np_init(jcfg))
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, 64, (4, 16)).astype(np.int32))
    for axes in ([("ep", 4)], [("dp", 2), ("ep", 2), ("tp", 2)]):
        mesh = make_mesh(axes)
        ours = make_sharded_forward(cfg, mesh)(
            shard_params(params, mesh, cfg), tokens)
        np.testing.assert_allclose(
            ours.numpy(), ttr.build_forward(cfg)(params, tokens).numpy(),
            rtol=1e-5, atol=1e-5)


def test_bf16_step_keeps_fp32_masters_as_jax():
    """A bfloat16 model trains fp32 master weights, as the JAX package's
    (``shard_params`` places them as given; each matmul casts): two steps'
    losses within rtol 1e-4 and parameters within 1e-4 of JAX's (bf16
    activations and gradients: 2^-8 relative on updates of about 1e-3)."""
    cfg = ttr.TransformerConfig(**TINY, dtype=torch.bfloat16)
    jcfg = JCfg(**TINY, dtype=jnp.bfloat16)
    tokens = np.random.default_rng(0).integers(0, 128, (4, 32)) \
        .astype(np.int32)
    ours = port_steps(cfg, jcfg, DTS, tokens, 1e-2, 2)
    theirs = jax_steps(jcfg, DTS, tokens, 1e-2, 2)
    for (l1, p1), (l2, p2) in zip(ours, theirs):
        np.testing.assert_allclose(l1, l2, rtol=1e-4)
        for k in p2:
            assert p1[k].dtype == np.float32, k
            np.testing.assert_allclose(p1[k], p2[k], rtol=0, atol=1e-4,
                                       err_msg=k)
