"""The port's ring attention (nnstreamer_tpu_torch/parallel/ring.py)
against the JAX package's: ``ring_attention`` under ``shard_map`` on its
8-device CPU mesh, and ``attention_reference``, on the same seeded numpy
inputs (the cases of tests/test_models_parallel.py::TestRingAttention,
at its tolerances: rtol 2e-4, atol 2e-5), and the gradients of q, k and
v at sp4 against ``jax.grad`` of the JAX ring.

The port's sp ranks are threads of ``parallel.sharded.run_ranks`` over
logical host devices (``set_host_device_count(8)``), each holding a
contiguous shard of the sequence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as JP

import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.parallel.mesh import make_mesh as jmake_mesh
from nnstreamer_tpu.parallel.ring import attention_reference as jref
from nnstreamer_tpu.parallel.ring import ring_attention as jring
from nnstreamer_tpu_torch.parallel import ring
from nnstreamer_tpu_torch.parallel.mesh import make_mesh
from nnstreamer_tpu_torch.parallel.sharded import rank_groups, run_ranks

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True)
def host_mesh():
    tnt.set_device("cpu")
    tnt.set_host_device_count(8)
    yield
    tnt.set_host_device_count(1)
    tnt.set_device(None)


def port_ring(q, k, v, n, causal=True):
    """The port's ring over ``n`` sp ranks: each rank its contiguous
    sequence shard; the outputs concatenated along the sequence."""
    mesh = make_mesh([("sp", n)])
    coords = mesh.coords()
    s = q.shape[1]

    def shard(x, j):
        return x[:, j * s // n:(j + 1) * s // n]

    outs = run_ranks([d.device for d in mesh.device_list()],
                     rank_groups(coords),
                     lambda j: ring.ring_attention(
                         shard(q, j), shard(k, j), shard(v, j), "sp",
                         causal=causal))
    return torch.cat(outs, dim=1)


def jax_ring(q, k, v, n, causal=True):
    return shard_map(
        lambda q, k, v: jring(q, k, v, axis_name="sp", causal=causal),
        mesh=jmake_mesh([("sp", n)]), in_specs=(JP(None, "sp"),) * 3,
        out_specs=JP(None, "sp"))(q, k, v)


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("n,causal,seed,shape", [
    (4, True, 0, (2, 32, 4, 16)),    # TestRingAttention.test_matches_reference
    (2, False, 1, (1, 16, 2, 8)),    # TestRingAttention.test_non_causal
    (8, True, 2, (1, 64, 2, 8)),
    (1, True, 3, (2, 16, 2, 8)),     # a ring of one block
])
def test_ring_matches_jax_ring_and_reference(n, causal, seed, shape):
    q, k, v = _qkv(seed, shape)
    ours = port_ring(*(torch.from_numpy(x) for x in (q, k, v)), n,
                     causal).numpy()
    theirs = np.asarray(jax.jit(lambda *a: jax_ring(*a, n, causal))(q, k, v))
    ref = np.asarray(jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal))
    np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    port_ref = ring.attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal).numpy()
    np.testing.assert_allclose(ours, port_ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_gradients_match_jax(causal):
    """q, k and v gradients at sp4 of ``sum(ring(q, k, v) * w)`` against
    ``jax.grad`` of the JAX ring, and finite: the fully masked blocks of
    the causal ring contribute no NaN."""
    q, k, v = _qkv(4, (2, 32, 4, 16))
    w = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jax_ring(q, k, v, 4, causal) * w)

    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    loss = (port_ring(tq, tk, tv, 4, causal) * torch.from_numpy(w)).sum()
    loss.backward()
    for ours, theirs in zip((tq.grad, tk.grad, tv.grad), jgrads):
        assert torch.isfinite(ours).all()
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=RTOL, atol=ATOL)


def test_outside_a_group_is_one_block():
    """Called with no sp group (an axis of one device), the ring is plain
    attention over the shard it was given."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, (1, 8, 2, 8)))
    np.testing.assert_allclose(
        ring.ring_attention(q, k, v).numpy(),
        ring.attention_reference(q, k, v).numpy(), rtol=RTOL, atol=ATOL)


def test_bf16_keeps_fp32_accumulators():
    """bf16 q/k/v come back bf16, within bf16 rounding of the fp32 ring."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(7, (1, 32, 2, 16)))
    full = port_ring(q, k, v, 4)
    half = port_ring(q.bfloat16(), k.bfloat16(), v.bfloat16(), 4)
    assert half.dtype == torch.bfloat16
    np.testing.assert_allclose(half.float().numpy(), full.numpy(),
                               rtol=2e-2, atol=2e-2)


def test_a_failing_rank_aborts_the_ring():
    """A rank that raises before its first rotation aborts the group: the
    others do not wait forever, and the error reaches the caller."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(8, (1, 16, 2, 8)))
    mesh = make_mesh([("sp", 4)])

    def rank(j):
        if j == 2:
            raise RuntimeError("rank 2 failed")
        return ring.ring_attention(q[:, :4], k[:, :4], v[:, :4])

    with pytest.raises(RuntimeError, match="rank 2 failed"):
        run_ranks([d.device for d in mesh.device_list()],
                  rank_groups(mesh.coords()), rank)
