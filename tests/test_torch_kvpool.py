"""The port's paged KV-cache allocator (nnstreamer_tpu_torch/serving/
kvpool.py) and the paged builders of models/transformer.py, on the CPU,
held against the JAX package's (tests/test_kvpool.py's configuration and
seeded weights, float32).

- The pool's cases of tests/test_kvpool.py: the kill switch, all-or-
  nothing LIFO allocation, refcounts, the prefill scatter and the ZERO
  block, copy-on-write, reset, bad sizes. The JAX pool's registration with
  the HBM accountant waits for ``tensors/memory.py`` (ROADMAP A.19): its
  case here checks the ``nbytes`` that will be registered.
- A write to the sentinel lands in the private trash block: the ZERO
  block stays zero and no other block changes.
- The arena after a scatter, a paged decode step and a paged chunk equals
  the JAX pool's arena (its blocks; the trash block has no JAX
  counterpart), and the logits agree within rtol = atol = 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from nnstreamer_tpu.models import transformer as jtr
from nnstreamer_tpu.serving import kvpool as jkvpool
from nnstreamer_tpu_torch.models import transformer as ttr
from nnstreamer_tpu_torch.serving import kvpool
from tests.test_kvpool import CFG as JCFG
from tests.test_kvpool import PARAMS as JPARAMS
from tests.test_kvpool import T

CFG = ttr.TransformerConfig(vocab=JCFG.vocab, d_model=JCFG.d_model,
                            n_heads=JCFG.n_heads, n_layers=JCFG.n_layers,
                            d_ff=JCFG.d_ff, max_seq=JCFG.max_seq,
                            dtype=torch.float32)
PARAMS = ttr.prepare_params(
    ttr.params_from_jax({k: np.asarray(v) for k, v in JPARAMS.items()}),
    CFG, "cpu")
TOL = 1e-5


def pool(num_blocks, kv_codec=None):
    return kvpool.BlockPool(CFG, num_blocks, T, kv_codec=kv_codec,
                            device="cpu")


def prefill(tokens, kv_codec=None):
    with torch.inference_mode():
        return ttr.build_prefill(CFG, kv_codec=kv_codec)(
            PARAMS, torch.as_tensor(tokens, dtype=torch.int32))


def test_env_kill_switch(monkeypatch):
    for off in ("0", "false", "no", "off", " OFF "):
        monkeypatch.setenv("NNSTPU_PAGED_KV", off)
        assert not kvpool.paged_enabled(), off
    for on in ("1", "true", "yes", ""):
        monkeypatch.setenv("NNSTPU_PAGED_KV", on)
        assert kvpool.paged_enabled() or on == "", on
    monkeypatch.delenv("NNSTPU_PAGED_KV")
    assert kvpool.paged_enabled()  # default ON (the engine gates on knob)


def test_alloc_is_all_or_nothing_and_lifo():
    p = pool(4)
    ids = p.alloc(3)
    assert len(ids) == 3 and p.free_blocks == 1
    assert p.alloc(2) is None          # 1 free: all-or-nothing
    assert p.free_blocks == 1          # the failed alloc took nothing
    p.release(ids)
    assert p.free_blocks == 4 and p.live_blocks() == 0
    # LIFO recycling: the most recently released block comes back first
    assert p.alloc(1)[0] == ids[-1]


def test_refcounts_guard_shared_blocks():
    p = pool(4)
    ids = p.alloc(2)
    p.retain(ids)                      # a second owner (COW prefix)
    p.release(ids)
    assert p.live_blocks() == 2        # still held by the retainer
    p.release(ids)
    assert p.live_blocks() == 0
    with pytest.raises(RuntimeError):
        p.release(ids)                 # over-release
    with pytest.raises(RuntimeError):
        p.retain(ids)                  # retain of a dead block


def test_scatter_prefill_and_zero_block_stay_exact():
    p = pool(6)
    toks = np.random.default_rng(0).integers(1, CFG.vocab, (1, 16))
    _, cache1 = prefill(toks)
    want = cache1.values.numpy()                         # [L, 2, 1, S, ..]
    ids = p.alloc(2)
    p.scatter_prefill(cache1, ids)
    got = p.arena.values.numpy()                         # [L, NTOT+1, ..]
    # block i holds prompt slots [i*T, (i+1)*T)
    for i, b in enumerate(ids):
        np.testing.assert_array_equal(got[:, b],
                                      want[:, :, 0, i * T:(i + 1) * T])
    # the permanent zero block and the trash block are untouched
    assert not np.any(got[:, p.num_blocks]) and not np.any(got[:, p.ntot])


def test_copy_block_duplicates_one_block():
    p = pool(6, kv_codec="int8")
    toks = np.random.default_rng(1).integers(1, CFG.vocab, (1, 16))
    _, cache1 = prefill(toks, kv_codec="int8")
    src_dst = p.alloc(2)
    p.scatter_prefill(cache1, src_dst[:1])
    p.copy_block(src_dst[0], src_dst[1])
    for leaf in p.arena.leaves():
        assert torch.equal(leaf[:, src_dst[0]], leaf[:, src_dst[1]])
        assert leaf[:, src_dst[0]].abs().sum() > 0


def test_reset_returns_every_block():
    p = pool(4)
    p.alloc(3)
    arena = p.arena.values
    arena.fill_(1.0)
    p.reset()
    assert p.free_blocks == 4 and p.live_blocks() == 0
    # zeroed in place: a captured graph keeps reading the same storage
    assert p.arena.values is arena and not arena.any()
    snap = p.snapshot()
    assert snap["num_blocks"] == 4 and snap["free_blocks"] == 4
    assert snap["nbytes"] == p.nbytes > 0


@pytest.mark.parametrize("kv_codec", [None, "int8"])
def test_arena_registers_kvcache_bytes(kv_codec):
    """The JAX pool registers its arena with the HBM accountant; that
    waits for A.19, and ``nbytes`` is the figure: every leaf's bytes, the
    trash block included."""
    p = pool(4, kv_codec)
    per_block = sum(leaf[0, 0].numel() * leaf.element_size()
                    for leaf in p.arena.leaves()) * CFG.n_layers
    assert p.nbytes == (p.ntot + 1) * per_block == sum(
        t.numel() * t.element_size() for t in p.arena.leaves())
    jpool = jkvpool.BlockPool(JCFG, 4, T, kv_codec=kv_codec)
    assert p.nbytes == jpool.nbytes * (p.ntot + 1) // p.ntot


def test_bad_sizes_rejected():
    with pytest.raises(ValueError):
        pool(0)
    with pytest.raises(ValueError):
        kvpool.BlockPool(CFG, 4, 0, device="cpu")
    # a mesh-placed arena (A.24, ported): the blocks with the zero block
    # must divide over dp
    from nnstreamer_tpu_torch.parallel import make_mesh
    from nnstreamer_tpu_torch.parallel.mesh import MeshDevice

    cpu = [MeshDevice(i, torch.device("cpu")) for i in range(2)]
    with pytest.raises(ValueError, match="divide over dp"):
        kvpool.BlockPool(CFG, 4, T, mesh=make_mesh([("dp", 2)], cpu))
    assert kvpool.BlockPool(CFG, 5, T, mesh=make_mesh([("dp", 2)], cpu)
                            ).ntot == 6


@pytest.mark.parametrize("kv_codec", [None, "int8"])
def test_sentinel_write_lands_in_the_trash_block(kv_codec):
    """A decode step whose row has an all-sentinel block table, and a
    chunk whose padded positions are past its limit: their writes go to
    the trash block. The ZERO block stays zero and no other block
    changes."""
    p = pool(6, kv_codec)
    toks = np.random.default_rng(2).integers(1, CFG.vocab, (1, 12))
    _, cache1 = prefill(toks, kv_codec)
    ids = p.alloc(2)
    p.scatter_prefill(cache1, ids)
    before = [t.clone() for t in p.arena.leaves()]
    bt = torch.full((1, CFG.max_seq // T), p.SENTINEL, dtype=torch.int64)
    step = ttr.build_paged_decode_step(CFG, T, kv_codec=kv_codec)
    chunk = ttr.build_paged_chunk(CFG, T, kv_codec=kv_codec)
    with torch.inference_mode():
        step(PARAMS, torch.tensor([5], dtype=torch.int32), p.arena, bt,
             torch.tensor([3]))
        bt_real = bt.clone()
        bt_real[0, :2] = torch.tensor(ids)
        chunk(PARAMS, torch.tensor([[4, 9, 6, 1]], dtype=torch.int32),
              p.arena, bt_real, torch.tensor([12]), torch.tensor([0]))
    for b, a in zip(before, p.arena.leaves()):
        assert torch.equal(a[:, :p.ntot], b[:, :p.ntot])
        assert not a[:, p.num_blocks].any()
        assert a[:, p.SENTINEL].any()  # the writes went somewhere


@pytest.mark.parametrize("kv_codec", [None, "int8"])
def test_paged_decode_and_chunk_match_jax(kv_codec):
    jpool = jkvpool.BlockPool(JCFG, 10, T, kv_codec=kv_codec)
    p = pool(10, kv_codec)
    prompt = np.array([[5, 11, 23, 42, 7, 9, 1, 2, 3, 4, 5]], np.int32)
    n = prompt.shape[1]
    _, jc1 = jax.jit(jtr.build_prefill(JCFG, kv_codec=kv_codec))(
        JPARAMS, jnp.asarray(prompt))
    _, tc1 = prefill(prompt, kv_codec)
    ids = [3, 7]
    jpool.scatter_prefill(jc1, ids)
    p.scatter_prefill(tc1, ids)
    bt = np.full((2, CFG.max_seq // T), p.SENTINEL, np.int32)
    bt[0, :2] = ids
    tok = np.array([9, 0], np.int32)
    pos = np.array([n, 0], np.int32)
    jl, jarena = jax.jit(jtr.build_paged_decode_step(
        JCFG, T, kv_codec=kv_codec))(JPARAMS, jnp.asarray(tok), jpool.arena,
                                     jnp.asarray(bt), jnp.asarray(pos))
    toks = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    pos0 = np.array([n + 1, 0], np.int32)
    limit = np.array([3, 0], np.int32)
    jl2, jarena = jax.jit(jtr.build_paged_chunk(JCFG, T, kv_codec=kv_codec))(
        JPARAMS, jnp.asarray(toks), jarena, jnp.asarray(bt),
        jnp.asarray(pos0), jnp.asarray(limit))
    with torch.inference_mode():
        tl, _ = ttr.build_paged_decode_step(CFG, T, kv_codec=kv_codec)(
            PARAMS, torch.from_numpy(tok), p.arena, torch.from_numpy(bt),
            torch.from_numpy(pos))
        tl2, _ = ttr.build_paged_chunk(CFG, T, kv_codec=kv_codec)(
            PARAMS, torch.from_numpy(toks), p.arena, torch.from_numpy(bt),
            torch.from_numpy(pos0), torch.from_numpy(limit))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=TOL,
                               atol=TOL)
    for jleaf, tleaf in zip(jax.tree_util.tree_leaves(jarena),
                            p.arena.leaves()):
        got = tleaf[:, :p.ntot].numpy()
        want = np.asarray(jleaf)
        if got.dtype == np.int8:
            assert np.abs(got.astype(np.int32) - want).max() <= 1
        else:
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_paged_builders_need_block_tokens_dividing_max_seq():
    for bad in (0, 7):
        with pytest.raises(ValueError, match="block_tokens"):
            ttr.build_paged_decode_step(CFG, bad)
        with pytest.raises(ValueError, match="block_tokens"):
            ttr.build_paged_chunk(CFG, bad)
