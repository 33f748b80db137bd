"""The staging pool of the PyTorch port (``nnstreamer_tpu_torch/tensors/pool.py``),
held to the JAX package's ``tensors/pool.py``.

The cases of the JAX package's ``tests/test_overlap.py::TestBufferPool``
and ``TestSourcePooling`` run against the port; the same sequence of
acquires and releases gives both pools the same hits, misses and free
slabs. New here: a slab whose copy is still in flight (its event has not
completed) is never handed out again — with a stand-in event on the CPU,
and with a real CUDA event on page-locked slabs in the ``gpu``-marked
test. On the CPU a slab is a plain numpy array; on the card it is
page-locked, and :func:`pinned_view` gives the tensor view copies read it
through.
"""

import gc

import numpy as np
import pytest
import torch

import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.tensors import pool as jax_pool
from nnstreamer_tpu_torch.tensors import pool as pool_mod
from nnstreamer_tpu_torch.tensors.buffer import as_torch
from nnstreamer_tpu_torch.tensors.pool import (
    BufferPool,
    _size_class,
    contiguous_window_view,
    get_pool,
    pinned_view,
)


class _Event:
    """A CUDA event stand-in: complete once ``done`` is set."""

    def __init__(self, done=False):
        self.done = done

    def query(self):
        return self.done


class TestBufferPool:
    def test_size_classes(self):
        for n in (1, 256, 257, 4096, 4097, 150528, 1204224):
            assert _size_class(n) == jax_pool._size_class(n)
        assert [_size_class(n) for n in (1, 257, 4097)] == [256, 512, 8192]

    def test_alignment(self):
        p = BufferPool(align=64)
        for shape, dt in (((7,), np.uint8), ((3, 5), np.float32),
                          ((1, 224, 224, 3), np.uint8)):
            a = p.acquire(shape, dt)
            assert a.ctypes.data % 64 == 0
            assert a.shape == shape and a.dtype == np.dtype(dt)

    def test_reuse_after_release(self):
        p = BufferPool()
        a = p.acquire((8, 8), np.float32)
        addr = a.ctypes.data
        assert p.owns(a)
        assert p.release(a) is True
        assert not p.owns(a)
        del a
        b = p.acquire((16, 16), np.uint8)  # same 256B class, new shape
        assert p.hits == 1 and p.misses == 1
        assert b.ctypes.data == addr

    def test_double_release_rejected(self):
        p = BufferPool()
        a = p.acquire((4,), np.float32)
        assert p.release(a) is True
        assert p.release(a) is False
        assert p.snapshot()["free"] == 1

    def test_gc_fallback_recycles(self):
        p = BufferPool()
        a = p.acquire((4,), np.float32)
        del a
        gc.collect()
        snap = p.snapshot()
        assert snap["outstanding"] == 0 and snap["free"] == 1
        p.acquire((4,), np.float32)
        assert p.hits == 1

    @pytest.mark.parametrize("explicit", [False, True])
    def test_never_aliases_a_derived_view(self, explicit):
        """numpy collapses view chains (``a[None].base`` is the slab): a
        slab a derived view still reads never re-enters circulation,
        whether the tracked view dies or is released."""
        p = BufferPool()
        a = p.acquire((4,), np.float32)
        a[:] = 7.0
        derived = a[None]
        if explicit:
            assert p.release(a) is True
        else:
            del a
            gc.collect()
        assert p.snapshot()["free"] == 0
        b = p.acquire((4,), np.float32)
        b[:] = 0.0
        np.testing.assert_array_equal(derived[0],
                                      np.full(4, 7.0, np.float32))

    def test_stale_finalizer_cannot_double_free(self):
        p = BufferPool()
        a = p.acquire((4,), np.float32)
        p.release(a)
        del a
        gc.collect()
        assert p.snapshot()["free"] == 1

    def test_reuse_does_not_alias_outstanding(self):
        p = BufferPool()
        a = p.acquire((8,), np.float32)
        b = p.acquire((8,), np.float32)
        a[:], b[:] = 1.0, 2.0
        assert a.ctypes.data != b.ctypes.data
        np.testing.assert_array_equal(a, np.full(8, 1.0, np.float32))

    def test_disabled_by_env(self, monkeypatch):
        monkeypatch.setenv("NNSTPU_POOL", "0")
        p = BufferPool()
        a = p.acquire((4,), np.float32)
        assert not p.owns(a)
        assert p.hits == p.misses == 0

    def test_max_per_class_bounds_freelist(self):
        p = BufferPool(max_per_class=2)
        views = [p.acquire((4,), np.float32) for _ in range(4)]
        for v in views:
            p.release(v)
        assert p.snapshot()["free"] == 2

    def test_pin_refuses_explicit_release(self):
        p = BufferPool()
        a = p.acquire((4,), np.float32)
        assert p.pin(a) is True
        assert p.release(a) is False
        p.unpin(id(a))
        assert p.release(a) is True
        assert p.pin(np.zeros(4)) is False

    def test_same_sequence_same_counts_as_jax_pool(self):
        """The same acquires and releases, in order, through both pools."""
        ops = [("a", (4,), np.float32), ("a", (300,), np.uint8),
               ("r", 0), ("a", (16, 16), np.uint8), ("r", 1), ("r", 2),
               ("a", (1, 8, 8, 3), np.uint8), ("a", (60,), np.float32),
               ("r", 3), ("a", (64,), np.uint8), ("a", (512,), np.uint8)]
        snaps = []
        for pool in (jax_pool.BufferPool(), BufferPool()):
            held = []
            for op in ops:
                if op[0] == "a":
                    held.append(pool.acquire(op[1], op[2]))
                else:
                    pool.release(held[op[1]])
            snap = pool.snapshot()
            snaps.append({k: snap[k] for k in ("hits", "misses", "grows",
                                                "outstanding", "free")})
        assert snaps[0] == snaps[1]


# -- copies in flight ---------------------------------------------------------
class TestCopyEvents:
    def test_pending_copy_slab_is_never_reacquired(self):
        p = BufferPool()
        a = p.acquire((8,), np.float32)
        addr = a.ctypes.data
        ev = _Event(done=False)
        assert p.note_copy(a, ev) is True
        assert p.release(a) is True  # back on the free list, copy pending
        b = p.acquire((8,), np.float32)
        assert b.ctypes.data != addr  # passed over: a new slab
        assert p.snapshot()["copy_waits"] == 1
        ev.done = True
        c = p.acquire((8,), np.float32)
        assert c.ctypes.data == addr  # the copy completed: recycled
        assert p.hits == 1

    def test_gc_recycled_slab_waits_for_its_copy(self):
        p = BufferPool()
        a = p.acquire((1, 4), np.uint8)
        addr = a.ctypes.data
        frame = a[0]  # a copy reads a derived view of the slab
        p.note_copy(frame, _Event(done=False))
        del frame, a
        gc.collect()
        assert p.snapshot()["free"] == 1
        assert p.acquire((1, 4), np.uint8).ctypes.data != addr

    def test_note_copy_ignores_foreign_arrays(self):
        p = BufferPool()
        assert p.note_copy(np.zeros(8, np.float32), _Event()) is False
        other = BufferPool().acquire((8,), np.float32)
        assert p.note_copy(other, _Event()) is False

    def test_clear_forgets_events(self):
        p = BufferPool()
        a = p.acquire((8,), np.float32)
        p.note_copy(a, _Event(done=False))
        p.release(a)
        p.clear()
        assert p.snapshot()["free"] == 0 and not p._copy_events

    @pytest.mark.gpu
    def test_real_event_on_pinned_slabs(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU: page-locked slabs and CUDA "
                        "events")
        tnt.set_device(None)
        p = BufferPool()
        a = p.acquire((1 << 22,), np.float32)
        assert pinned_view(a) is not None and pinned_view(a).is_pinned()
        addr = a.ctypes.data
        a[:] = 3.0
        dev = torch.empty(a.shape, device="cuda:0")
        torch.cuda._sleep(50_000_000)  # hold the stream: the copy waits
        dev.copy_(as_torch(a), non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        p.note_copy(a, ev)
        p.release(a)
        b = p.acquire((1 << 22,), np.float32)
        assert b.ctypes.data != addr or ev.query()
        b[:] = -1.0
        torch.cuda.synchronize()
        assert bool((dev == 3.0).all())


# -- slabs, views and windows -------------------------------------------------
def test_pinned_view_shares_the_slab_storage():
    """A numpy view of a tensor-owned slab becomes a tensor over the same
    bytes, in the slab tensor's own storage (on the card that storage is
    page-locked, so its copies are asynchronous and recorded)."""
    owner = torch.zeros(1024 + 64, dtype=torch.uint8)
    slab = owner.numpy()
    view = slab[64:64 + 4 * 8 * 3].view(np.float32).reshape(8, 3)
    t = pinned_view(view)
    assert t.data_ptr() == view.ctypes.data
    assert t.untyped_storage().data_ptr() == owner.untyped_storage() \
        .data_ptr()
    view[2, 1] = 5.0
    assert float(t[2, 1]) == 5.0
    assert torch.equal(as_torch(view), t)
    assert pinned_view(view[:, 1]) is None  # not C-contiguous
    assert pinned_view(np.zeros((8, 3), np.float32)) is None


def test_cpu_device_slabs_are_pageable_numpy():
    tnt.set_device("cpu")
    try:
        a = BufferPool().acquire((4, 4), np.uint8)
    finally:
        tnt.set_device(None)
    assert pinned_view(a) is None and a.base.base is None


def test_contiguous_window_view_matches_jax():
    p = BufferPool()
    slab = p.acquire_window(4, (2, 3), np.float32)
    slots = [slab[i] for i in range(4)]
    for fn in (contiguous_window_view, jax_pool.contiguous_window_view):
        win = fn(slots)
        assert win is not None and win.shape == (4, 2, 3)
        assert win.ctypes.data == slots[0].ctypes.data
        assert fn(slots[::2]) is None  # not back to back
        assert fn([slots[0]]) is None
        assert fn([np.zeros((2, 3), np.float32)] * 2) is None


def test_source_and_converter_use_the_pool():
    before = get_pool().snapshot()
    pipe = tnt.parse_launch(
        "videotestsrc pattern=ball num-buffers=6 width=32 height=32 ! "
        "tensor_converter frames-per-tensor=2 ! tensor_sink name=sink")
    pipe.run(timeout=30)
    after = get_pool().snapshot()
    assert (after["hits"] + after["misses"]) - \
        (before["hits"] + before["misses"]) >= 6 + 3
    bufs = pipe.get("sink").buffers
    assert len(bufs) == 3 and bufs[0].tensors[0].shape == (2, 32, 32, 3)


def test_metrics_snapshot_and_stop_clear_the_pool(monkeypatch):
    pipe = tnt.parse_launch(
        "videotestsrc pattern=ball num-buffers=3 width=16 height=16 ! "
        "tensor_converter ! tensor_sink name=sink")
    pipe.run(timeout=30)
    snap = pipe.metrics_snapshot()
    for key in ("hits", "misses", "outstanding", "hit_rate"):
        assert key in snap["pool"]
    assert get_pool().snapshot()["free"] == 0  # stop() dropped free slabs
    monkeypatch.setattr(pool_mod, "pool_enabled", lambda: False)
    from nnstreamer_tpu_torch.pipeline import pipeline as pipeline_mod

    monkeypatch.setattr(pipeline_mod, "pool_enabled", lambda: False)
    assert "pool" not in pipe.metrics_snapshot()
