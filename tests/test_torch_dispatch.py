"""The dispatch window of the PyTorch port (``nnstreamer_tpu_torch/pipeline/dispatch.py``)
and the ``inflight`` property of ``tensor_filter`` and of fused regions.

The cases of the JAX package's ``tests/test_overlap.py::TestDispatchWindow``
and ``TestInflight`` run against the port. On the card a batch's fence is
a CUDA event; here batches of CPU tensors have nothing outstanding and
fence at once, so the window's bounding and draining are checked with
stand-in events. Through a real filter pipeline the outputs are
byte-identical at every ``inflight`` setting, fused or not, and equal the
JAX package's for the same linear model (rtol 1e-6: float32, one matmul).
"""

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.filters.jax_backend import (
    register_jax_model,
    unregister_jax_model,
)
from nnstreamer_tpu.tensors.types import TensorInfo, TensorsInfo, TensorType
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.pipeline.dispatch import (
    POOL_STASH_META,
    DispatchWindow,
    batch_event,
    release_shed_payload,
)
from nnstreamer_tpu_torch.pipeline.element import Element
from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline
from nnstreamer_tpu_torch.tensors.buffer import (
    H2D_EXCLUSIVE_META,
    TensorBuffer,
)
from nnstreamer_tpu_torch.tensors.pool import get_pool


class _Event:
    """A CUDA event stand-in recording its waits."""

    def __init__(self, fail=False):
        self.waited = 0
        self.fail = fail

    def synchronize(self):
        self.waited += 1
        if self.fail:
            raise RuntimeError("device fault")


class _WindowOwner(Element):
    ELEMENT_NAME = "_winowner"
    PROPERTIES = {**Element.PROPERTIES, "inflight": 2}


def _mk(inflight):
    owner = _WindowOwner(inflight=inflight)
    return owner, DispatchWindow(owner)


class TestDispatchWindow:
    def test_admit_bounds_window(self):
        _owner, w = _mk(2)
        events = [_Event() for _ in range(5)]
        for ev in events:
            w.admit([torch.zeros(4)], event=ev)
            assert len(w) <= 2
        assert len(w) == 2
        assert [e.waited for e in events] == [1, 1, 1, 0, 0]

    def test_inflight_zero_is_synchronous(self):
        _owner, w = _mk(0)
        ev = _Event()
        w.admit([torch.zeros(4)], event=ev)
        assert len(w) == 0 and ev.waited == 1

    def test_drain_empties_window(self):
        _owner, w = _mk(8)
        for _ in range(5):
            w.admit([torch.zeros(2)], event=_Event())
        assert len(w) == 5
        w.drain()
        assert len(w) == 0

    def test_fence_releases_stash(self):
        pool = get_pool()
        staged = pool.acquire((4,), np.float32)
        _owner, w = _mk(1)
        w.admit([torch.zeros(4)], stash=[staged], event=_Event())
        assert pool.owns(staged)  # still outstanding inside the window
        w.drain()
        assert not pool.owns(staged)  # the fence proved the dispatch done

    def test_cpu_batch_fences_at_once(self):
        """No CUDA tensor, nothing outstanding: admitted and fenced."""
        pool = get_pool()
        staged = pool.acquire((4,), np.float32)
        _owner, w = _mk(2)
        assert batch_event([torch.zeros(4), np.zeros(3)]) is None
        w.admit(TensorBuffer([torch.zeros(4)]), stash=[staged])
        assert len(w) == 0 and not pool.owns(staged)

    def test_snapshot_reports_limits_and_fence_waits(self):
        _owner, w = _mk(3)
        w.admit([torch.zeros(2)], event=_Event())
        snap = w.snapshot()
        assert snap["inflight_now"] == 1 and snap["inflight_limit"] == 3
        w.drain()
        snap = w.snapshot()
        assert snap["inflight_now"] == 0 and "fence_wait_p50_ms" in snap

    def test_failed_fence_poisons_only_its_batch(self):
        pool = get_pool()
        staged = [pool.acquire((4,), np.float32) for _ in range(3)]
        _owner, w = _mk(8)
        events = [_Event(), _Event(fail=True), _Event()]
        for ev, st in zip(events, staged):
            w.admit([torch.zeros(2)], stash=[st], event=ev)
        with pytest.raises(RuntimeError, match="device fault"):
            w.drain()
        assert len(w) == 0 and [e.waited for e in events] == [1, 1, 1]
        assert not any(pool.owns(s) for s in staged)
        w.admit([torch.zeros(2)], event=_Event(fail=True))
        w.drain(on_error="log")  # teardown mode: logged, not raised


def test_release_shed_payload():
    pool = get_pool()
    staged = pool.acquire((4,), np.float32)
    buf = TensorBuffer([torch.zeros(3)],
                       meta={POOL_STASH_META: [staged],
                             H2D_EXCLUSIVE_META: True})
    release_shed_payload(buf)
    assert not pool.owns(staged)
    assert POOL_STASH_META not in buf.meta
    assert buf.tensors  # CPU tensors are no device payload: kept


# -- inflight through a real filter pipeline ----------------------------------
FILTER_DESC = (
    "appsrc name=src ! "
    "tensor_transform mode=arithmetic option=typecast:float32,mul:2.0 ! "
    "tensor_filter framework=jax model={m} name=filter inflight={k} ! "
    "tensor_sink name=sink"
)
W = np.full((4, 3), 0.5, np.float32)


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("w", torch.from_numpy(W.copy()))

    def forward(self, x):
        return x.float() @ self.w


@pytest.fixture
def linear_model():
    tnt.set_device("cpu")
    register_torch_model("overlap_linear", _Linear())
    yield "overlap_linear"
    unregister_torch_model("overlap_linear")
    tnt.set_device(None)


def _run_filter(pkg, desc, frames, fuse=True):
    pipe = pkg.parse_launch(desc)
    pipe._fuse = fuse
    pipe.start()
    try:
        src = pipe.get("src")
        for f in frames:
            src.push([f.copy()])
        src.end_of_stream()
        msg = pipe.wait(timeout=60)
        assert msg is not None and msg.kind == "eos", msg
    finally:
        pipe.stop()
    return pipe, [np.asarray(b.tensors[0])
                  for b in pipe.get("sink").buffers]


def _frames(n=8):
    return [np.random.default_rng(i).integers(0, 9, (8, 4)).astype(np.uint8)
            for i in range(n)]


class TestInflight:
    @pytest.mark.parametrize("fuse", [False, True])
    def test_results_byte_identical_inflight_1_vs_2(self, linear_model,
                                                    fuse):
        frames = _frames()
        _p1, out1 = _run_filter(tnt, FILTER_DESC.format(m=linear_model, k=1),
                                frames, fuse)
        _p2, out2 = _run_filter(tnt, FILTER_DESC.format(m=linear_model, k=2),
                                frames, fuse)
        assert len(out1) == len(out2) == len(frames)
        for a, b in zip(out1, out2):
            assert a.tobytes() == b.tobytes()

    @pytest.mark.parametrize("fuse", [False, True])
    def test_eos_flushes_non_empty_window(self, linear_model, fuse):
        frames = [np.full((8, 4), i, np.uint8) for i in range(3)]
        _pipe, out = _run_filter(
            tnt, FILTER_DESC.format(m=linear_model, k=16), frames, fuse)
        assert len(out) == 3
        for i, a in enumerate(out):
            np.testing.assert_allclose(
                a, np.full((8, 3), i * 2 * 0.5 * 4, np.float32))

    def test_region_adopts_member_inflight(self, linear_model):
        pipe, _ = _run_filter(tnt, FILTER_DESC.format(m=linear_model, k=5),
                              [np.ones((8, 4), np.uint8)] * 2)
        (region,) = pipe._regions
        assert int(region.get_property("inflight")) == 5
        snap = pipe.metrics_snapshot()["regions"][region.name]
        assert snap["inflight_limit"] == 5 and snap["inflight_now"] == 0

    def test_metrics_snapshot_exposes_overlap_series(self, linear_model):
        pipe, _ = _run_filter(tnt, FILTER_DESC.format(m=linear_model, k=2),
                              [np.ones((8, 4), np.uint8)] * 4, fuse=False)
        snap = pipe.metrics_snapshot()
        filt = snap["elements"]["filter"]
        assert filt["inflight_limit"] == 2 and "inflight_now" in filt
        for key in ("hits", "misses", "outstanding", "hit_rate"):
            assert key in snap["pool"]

    @pytest.mark.parametrize("k", [0, 2])
    def test_matches_jax_filter(self, linear_model, k):
        import jax.numpy as jnp

        def fn(params, x):
            return x.astype(jnp.float32) @ params

        in_info = TensorsInfo([TensorInfo(dim=(4, 8),
                                          type=TensorType.FLOAT32)])
        out_info = TensorsInfo([TensorInfo(dim=(3, 8),
                                           type=TensorType.FLOAT32)])
        register_jax_model("overlap_linear", fn, jnp.asarray(W),
                           in_info=in_info, out_info=out_info)
        try:
            frames = _frames(6)
            _, ref = _run_filter(jnt, FILTER_DESC.format(
                m="overlap_linear", k=k), frames)
            _, got = _run_filter(tnt, FILTER_DESC.format(
                m=linear_model, k=k), frames)
        finally:
            unregister_jax_model("overlap_linear")
        assert len(got) == len(ref) == 6
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, rtol=1e-6)

    def test_filter_pops_and_releases_the_stash(self, linear_model):
        """An unfused filter takes a frame's staging arrays and releases
        them at its (immediate, CPU) fence."""
        pool = get_pool()
        staged = pool.acquire((8, 4), np.uint8)
        staged[:] = 1
        pipe = tnt.parse_launch(
            f"appsrc name=src ! tensor_filter framework=jax "
            f"model={linear_model} name=filter ! tensor_sink name=sink",
            pipeline=Pipeline(fuse=False))
        pipe.start()
        try:
            pipe.get("src").push(TensorBuffer(
                [torch.ones(8, 4, dtype=torch.uint8)],
                meta={POOL_STASH_META: [staged]}))
            pipe.get("src").end_of_stream()
            msg = pipe.wait(timeout=30)
            assert msg is not None and msg.kind == "eos"
        finally:
            pipe.stop()
        assert not pool.owns(staged)
        (out,) = pipe.get("sink").buffers
        assert POOL_STASH_META not in out.meta


def test_inflight_property_is_ported():
    pipe = tnt.parse_launch(
        "appsrc ! tensor_filter framework=jax model=x inflight=3 ! "
        "tensor_sink")
    (filt,) = [e for e in pipe.elements
               if e.ELEMENT_NAME == "tensor_filter"]
    assert filt.get_property("inflight") == 3


@pytest.mark.gpu
def test_window_fences_on_cuda_events():
    """On the card a batch's fence is an event recorded after its
    outputs: held by a long kernel, the window stays full until it ends,
    and the stash is released only at the fence."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the window fences on CUDA events")
    pool = get_pool()
    _owner, w = _mk(1)
    staged = [pool.acquire((4,), np.float32) for _ in range(2)]
    torch.cuda._sleep(50_000_000)
    w.admit([torch.ones(4, device="cuda:0")], stash=[staged[0]])
    assert len(w) == 1 and pool.owns(staged[0])
    w.admit([torch.ones(4, device="cuda:0")], stash=[staged[1]])
    assert len(w) == 1 and not pool.owns(staged[0])  # fenced the oldest
    w.drain()
    assert not pool.owns(staged[1])
    assert w.snapshot()["fence_wait_p99_ms"] >= 0.0
