"""``tensor_aggregator`` in the PyTorch port, held to the JAX package's.

The same seeded numpy frames go through the JAX package's
``TensorAggregator`` and the port's, and every window that comes out must
be byte-identical, with the same ``valid_frames`` / ``pad_rows`` meta and
the same number of capture stamps: batching, sliding windows,
``frames-dim``, ``frames-in`` > 1, several tensors a frame,
``concat=false``, device tensors, budget partials padded on the host and
on the device (through a ``prefetch-device`` queue), and the EOS tail.
A budget partial is made deterministic by stamping frames in the past and
by holding the collector's ``accepts_now`` at False, so no flusher thread
decides when it happens. Then the cases of ``tests/test_latency_budget.py``
run against the port, and the flagship at batch 8
(``bench.py``'s default launch string, at 32×32 with 10 classes) runs
through both packages with weights converted by ``params_from_jax``:
labels exactly, scores to rtol 1e-4 and atol 1e-4 × max|score|, the
tolerance of ``tests/test_torch_fuse.py``.
"""

import gc
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.elements.aggregator import TensorAggregator as JaxAgg
from nnstreamer_tpu.filters.jax_backend import (
    register_jax_model,
    unregister_jax_model,
)
from nnstreamer_tpu.models.mobilenet_v2 import mobilenet_v2 as jax_mobilenet_v2
from nnstreamer_tpu.pipeline.element import Element as JaxElement
from nnstreamer_tpu.pipeline.element import EosEvent as JaxEos
from nnstreamer_tpu.pipeline.pipeline import Queue as JaxQueue
from nnstreamer_tpu.tensors.buffer import TensorBuffer as JaxBuffer
from nnstreamer_tpu_torch.elements import transform as transform_mod
from nnstreamer_tpu_torch.elements.aggregator import TensorAggregator
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2, params_from_jax
from nnstreamer_tpu_torch.pipeline.element import Element, EosEvent
from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline, Queue
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

SIZE, CLASSES = 32, 10


@pytest.fixture
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


# -- byte-identical windows ---------------------------------------------------
def _collector(base):
    class Collect(base):
        ELEMENT_NAME = "_agg_collect"
        DEVICE_PASSTHROUGH = True

        def __init__(self, name=None, **props):
            super().__init__(name, **props)
            self.add_sink_pad("sink")
            self.got = []
            self.ready = True

        def accepts_now(self):
            return self.ready

        def chain(self, pad, buf):
            self.got.append(buf)

    return Collect


JaxCollect = _collector(JaxElement)
TorchCollect = _collector(Element)


def _frames(n, shape, dtype=np.uint8, seed=0, tensors=1):
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, 255, shape).astype(dtype)
             for _ in range(tensors)] for _ in range(n)]


def _windows(pkg, props, frames, stamps=None, ready=None, staging=False,
             device_input=False):
    """Push ``frames`` through an aggregator of package ``pkg`` ("jax" or
    "torch") into a collector (behind a prefetch-device queue with
    ``staging``), then EOS; the collected windows as comparable tuples."""
    if pkg == "jax":
        agg, sink, Buf, eos = JaxAgg("agg", **props), JaxCollect(), \
            JaxBuffer, JaxEos
        queue = JaxQueue(prefetch_device=True) if staging else None
    else:
        agg, sink, Buf, eos = TensorAggregator("agg", **props), \
            TorchCollect(), TensorBuffer, EosEvent
        queue = Queue(prefetch_device=True) if staging else None
    if queue is None:
        agg.srcpad.link(sink.sinkpad)
    else:
        agg.srcpad.link(queue.sinkpad)
        queue.srcpad.link(sink.sinkpad)
    for i, tensors in enumerate(frames):
        if device_input:
            tensors = [jnp.asarray(t) if pkg == "jax" else torch.tensor(t)
                       for t in tensors]
        meta = {} if stamps is None else {"create_t": stamps[i]}
        if ready is not None:
            sink.ready = ready[i]
        agg.chain(agg.sinkpad, Buf(list(tensors), pts=i, meta=meta))
    sink.ready = True
    agg.sinkpad.eos = True
    agg.sink_event(agg.sinkpad, eos())
    out = []
    for b in sink.got:
        arrs = [np.asarray(t) for t in b.tensors]
        out.append((b.pts, [(a.shape, a.dtype.str, a.tobytes())
                            for a in arrs],
                    b.meta.get("valid_frames"), b.meta.get("pad_rows"),
                    len(b.meta.get("create_ts", ()))))
    return out


def _same_windows(props, frames, **kw):
    # The JAX pool's GC finalizer takes the pool's plain lock, so a
    # collection inside one of its locked blocks deadlocks (ROADMAP queue
    # C.22, the JAX package's fault, repaired in the port): the reference
    # side runs with the cyclic GC off.
    gc_was_on = gc.isenabled()
    gc.disable()
    try:
        ref = _windows("jax", props, frames, **kw)
    finally:
        if gc_was_on:
            gc.enable()
    got = _windows("torch", props, frames, **kw)
    assert got == ref
    return got


AGG_CASES = {
    "batch8": (dict(frames_out=8, frames_flush=8, frames_dim=3), 20,
               (1, 6, 5, 3)),
    "sliding": (dict(frames_out=4, frames_flush=2, frames_dim=1), 11,
                (1, 4)),
    "non_leading_axis": (dict(frames_out=3, frames_dim=0), 9, (1, 4)),
    "frames_in_2": (dict(frames_in=2, frames_out=4, frames_dim=3), 8,
                    (2, 3, 3, 2)),
    "concat_false": (dict(frames_out=3, frames_dim=1, concat=False), 7,
                     (1, 4)),
}


@pytest.mark.parametrize("case", sorted(AGG_CASES))
def test_windows_byte_identical(case):
    props, n, shape = AGG_CASES[case]
    got = _same_windows(props, _frames(n, shape, seed=len(case)))
    assert got


def test_windows_byte_identical_two_tensors_float():
    props = dict(frames_out=4, frames_dim=1)
    frames = _frames(10, (1, 5), dtype=np.float32, seed=3, tensors=2)
    got = _same_windows(props, frames)
    assert len(got) == 2 and len(got[0][1]) == 2


def test_device_windows_concatenate_on_the_device(cpu_device):
    props = dict(frames_out=4, frames_dim=2)
    got = _same_windows(props, _frames(8, (1, 3, 2), seed=4),
                        device_input=True)
    assert len(got) == 2


#: a budget no fresh stamp outlives during a test, and stamps far past it
BUDGET_MS = 10_000


def _budget_stamps(n, old):
    now = time.monotonic()
    return [now - 100.0 if i in old else now for i in range(n)]


@pytest.mark.parametrize("pad_device", [False, True])
def test_budget_partials_byte_identical(pad_device):
    """A full window, then a partial of 3 held while the downstream was
    not ready, then one of 1 frame: padded on the host (repeat-last) or
    left to the device, with valid_frames (and pad_rows) meta."""
    n = 12
    props = dict(frames_out=8, frames_dim=3, latency_budget_ms=BUDGET_MS,
                 pad_device=pad_device)
    ready = [i not in (8, 9) for i in range(n)]
    frames = _frames(n, (1, 4, 4, 3), seed=5)
    got = _same_windows(props, frames,
                        stamps=_budget_stamps(n, old={8, 9, 10, 11}),
                        ready=ready)
    assert [w[2] for w in got] == [None, 3, 1]
    rows = [w[1][0][0][0] for w in got]
    if pad_device:
        assert [w[3] for w in got] == [None, 5, 7] and rows == [8, 3, 1]
    else:
        assert [w[3] for w in got] == [None, None, None] and \
            rows == [8, 8, 8]
    assert [w[4] for w in got] == [8, 3, 1]


def test_pad_device_through_staging_queue_matches_host_pad(cpu_device):
    """Through a prefetch-device queue the deferred pad becomes zero rows
    on the device, byte-identical to the JAX package's; its valid rows
    equal the host-padded window's."""
    n = 12
    frames = _frames(n, (1, 4, 4, 3), seed=6)
    kw = dict(stamps=_budget_stamps(n, old={8, 9, 10, 11}), staging=True)
    dev = _same_windows(dict(frames_out=8, frames_dim=3,
                             latency_budget_ms=BUDGET_MS, pad_device=True),
                        frames, **kw)
    host = _same_windows(dict(frames_out=8, frames_dim=3,
                              latency_budget_ms=BUDGET_MS), frames, **kw)
    assert [w[2] for w in dev] == [None, 1, 1, 1, 1]
    assert [w[1][0][0] for w in dev] == [(8, 4, 4, 3)] * 5
    for (_, [(_, _, d)], k, _, _), (_, [(_, _, h)], _, _, _) in zip(dev,
                                                                    host):
        k = k or 8
        row = 4 * 4 * 3
        assert d[:k * row] == h[:k * row]
        assert d[k * row:] == bytes(len(d) - k * row)


@pytest.mark.parametrize("budget", [0, 10_000])
def test_eos_tail(budget):
    """Budget mode flushes the partial tail at EOS; without a budget the
    tail is dropped, as the reference drops incomplete windows."""
    props = dict(frames_out=4, frames_dim=1, latency_budget_ms=budget)
    got = _same_windows(props, _frames(6, (1, 4), seed=7))
    assert [w[2] for w in got] == ([None, 2] if budget else [None])


def test_note_mesh_quantum_names_its_item():
    """Mesh-wide batch forming raised naming A.24 until the serving mesh
    was ported; it rounds frames-out up to the quantum as JAX's does."""
    for fout, q in ((8, 4), (6, 4), (1, 4)):
        ours, theirs = TensorAggregator(frames_out=fout), JaxAgg(
            frames_out=fout)
        ours.note_mesh_quantum(q)
        theirs.note_mesh_quantum(q)
        assert int(ours.get_property("frames_out")) == \
            int(theirs.get_property("frames_out"))


# -- tests/test_latency_budget.py against the port ----------------------------
def _wire(budget_ms, fout=4, fd=1):
    agg = TensorAggregator("agg", frames_in=1, frames_out=fout,
                           frames_flush=fout, frames_dim=fd, concat=True,
                           latency_budget_ms=budget_ms)
    sink = TensorSink("out")
    agg.srcpad.link(sink.sinkpad)
    return agg, sink


def _frame(i):
    return np.full((1, 4), float(i), np.float32)


def _eos(agg):
    agg.sinkpad.eos = True
    agg.sink_event(agg.sinkpad, EosEvent())


class TestPartialFlush:
    def test_watchdog_flushes_stalled_window(self):
        agg, sink = _wire(budget_ms=30)
        agg.start()
        try:
            t0 = time.monotonic()
            for i in range(2):
                agg.chain(agg.sinkpad, TensorBuffer(
                    [_frame(i)], pts=i, meta={"create_t": t0}))
            deadline = time.monotonic() + 2.0
            while not sink.buffers and time.monotonic() < deadline:
                time.sleep(0.005)
            assert len(sink.buffers) == 1
            assert time.monotonic() - t0 < 0.5
            out = sink.buffers[0]
            assert out.tensors[0].shape == (2, 4)  # trimmed by the sink
            np.testing.assert_array_equal(
                out.tensors[0], np.vstack([_frame(0), _frame(1)]))
            assert out.meta["valid_frames"] == 2
            assert len(out.meta["create_ts"]) == 2
            assert len(sink.latencies) == 2  # the real frames only
        finally:
            agg.stop()

    def test_unstamped_frames_use_arrival_clock(self):
        agg, sink = _wire(budget_ms=25)
        agg.start()
        try:
            agg.chain(agg.sinkpad, TensorBuffer([_frame(7)], pts=0))
            deadline = time.monotonic() + 2.0
            while not sink.buffers and time.monotonic() < deadline:
                time.sleep(0.005)
            assert len(sink.buffers) == 1
            assert sink.buffers[0].meta["valid_frames"] == 1
            assert sink.buffers[0].tensors[0].shape == (1, 4)
        finally:
            agg.stop()

    def test_saturated_stream_never_pads(self):
        agg, sink = _wire(budget_ms=50)
        agg.start()
        try:
            for i in range(8):
                agg.chain(agg.sinkpad, TensorBuffer([_frame(i)], pts=i))
            assert len(sink.buffers) == 2
            for out in sink.buffers:
                assert "valid_frames" not in out.meta
                assert out.tensors[0].shape == (4, 4)
            np.testing.assert_array_equal(
                np.vstack([b.tensors[0] for b in sink.buffers]),
                np.vstack([_frame(i) for i in range(8)]))
        finally:
            agg.stop()

    def test_eos_flushes_partial_tail(self):
        agg, sink = _wire(budget_ms=10_000)
        for i in range(3):
            agg.chain(agg.sinkpad, TensorBuffer([_frame(i)], pts=i))
        assert not sink.buffers
        _eos(agg)
        assert len(sink.buffers) == 1
        assert sink.buffers[0].meta["valid_frames"] == 3
        assert sink.buffers[0].tensors[0].shape == (3, 4)
        assert sink.eos

    def test_concat_false_partial_emits_unpadded(self):
        agg, sink = _wire(budget_ms=10_000)
        agg.set_property("concat", False)
        for i in range(2):
            agg.chain(agg.sinkpad, TensorBuffer([_frame(i)], pts=i))
        _eos(agg)
        out = sink.buffers[0]
        assert "valid_frames" not in out.meta
        assert len(out.tensors) == 2
        np.testing.assert_array_equal(out.tensors[1], _frame(1))

    def test_non_leading_axis_partial_emits_unpadded(self):
        agg, sink = _wire(budget_ms=10_000, fd=0)
        for i in range(2):
            agg.chain(agg.sinkpad, TensorBuffer([_frame(i)], pts=i))
        _eos(agg)
        out = sink.buffers[0]
        assert "valid_frames" not in out.meta
        np.testing.assert_array_equal(
            out.tensors[0], np.hstack([_frame(0), _frame(1)]))

    def test_budget_off_keeps_reference_semantics(self):
        agg, sink = _wire(budget_ms=0)
        for i in range(3):
            agg.chain(agg.sinkpad, TensorBuffer([_frame(i)], pts=i))
        _eos(agg)
        assert not sink.buffers

    def test_full_downstream_holds_a_partial(self):
        """The budget gate: while the downstream queue reports it cannot
        take a buffer now, the window keeps filling."""
        agg = TensorAggregator("agg", frames_out=4, frames_dim=1,
                               latency_budget_ms=1)
        sink = TorchCollect()
        agg.srcpad.link(sink.sinkpad)
        sink.ready = False
        old = time.monotonic() - 1.0
        for i in range(3):
            agg.chain(agg.sinkpad, TensorBuffer([_frame(i)], pts=i,
                                                meta={"create_t": old}))
        assert not sink.got
        sink.ready = True
        agg.chain(agg.sinkpad, TensorBuffer([_frame(3)], pts=3,
                                            meta={"create_t": old}))
        assert len(sink.got) == 1 and "valid_frames" not in sink.got[0].meta


class TestPipelineExactness:
    @pytest.fixture
    def rowsum(self, cpu_device):
        class RowSum(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.register_buffer(
                    "w", torch.arange(8, dtype=torch.float32) + 1.0)

            def forward(self, x):
                return (x * self.w).sum(dim=1)

        register_torch_model("agg_rowsum", RowSum())
        yield "agg_rowsum"
        unregister_torch_model("agg_rowsum")

    def _run(self, model, frames, paced_ms, staging=""):
        pipe = tnt.parse_launch(
            "appsrc name=src ! "
            "tensor_aggregator frames-in=1 frames-out=4 frames-flush=4 "
            f"frames-dim=1 concat=true latency-budget-ms=25 {staging}! "
            f"tensor_filter framework=jax model={model} ! "
            "tensor_sink name=sink")
        src, sink = pipe.get("src"), pipe.get("sink")
        pipe.start()
        try:
            for i, f in enumerate(frames):
                src.push([f])
                if paced_ms and (not staging or i >= 4):
                    time.sleep(paced_ms / 1e3)
                elif staging and i == 3:
                    time.sleep(0.2)
            src.end_of_stream()
            msg = pipe.wait(timeout=60)
            assert msg is not None and msg.kind == "eos", msg
            return sink.buffers
        finally:
            pipe.stop()

    @staticmethod
    def _want(frames):
        return np.concatenate(
            [f @ (np.arange(8, dtype=np.float32) + 1.0) for f in frames])

    def test_paced_partial_equals_full_batch_math(self, rowsum):
        rng = np.random.default_rng(0)
        frames = [rng.standard_normal((1, 8)).astype(np.float32)
                  for _ in range(6)]
        outs = self._run(rowsum, frames, paced_ms=45)
        got = np.concatenate([np.asarray(b.tensors[0]).reshape(-1)
                              for b in outs])
        np.testing.assert_allclose(got, self._want(frames), rtol=1e-4,
                                   atol=1e-6)
        assert len(outs) > 2

    def test_pad_device_partial_equals_host_pad(self, rowsum):
        rng = np.random.default_rng(2)
        frames = [rng.standard_normal((1, 8)).astype(np.float32)
                  for _ in range(6)]
        outs = self._run(rowsum, frames, paced_ms=45,
                         staging="pad-device=true ! queue "
                                 "max-size-buffers=4 prefetch-device=true ")
        got = np.concatenate([np.asarray(b.tensors[0]).reshape(-1)
                              for b in outs])
        assert got.shape == (6,)
        np.testing.assert_allclose(got, self._want(frames), rtol=1e-4,
                                   atol=1e-6)
        assert any(b.meta.get("valid_frames") for b in outs)

    def test_burst_full_batches_unaffected(self, rowsum):
        rng = np.random.default_rng(1)
        frames = [rng.standard_normal((1, 8)).astype(np.float32)
                  for _ in range(8)]
        outs = self._run(rowsum, frames, paced_ms=0)
        got = np.concatenate([np.asarray(b.tensors[0]).reshape(-1)
                              for b in outs])
        np.testing.assert_allclose(got, self._want(frames), rtol=1e-4,
                                   atol=1e-6)


# -- the flagship at batch 8 through both packages ----------------------------
def _batched(model, labels, n, extra=""):
    """bench.py's default flagship launch string (batch 8, a staging queue
    with prefetch-device, inflight=2, option2=batched, a materialize-host
    drain), at a small size."""
    return (
        f"videotestsrc num-buffers={n} width={SIZE} height={SIZE} "
        "pattern=ball ! tensor_converter ! queue max-size-buffers=16 ! "
        "tensor_aggregator frames-in=1 frames-out=8 frames-flush=8 "
        f"frames-dim=3 concat=true {extra}! "
        "queue max-size-buffers=8 prefetch-device=true ! "
        "tensor_transform mode=arithmetic "
        "option=typecast:float32,add:-127.5,div:127.5 ! "
        f"tensor_filter framework=jax model={model} name=filter "
        "inflight=2 ! "
        f"tensor_decoder mode=image_labeling option1={labels} "
        "option2=batched ! "
        "queue max-size-buffers=64 materialize-host=true ! "
        "tensor_sink name=out to-host=true")


@pytest.fixture
def labels(tmp_path):
    path = tmp_path / "labels.txt"
    path.write_text("".join(f"label_{i}\n" for i in range(CLASSES)))
    return str(path)


@pytest.fixture
def parity_models(cpu_device):
    apply_fn, variables, in_info, out_info = jax_mobilenet_v2(
        num_classes=CLASSES, image_size=SIZE, dtype=jnp.float32, seed=5,
        batch=8)
    module = MobileNetV2(num_classes=CLASSES)
    module.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                        variables)))
    register_jax_model("agg_parity", apply_fn, variables, in_info=in_info,
                       out_info=out_info)
    register_torch_model("agg_parity", module.eval())
    yield "agg_parity"
    unregister_jax_model("agg_parity")
    unregister_torch_model("agg_parity")


def _metas(pipe):
    got = []
    pipe.get("out").connect(lambda buf: got.append(buf.meta))
    pipe.run(timeout=180)
    return got


@pytest.mark.parametrize("fuse", [True, False])
def test_batched_flagship_matches_jax(parity_models, labels, monkeypatch,
                                      fuse):
    n = 20  # two full windows; the tail of 4 is dropped without a budget
    calls = []
    b1 = transform_mod.normalize_chain
    monkeypatch.setattr(transform_mod, "normalize_chain",
                        lambda x, *a, **k: calls.append(tuple(x.shape))
                        or b1(x, *a, **k))
    ref_pipe = jnt.parse_launch(_batched(parity_models, labels, n))
    ref = _metas(ref_pipe)
    pipe = tnt.parse_launch(_batched(parity_models, labels, n),
                            pipeline=Pipeline(fuse=fuse))
    got = _metas(pipe)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g["label"] == r["label"] and len(g["label"]) == 8
        assert g["label_index"] == r["label_index"]
        rs = np.array(r["score"])
        np.testing.assert_allclose(g["score"], rs, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(rs).max()))
    # B1's wrapper ran once a window, on the whole window
    assert calls == [(8, SIZE, SIZE, 3)] * 2
    if fuse:
        (region,) = pipe.metrics_snapshot()["regions"].values()
        assert region["retraces"] == 1 and region["inflight_limit"] == 2
    snap = pipe.metrics_snapshot()
    assert snap["elements"]["filter"]["inflight_limit"] == 2


def test_budget_partial_windows_keep_one_signature(parity_models, labels):
    """Padded partial windows (device pad through the staging queue) give
    the fused region no new input signature; the sink trims every window
    to its valid frames, and every frame is labelled as in a run of full
    windows (the decoder labels all 8 rows; the valid ones come first)."""
    n = 11
    full = _metas(tnt.parse_launch(_batched(parity_models, labels, 16)))
    pipe = tnt.parse_launch(_batched(
        parity_models, labels, n,
        "latency-budget-ms=1 pad-device=true").replace(
            "pattern=ball", "pattern=ball is-live=true framerate=100/1"))
    got = _metas(pipe)
    (region,) = pipe.metrics_snapshot()["regions"].values()
    assert region["retraces"] == 1
    valid = [m.get("valid_frames", 8) for m in got]
    assert sum(valid) == n and any(v < 8 for v in valid)
    labels_seen = [lab for m, k in zip(got, valid) for lab in m["label"][:k]]
    scores_seen = [s for m, k in zip(got, valid) for s in m["score"][:k]]
    want_labels = [lab for m in full for lab in m["label"]][:n]
    want_scores = [s for m in full for s in m["score"]][:n]
    assert labels_seen == want_labels
    np.testing.assert_allclose(scores_seen, want_scores, rtol=1e-5,
                               atol=1e-6)


# -- on the card ---------------------------------------------------------------
@pytest.mark.gpu
def test_batched_flagship_on_the_card(labels):
    """Batch 8 on the card: one capture at [8, S, S, 3], B1 launched once
    a window (1 eager + replays), labels and scores bit-identical to the
    unfused run and to a run with the pool off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: page-locked staging, CUDA events "
                    "and a captured region")
    import os

    from nnstreamer_tpu_torch.ops import _build, _counts

    # B1 builds before the runs: built inside the first window, nvcc can
    # hold it past the 30 s a queue waits to pass EOS on (ROADMAP C.54),
    # and the run then ends with windows still in flight
    _build.build_all(["normalize"])
    tnt.set_device(None)
    register_torch_model("agg_gpu", MobileNetV2(num_classes=CLASSES).eval())
    n, windows = 80, 10
    frames = {}
    try:
        for key, fuse, pool in (("fused", True, "1"), ("plain", False, "1"),
                                ("nopool", True, "0")):
            os.environ["NNSTPU_POOL"] = pool
            _counts.reset_launches()
            pipe = tnt.parse_launch(_batched("agg_gpu", labels, n),
                                    pipeline=Pipeline(fuse=fuse))
            metas = _metas(pipe)
            assert _counts.LAUNCHES["normalize_chain"] == windows
            frames[key] = [(lab, i, np.float32(s).tobytes())
                           for m in metas for lab, i, s in zip(
                               m["label"], m["label_index"], m["score"])]
            if fuse:
                (region,) = pipe.metrics_snapshot()["regions"].values()
                assert region["captures"] == 1 and not region["unspliced"]
                assert region["replays"] == windows - 1
    finally:
        os.environ.pop("NNSTPU_POOL", None)
        unregister_torch_model("agg_gpu")
    assert len(frames["fused"]) == n
    assert frames["fused"] == frames["plain"] == frames["nopool"]


def test_padded_window_decodes_as_jax(tmp_path):
    """ROADMAP.md C.9: a budget partial of k frames, padded to 4 rows and
    decoded with option2=batched, reaches the sink of either package the
    same: all 4 rows labelled in meta, the text tensor trimmed to k."""
    labels = tmp_path / "l.txt"
    labels.write_text("".join(f"lab{i}\n" for i in range(6)))
    rng = np.random.default_rng(9)
    scores = [rng.standard_normal((1, 6)).astype(np.float32)
              for _ in range(6)]
    old = time.monotonic() - 100.0
    desc = ("appsrc name=src ! tensor_aggregator frames-out=4 frames-dim=1 "
            f"latency-budget-ms={BUDGET_MS} ! tensor_decoder "
            f"mode=image_labeling option1={labels} option2=batched ! "
            "tensor_sink name=out")
    got = {}
    for name, pkg, Buf in (("jax", jnt, JaxBuffer),
                           ("torch", tnt, TensorBuffer)):
        pipe = pkg.parse_launch(desc)
        pipe.start()
        try:
            for i, sc in enumerate(scores):
                # frame 4 is stamped in the past: it flushes at once
                meta = {"create_t": old if i == 4 else time.monotonic()}
                pipe.get("src").push(Buf([sc], pts=i, meta=meta))
            pipe.get("src").end_of_stream()
            msg = pipe.wait(timeout=30)
            assert msg is not None and msg.kind == "eos", msg
        finally:
            pipe.stop()
        got[name] = [(np.asarray(b.tensors[0]).tobytes(), b.meta["label"],
                      b.meta.get("valid_frames"))
                     for b in pipe.get("out").buffers]
    assert got["torch"] == got["jax"]
    assert [v for _, _, v in got["torch"]] == [None, 1, 1]
    assert all(len(lab) == 4 for _, lab, _ in got["torch"])
