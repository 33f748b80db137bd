"""Serving continuity of the PyTorch port (``nnstreamer_tpu_torch/pipeline/
continuity.py``): zero-downtime model swap, checkpoint/restore and the
kernels' compile cache, held to the JAX package's
``tests/test_continuity.py``.

The swap cases run the same frames through both packages' pipelines and
swap at the same frame: ``x + 1`` and ``x * 3`` in float32 are exact in
both, so the outputs are compared bit for bit on each side of the
cutover. The weights-only swap of a MobileNetV2 converts the JAX
variables (``params_from_jax``) and compares labels exactly. The
checkpoint's ``repo`` and ``scheduler`` sections of the same inputs are
compared with the JAX package's: arrays bit for bit, floats exactly.
"""

import json
import os
import pickle
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.elements.repo import GLOBAL_REPO as JAX_REPO
from nnstreamer_tpu.filters.jax_backend import (
    register_jax_model,
    unregister_jax_model,
)
from nnstreamer_tpu.models.mobilenet_v2 import mobilenet_v2 as jax_mobilenet_v2
from nnstreamer_tpu.pipeline import continuity as jcontinuity
from nnstreamer_tpu_torch.elements.repo import GLOBAL_REPO, TensorRepo
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2, params_from_jax
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.obs.flight import FlightRecorder
from nnstreamer_tpu_torch.obs.quantiles import P2Quantile
from nnstreamer_tpu_torch.ops import _build
from nnstreamer_tpu_torch.pipeline import continuity, faults
from nnstreamer_tpu_torch.serving.scheduler import (
    ServiceRateEstimator,
    SloScheduler,
)
from nnstreamer_tpu_torch.tensors import memory
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    tnt.set_device("cpu")
    faults.deactivate()
    memory.deactivate()
    yield
    faults.deactivate()
    memory.deactivate()
    tnt.set_device(None)


def _cval(name, **labels):
    m = get_registry().get(name, **labels)
    return 0.0 if m is None else m.value


def _wait(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() >= deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


class _Add(torch.nn.Module):
    def forward(self, x):
        return x + 1.0


class _Mul(torch.nn.Module):
    def forward(self, x):
        return x * 3.0


@pytest.fixture
def swap_models():
    register_torch_model("cont_a", _Add())
    register_torch_model("cont_b", _Mul())
    register_jax_model("cont_a", lambda x: x + 1.0)
    register_jax_model("cont_b", lambda x: x * 3.0)
    yield "cont_a", "cont_b"
    for name in ("cont_a", "cont_b"):
        unregister_torch_model(name)
        unregister_jax_model(name)


SWAP_DESC = (
    "appsrc name=src ! "
    "tensor_transform mode=arithmetic option=typecast:float32,add:0.0 ! "
    "tensor_filter framework=jax model=cont_a name=filter "
    "is-updatable=true ! tensor_sink name=sink")

FRAMES = [np.full((4,), float(i), np.float32) for i in range(10)]


def _run_with_swap(pkg, desc, error_policy=None, **swap):
    """Push 5 frames, wait for them, swap, push 5 more."""
    kw = {"error_policy": error_policy} if error_policy else {}
    pipe = pkg.parse_launch(desc, **kw)
    src, sink = pipe.get("src"), pipe.get("sink")
    pipe.start()
    try:
        for f in FRAMES[:5]:
            src.push([f.copy()])
        _wait(lambda: len(sink.buffers) >= 5, what="first 5 frames")
        report = pipe.swap_model("filter", **swap)
        for f in FRAMES[5:]:
            src.push([f.copy()])
        src.end_of_stream()
        msg = pipe.wait(timeout=60)
        assert msg is not None and msg.kind == "eos", msg
    finally:
        pipe.stop()
    outs = [np.asarray(b.to_host().tensors[0] if hasattr(b, "to_host")
                       else b.tensors[0]) for b in sink.buffers]
    return pipe, report, outs


# -- live model swap ---------------------------------------------------------------
@pytest.mark.parametrize("fuse", [True, False])
def test_zero_drop_byte_identical_each_side_as_jax(swap_models, fuse):
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

    swaps0 = _cval("nns_model_swaps_total")
    pipe = tnt.parse_launch(SWAP_DESC, pipeline=Pipeline(fuse=fuse))
    src, sink = pipe.get("src"), pipe.get("sink")
    pipe.start()
    try:
        for f in FRAMES[:5]:
            src.push([f.copy()])
        _wait(lambda: len(sink.buffers) >= 5, what="first 5 frames")
        report = pipe.swap_model("filter", model="cont_b")
        for f in FRAMES[5:]:
            src.push([f.copy()])
        src.end_of_stream()
        assert pipe.wait(timeout=60).kind == "eos"
    finally:
        pipe.stop()
    outs = [np.asarray(b.to_host()[0]) for b in sink.buffers]
    _, jreport, ref = _run_with_swap(jnt, SWAP_DESC, model="cont_b")
    assert len(outs) == len(ref) == len(FRAMES)
    for i, (a, b) in enumerate(zip(outs, ref)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), i
    for i in range(5):
        np.testing.assert_array_equal(outs[i], FRAMES[i] + 1.0)
    for i in range(5, 10):
        np.testing.assert_array_equal(outs[i], FRAMES[i] * 3.0)
    assert report["epoch"] == jreport["epoch"] == 1
    assert report["invalidations"] == (1 if fuse else 0)
    assert _cval("nns_model_swaps_total") == swaps0 + 1


def test_swap_composes_with_retry_policy(swap_models):
    inj = faults.activate("filter.invoke:rate=0.3", seed=11)
    _, report, outs = _run_with_swap(tnt, SWAP_DESC, error_policy="retry",
                                     model="cont_b")
    assert inj.injected("filter.invoke") > 0
    assert len(outs) == len(FRAMES)
    for i in range(5):
        np.testing.assert_array_equal(outs[i], FRAMES[i] + 1.0)
    for i in range(5, 10):
        np.testing.assert_array_equal(outs[i], FRAMES[i] * 3.0)
    assert report["invalidations"] == 1


def test_second_swap_bumps_epoch(swap_models):
    pipe = tnt.parse_launch(SWAP_DESC)
    pipe.start()
    try:
        r1 = pipe.swap_model("filter", model="cont_b")
        r2 = pipe.swap_model("filter", model="cont_a")
    finally:
        pipe.stop()
    assert (r1["epoch"], r2["epoch"]) == (1, 2)


def test_bad_arguments_raise(swap_models):
    pipe = tnt.parse_launch(SWAP_DESC)
    pipe.start()
    try:
        with pytest.raises(ValueError, match="need model"):
            pipe.swap_model("filter")
        with pytest.raises(KeyError, match="no element"):
            pipe.swap_model("nope", model="cont_b")
        with pytest.raises(TypeError, match="not a tensor_filter"):
            pipe.swap_model("sink", model="cont_b")
    finally:
        pipe.stop()


class _W(torch.nn.Module):
    def __init__(self, scale):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((64, 64), float(scale)),
                                    requires_grad=False)

    def forward(self, x):
        return x.to(torch.float32) * self.w[0, 0]


def test_weights_swap_under_a_budget_retires_the_old_unit():
    register_torch_model("cont_w", _W(2.0))
    nbytes = 64 * 64 * 4
    try:
        acct = memory.activate(4 * nbytes)
        pipe = tnt.parse_launch(
            "appsrc name=src ! tensor_filter framework=jax model=cont_w "
            "name=filter ! tensor_sink name=sink")
        src, sink = pipe.get("src"), pipe.get("sink")
        pipe.start()
        try:
            src.push([np.full((4,), 1.0, np.float32)])
            _wait(lambda: len(sink.buffers) >= 1, what="warmup frame")
            used, keys = acct.used_bytes(), set(acct.residency._units)
            report = pipe.swap_model(
                "filter", weights={"w": torch.full((64, 64), 5.0)})
            assert acct.used_bytes() == used
            after = set(acct.residency._units)
            assert report["retired_unit"] in keys
            assert report["retired_unit"] not in after
            assert report["residency_unit"] in after
            assert report["residency_unit"].endswith(":e1")
            src.push([np.full((4,), 1.0, np.float32)])
            src.end_of_stream()
            assert pipe.wait(timeout=60).kind == "eos"
        finally:
            pipe.stop()
        got = [np.asarray(b[0]) for b in sink.buffers]
        np.testing.assert_array_equal(got[0], np.full(4, 2.0, np.float32))
        np.testing.assert_array_equal(got[1], np.full(4, 5.0, np.float32))
    finally:
        unregister_torch_model("cont_w")


class _Many(torch.nn.Module):
    """200 scalar weights, summed: a frame that read a half-installed set
    comes out between the old weights' sum and the new's."""

    def __init__(self, value):
        super().__init__()
        self.ws = torch.nn.ParameterList(
            torch.nn.Parameter(torch.full((1,), float(value)),
                               requires_grad=False) for _ in range(200))

    def forward(self, x):
        return x.to(torch.float32) * torch.stack(list(self.ws)).sum()


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("budget", [False, True])
def test_weights_swap_while_frames_flow_is_atomic(fuse, budget):
    """Ten weights-only swaps, alternating two sets, while a thread keeps
    pushing frames and the interpreter switches threads every
    microsecond: every frame equals the old set's output or the new
    set's (sums 200 and 400 of x = 1, exact in float32), none is lost,
    and under a budget ``used_bytes`` nets out with one unit left."""
    register_torch_model("cont_many", _Many(1.0))
    n, swaps = 600, 10
    sets = [{f"ws.{i}": torch.full((1,), float(v)) for i in range(200)}
            for v in (2.0, 1.0)]
    switch = sys.getswitchinterval()
    try:
        acct = memory.activate(1 << 20) if budget else None
        pipe = tnt.parse_launch(
            "appsrc name=src ! tensor_filter framework=jax model=cont_many "
            "name=filter ! tensor_sink name=sink",
            pipeline=tnt.Pipeline(fuse=fuse))
        src, sink = pipe.get("src"), pipe.get("sink")
        pipe.start()
        pusher = threading.Thread(target=lambda: [
            src.push([np.ones((4,), np.float32)]) for _ in range(n)],
            daemon=True)
        try:
            src.push([np.ones((4,), np.float32)])
            _wait(lambda: len(sink.buffers) >= 1, what="warmup frame")
            used = acct.used_bytes() if budget else None
            sys.setswitchinterval(1e-6)
            pusher.start()
            for k in range(swaps):
                # a few frames through each weight set, polled finely so
                # that the swaps spread over the stream
                mark, deadline = len(sink.buffers), time.monotonic() + 30
                while len(sink.buffers) < mark + 5:
                    assert time.monotonic() < deadline, f"swap {k}"
                    time.sleep(0.0005)
                pipe.swap_model("filter", weights=sets[k % 2])
            sys.setswitchinterval(switch)
            pusher.join(timeout=60)
            assert not pusher.is_alive()
            src.end_of_stream()
            assert pipe.wait(timeout=60).kind == "eos"
            if budget:
                assert acct.used_bytes() == used
                assert len(acct.residency._units) == 1
        finally:
            sys.setswitchinterval(switch)
            pipe.stop()
    finally:
        unregister_torch_model("cont_many")
    got = [float(np.asarray(b[0])[0]) for b in sink.buffers]
    assert len(got) == n + 1
    assert set(got) <= {200.0, 400.0}, sorted(set(got) - {200.0, 400.0})
    # each swap showed in the frames after it, before the next swap
    changes = sum(a != b for a, b in zip(got, got[1:]))
    assert changes == swaps, changes


def test_a_waiting_swap_goes_ahead_of_the_next_dispatch():
    """A stream that holds the GIL through each dispatch and takes the
    dispatch lock back at once (a plain ``RLock`` let it run thousands
    of dispatches while a writer waited): each writer gets the lock
    before the next dispatch starts. A dispatch nested in a writer's
    scope on its own thread does not wait for itself."""
    from nnstreamer_tpu_torch.filters.torch_backend import DispatchLock

    lock, stop, count = DispatchLock(), threading.Event(), [0]

    def stream():
        while not stop.is_set():
            with lock.dispatch():
                count[0] += 1
                t = time.perf_counter()
                while time.perf_counter() - t < 0.001:
                    pass  # the GIL stays with this thread

    th = threading.Thread(target=stream, daemon=True)
    th.start()
    try:
        _wait(lambda: count[0] > 5, what="dispatches")
        worst = 0
        for _ in range(20):
            c0 = count[0]
            with lock:
                worst = max(worst, count[0] - c0)
                with lock.dispatch():
                    pass
            time.sleep(0.002)
    finally:
        stop.set()
        th.join(timeout=10)
    assert not th.is_alive() and worst <= 1, worst


def _labels_with_weights_swap(pkg, model, new_weights):
    desc = ("appsrc name=src ! tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! "
            f"tensor_filter framework=jax model={model} name=filter "
            "is-updatable=true ! tensor_decoder mode=image_labeling ! "
            "tensor_sink name=sink")
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)
              for _ in range(8)]
    pipe = pkg.parse_launch(desc)
    src, sink = pipe.get("src"), pipe.get("sink")
    pipe.start()
    try:
        for f in frames[:4]:
            src.push([f])
        _wait(lambda: len(sink.buffers) >= 4, what="pre-cutover frames")
        report = pipe.swap_model("filter", weights=new_weights)
        for f in frames[4:]:
            src.push([f])
        src.end_of_stream()
        assert pipe.wait(timeout=60).kind == "eos"
    finally:
        pipe.stop()
    return [b.meta["label"] for b in sink.buffers], report


def test_weights_only_swap_gives_the_jax_labels():
    """A MobileNetV2 swapped to other weights mid-stream: the port's
    labels (weights converted from the JAX variables) equal the JAX
    package's on both sides of the cutover, and the port's fused region
    keeps its program (weights copied in place, nothing rebound)."""
    va, vb = (jax_mobilenet_v2(num_classes=10, image_size=32,
                               dtype=jnp.float32, seed=s)
              for s in (31, 32))
    apply_fn, variables_a, in_info, out_info = va
    variables_b = vb[1]
    register_jax_model("cont_mnv2", apply_fn, variables_a, in_info=in_info,
                       out_info=out_info)
    module = MobileNetV2(num_classes=10)
    module.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, variables_a)))
    register_torch_model("cont_mnv2", module.eval(),
                         tnt.TensorsInfo.from_str("3:32:32:1", "float32"),
                         tnt.TensorsInfo.from_str("10:1", "float32"))
    try:
        ref, _ = _labels_with_weights_swap(jnt, "cont_mnv2", variables_b)
        got, report = _labels_with_weights_swap(
            tnt, "cont_mnv2",
            params_from_jax(jax.tree.map(np.asarray, variables_b)))
    finally:
        unregister_jax_model("cont_mnv2")
        unregister_torch_model("cont_mnv2")
    assert got == ref and len(got) == 8
    assert report["rebound"] == 0 and report["invalidations"] == 1
    assert len(set(got[:4]) | set(got[4:])) >= 1


# -- component state round-trips -------------------------------------------------------
def test_p2_quantile_round_trip():
    q = P2Quantile(0.99)
    for i in range(200):
        q.observe(float(i % 37))
    clone = P2Quantile(0.99)
    clone.restore(q.snapshot())
    assert clone.quantile() == q.quantile()
    clone.observe(1000.0)


def test_service_rate_estimator_round_trip():
    est = ServiceRateEstimator()
    for i in range(10):
        est.observe_invoke(0.004)
        est.observe_completion(now=float(i) * 0.01)
    clone = ServiceRateEstimator()
    clone.restore(est.snapshot())
    assert clone.snapshot() == est.snapshot()
    assert clone.service_time_s() == est.service_time_s()


def test_slo_scheduler_round_trip():
    sched = SloScheduler(budget_ms=50.0, name="cont-rt")
    for _ in range(20):
        sched.estimator.observe_invoke(0.004)
        sched.controller.record_completion(0.01)
    clone = SloScheduler(budget_ms=50.0, name="cont-rt2")
    clone.restore_state(sched.checkpoint_state())
    assert clone.estimator.snapshot() == sched.estimator.snapshot()
    got, want = clone.controller.snapshot(), sched.controller.snapshot()
    assert (got["batch_cap"], got["inflight"]) == \
        (want["batch_cap"], want["inflight"])


def test_flight_recorder_round_trip():
    fr = FlightRecorder(dump_dir=None, min_samples=5)
    for seq in range(12):
        t = float(seq)
        fr.span("device", seq, t, t + 0.002)
        fr.span("sink", seq, t + 0.002, t + 0.004, e2e_s=0.004)
    state = fr.checkpoint_state()
    clone = FlightRecorder(dump_dir=None, min_samples=5)
    clone.restore_state(state)
    assert clone.checkpoint_state()["completed"] == state["completed"]
    assert clone.slo_snapshot() == fr.slo_snapshot()


# -- tensor_repo slots ----------------------------------------------------------------
def test_slot_snapshot_restore_round_trip():
    repo = TensorRepo()
    repo.set("slot0", TensorBuffer([np.arange(6, dtype=np.float32)]))
    repo.set("slot1", TensorBuffer([torch.ones((2, 3), dtype=torch.int32)]))
    state = repo.snapshot()
    assert all(isinstance(a, np.ndarray) for v in state.values() for a in v)
    clone = TensorRepo()
    clone.restore(state, device=torch.device("cpu"))
    for slot in ("slot0", "slot1"):
        a = np.asarray(repo.peek(slot).tensors[0])
        b = clone.peek(slot).tensors[0]
        assert isinstance(b, torch.Tensor)
        np.testing.assert_array_equal(a, b.numpy())
    assert clone.get("slot0", consume=True) is not None
    assert clone.peek("slot0") is None


def test_checkpoint_sections_equal_the_jax_packages(swap_models, tmp_path):
    """The same repo loop and the same scheduler observations through
    both packages: the checkpoints' ``repo`` and ``scheduler`` sections
    are equal (arrays bit for bit, floats exactly); ``servers`` is empty
    in both (the pipeline has no query server)."""
    # a pipeline-wide budget attaches the scheduler; with no admission
    # queue it sheds nothing, so every frame reaches the slot
    desc = ("appsrc name=src ! tensor_filter framework=jax model=cont_a "
            "name=f ! tensor_reposink slot=78")
    states = {}
    for name, pkg, repo in (("port", tnt, GLOBAL_REPO),
                            ("jax", jnt, JAX_REPO)):
        # slots other tests of this process left in the global repo are
        # in the checkpoint too: only what this run wrote is compared
        before = set(repo.snapshot())
        pipe = pkg.parse_launch(desc, slo_budget_ms=100.0)
        src = pipe.get("src")
        pipe.start()
        try:
            for f in FRAMES[:6]:
                src.push([f.copy()])
            src.end_of_stream()
            assert pipe.wait(timeout=60).kind == "eos"
            sched = pipe._slo_scheduler
            sched.estimator.restore({"invoke_s": None, "drain_s": None})
            for i in range(20):
                sched.estimator.observe_invoke(0.004 + i * 1e-4)
            path = pipe.checkpoint(str(tmp_path / name))
        finally:
            pipe.stop()
            repo.remove("78")
        with open(path, "rb") as f:
            states[name] = pickle.load(f)
        states[name]["repo"] = {k: v for k, v in states[name]["repo"].items()
                                if k not in before}
    port, ref = states["port"], states["jax"]
    assert port["version"] == ref["version"] == continuity.STATE_VERSION
    assert port["servers"] == {} and ref["servers"] == {}
    assert port["repo"].keys() == ref["repo"].keys() == {"78"}
    for a, b in zip(port["repo"]["78"], ref["repo"]["78"]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(port["repo"]["78"][0], FRAMES[5] + 1.0)
    assert port["scheduler"]["estimator"] == ref["scheduler"]["estimator"]


def test_a_checkpoint_restores_in_a_fresh_process(swap_models, tmp_path):
    code = (
        "import numpy as np, nnstreamer_tpu_torch as tnt\n"
        "from nnstreamer_tpu_torch.elements.repo import GLOBAL_REPO\n"
        "from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer\n"
        "tnt.set_device('cpu')\n"
        "GLOBAL_REPO.set('91', TensorBuffer([np.arange(5, dtype=np.int16),"
        " np.full((2, 2), 0.25, np.float32)]))\n"
        "p = tnt.parse_launch('appsrc ! tensor_sink')\n"
        f"print(p.checkpoint({str(tmp_path)!r}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    pipe = tnt.parse_launch("appsrc ! tensor_sink")
    try:
        applied = pipe.restore(str(tmp_path))
        assert applied["repo_slots"] == 1
        a, b = GLOBAL_REPO.peek("91").tensors
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.arange(5))
        np.testing.assert_array_equal(b.numpy(), np.full((2, 2), 0.25))
    finally:
        GLOBAL_REPO.remove("91")


# -- pipeline checkpoint / restore --------------------------------------------------------
CKPT_DESC = ("videotestsrc num-buffers=8 ! tensor_converter ! "
             "queue slo-budget-ms=100 ! tensor_filter framework=jax "
             "model=cont_a name=f ! tensor_sink name=sink")


def test_stop_writes_state_and_restore_rearms(swap_models, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    pipe = tnt.parse_launch(CKPT_DESC)
    pipe.checkpoint_dir = ckpt
    assert pipe.run(timeout=60).kind == "eos"
    sched_state = pipe._slo_scheduler.checkpoint_state()
    assert os.path.isfile(os.path.join(ckpt, continuity.STATE_FILE))
    pipe2 = tnt.parse_launch(CKPT_DESC)
    pipe2.checkpoint_dir = ckpt
    pipe2.start()
    try:
        assert pipe2._continuity_restored
        assert pipe2._slo_scheduler.checkpoint_state()["estimator"] == \
            sched_state["estimator"]
    finally:
        pipe2.stop()


def test_version_mismatch_refuses(swap_models, tmp_path):
    pipe = tnt.parse_launch(CKPT_DESC)
    pipe.start()
    try:
        pipe.checkpoint(str(tmp_path))
    finally:
        pipe.stop()
    path = os.path.join(str(tmp_path), continuity.STATE_FILE)
    with open(path, "rb") as f:
        state = pickle.load(f)
    state["version"] = 999
    with open(path, "wb") as f:
        pickle.dump(state, f)
    with pytest.raises(ValueError, match="state version"):
        tnt.parse_launch(CKPT_DESC).restore(str(tmp_path))


def test_corrupt_checkpoint_dir_never_fails_teardown(swap_models, tmp_path):
    target = tmp_path / "blocked"
    target.write_text("a file where a directory must go")
    pipe = tnt.parse_launch(CKPT_DESC)
    pipe.checkpoint_dir = str(target)
    assert pipe.run(timeout=60).kind == "eos"


# -- kill switches ------------------------------------------------------------------------
def test_unset_env_writes_nothing(swap_models, tmp_path, monkeypatch):
    monkeypatch.delenv(continuity.CHECKPOINT_ENV, raising=False)
    monkeypatch.delenv(continuity.CACHE_ENV, raising=False)
    monkeypatch.chdir(tmp_path)
    pipe = tnt.parse_launch("videotestsrc num-buffers=4 ! tensor_converter "
                            "! tensor_filter framework=jax model=cont_a ! "
                            "tensor_sink")
    assert pipe.run(timeout=60).kind == "eos"
    assert pipe.checkpoint_dir is None and not pipe._continuity_restored
    assert list(tmp_path.iterdir()) == []


def test_maybe_restore_without_state_file_is_noop(tmp_path):
    pipe = tnt.parse_launch("videotestsrc num-buffers=1 ! tensor_converter "
                            "! tensor_sink")
    pipe.checkpoint_dir = str(tmp_path)
    assert continuity.maybe_restore_env(pipe) is None
    assert not pipe._continuity_restored


@pytest.fixture
def build_dir(monkeypatch):
    """The kernels' build directory and the libraries counted, restored
    after."""
    monkeypatch.setattr(_build, "_override", None)
    monkeypatch.setattr(_build, "_counted", set(_build._counted))


def test_env_arms_checkpoint_and_defaults_the_cache(swap_models, tmp_path,
                                                     monkeypatch, build_dir):
    monkeypatch.setenv(continuity.CHECKPOINT_ENV, str(tmp_path))
    monkeypatch.delenv(continuity.CACHE_ENV, raising=False)
    pipe = tnt.parse_launch("videotestsrc num-buffers=2 ! tensor_converter "
                            "! tensor_filter framework=jax model=cont_a ! "
                            "tensor_sink")
    assert pipe.run(timeout=60).kind == "eos"
    assert os.path.isfile(os.path.join(str(tmp_path), continuity.STATE_FILE))
    want = os.path.join(str(tmp_path), continuity.CACHE_SUBDIR)
    assert continuity.compile_cache_dir() == want
    assert str(_build.build_dir()) == os.path.join(want, "kernels")
    assert jcontinuity.CACHE_SUBDIR != continuity.CACHE_SUBDIR  # no XLA


# -- the kernels' compile cache ----------------------------------------------------------
FAKE_NVCC = (
    "#!{python}\n"
    "import sys\n"
    "out = sys.argv[sys.argv.index('-o') + 1]\n"
    "open(out, 'wb').write(b'not a library')\n")


def test_second_boot_builds_no_kernel(tmp_path, monkeypatch, build_dir):
    """A cold cache builds every kernel (misses); a process armed on the
    same directory finds every library built (hits) and runs no nvcc. A
    stand-in compiler writes the libraries here (no nvcc on the CPU)."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    calls = []
    real_start = _build._start

    def start(name, _nvcc):
        calls.append(name)
        return real_start(name, str(nvcc))

    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_start", start)
    cache = str(tmp_path / "cache")
    assert continuity.enable_compile_cache(cache) == os.path.abspath(cache)
    assert continuity.enable_compile_cache(cache) == os.path.abspath(cache)
    names = _build.sources()
    assert len(names) == 3
    _build._counted.difference_update(names)
    s0 = continuity.cache_stats()
    paths = _build.build_all()
    assert all(str(p).startswith(os.path.join(os.path.abspath(cache),
                                              "kernels")) for p in
               paths.values())
    s1 = continuity.cache_stats()
    assert s1["misses"] - s0["misses"] == 3 and s1["hits"] == s0["hits"]
    assert sorted(calls) == names
    # the "second process": nothing counted yet, the same directory
    _build._counted.difference_update(names)
    calls.clear()
    _build.build_all()
    s2 = continuity.cache_stats()
    assert calls == [] and s2["hits"] - s1["hits"] == 3
    assert s2["misses"] == s1["misses"]


def test_the_environment_names_the_build_dir_until_one_is_set(
        tmp_path, monkeypatch, build_dir):
    monkeypatch.setenv(continuity.CACHE_ENV, str(tmp_path / "env"))
    assert _build.build_dir() == (tmp_path / "env" / "kernels").resolve()
    assert _build.library_path("normalize").parent == _build.build_dir()
    assert continuity.compile_cache_dir() == str((tmp_path / "env").resolve())
    _build.set_build_dir(tmp_path / "chosen")
    assert _build.build_dir() == (tmp_path / "chosen").resolve()
    _build.set_build_dir(None)
    monkeypatch.delenv(continuity.CACHE_ENV)
    assert _build.build_dir() == _build.BUILD_DIR
    assert continuity.compile_cache_dir() is None


def test_manifest_written_with_region_signatures(swap_models, tmp_path,
                                                 build_dir):
    continuity.enable_compile_cache(str(tmp_path / "cache"))
    pipe = tnt.parse_launch(
        "videotestsrc num-buffers=2 ! tensor_converter ! "
        "tensor_transform mode=arithmetic option=typecast:float32 ! "
        "tensor_filter framework=jax model=cont_a name=f ! "
        "tensor_sink name=sink")
    assert pipe.run(timeout=60).kind == "eos"
    path = continuity.write_program_manifest(pipe)
    doc = json.loads(open(path).read())
    sig = doc["programs"][0]
    assert sig["signature"] and len(sig["signature"]) == 16
    assert any(m["model"] == "cont_a" for m in sig["members"])
    # the same members give the JAX package's signature
    assert sig["signature"] == jcontinuity.region_signature(
        pipe._regions[0])["signature"]
