"""Error policies and the watchdog in the PyTorch port
(``pipeline/supervise.py``), held to the JAX package's.

The same seeded faults go through both packages' pipelines:

- ``skip-frame`` delivers the same frame indices as the JAX package and
  loses exactly the fired frames; ``retry`` delivers every frame,
  byte-identical to a clean run; ``halt`` raises ``FlowError``;
- lane workers that crash restart under supervision, as in the JAX
  package;
- ``degrade`` reloads a failing backend, then reopens it on the CPU; a
  memory-pressure failure under ``degrade`` halts naming ROADMAP A.19;
- the watchdog trips on a stall, and teardown does not wait out the stall;
- on the card (``gpu`` tests) a retried window replays the region's one
  captured graph.
"""

import itertools
import threading
import time

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.elements.sink import TensorSink as JaxSink
from nnstreamer_tpu.pipeline import element as jelement
from nnstreamer_tpu.pipeline import faults as jfaults
from nnstreamer_tpu.pipeline import pipeline as jpipeline
from nnstreamer_tpu.pipeline import supervise as jsupervise
from nnstreamer_tpu.tensors.buffer import TensorBuffer as JaxBuffer
from nnstreamer_tpu.tensors.types import TensorsConfig as JaxConfig
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.obs import timeline as _timeline
from nnstreamer_tpu_torch.pipeline import element
from nnstreamer_tpu_torch.pipeline import faults
from nnstreamer_tpu_torch.pipeline import pipeline as tpipeline
from nnstreamer_tpu_torch.pipeline import supervise
from nnstreamer_tpu_torch.pipeline.element import FlowError
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensors.types import TensorsConfig

PKGS = {
    "jax": dict(el=jelement, pipe=jpipeline, faults=jfaults, sink=JaxSink,
                buf=JaxBuffer, cfg=JaxConfig),
    "port": dict(el=element, pipe=tpipeline, faults=faults, sink=TensorSink,
                 buf=TensorBuffer, cfg=TensorsConfig),
}


@pytest.fixture(autouse=True)
def _no_active_injector():
    faults.deactivate()
    jfaults.deactivate()
    yield
    faults.deactivate()
    jfaults.deactivate()


def _cval(name, **labels):
    m = get_registry().get(name, **labels)
    return 0.0 if m is None else m.value


def _degraded(el):
    return _cval("nns_fault_degraded_total", **el._obs_labels())


def _classes(pkg):
    """The JAX test's index source and hooked transform, on ``pkg``'s
    element base classes."""
    m = PKGS[pkg]

    class SeqSrc(m["pipe"].SourceElement):
        ELEMENT_NAME = "_supseqsrc"
        REORDER_SAFE = True
        PROPERTIES = {**m["pipe"].SourceElement.PROPERTIES,
                      "num_buffers": 16}

        def __init__(self, name=None, **props):
            super().__init__(name, **props)
            self.i = 0

        def negotiate(self):
            cfg = m["cfg"].from_arrays([np.zeros((4,), np.float32)])
            self.srcpad.set_caps(cfg.to_caps())

        def create(self):
            if self.i >= self.get_property("num_buffers"):
                return None
            self.i += 1
            return m["buf"]([np.full((4,), float(self.i), np.float32)],
                            pts=self.i * 1000)

    class Hook(m["el"].Element):
        """x*2+1 behind the filter.invoke fault hook."""

        ELEMENT_NAME = "_suphook"
        REORDER_SAFE = True

        def __init__(self, name=None, **props):
            super().__init__(name, **props)
            self.add_sink_pad("sink")
            self.add_src_pad("src")

        def chain(self, pad, buf):
            fi = m["faults"].ACTIVE
            if fi is not None:
                fi.check("filter.invoke")
            self.srcpad.push(buf.with_tensors(
                [np.asarray(t) * 2.0 + 1.0 for t in buf.tensors]))
            return m["el"].FlowReturn.OK

    return SeqSrc, Hook


_ids = itertools.count()


def _build(pkg, name, n=20, hook_props=None, **pipe_kw):
    """SeqSrc(n) ! Hook ! tensor_sink in ``pkg``, under a pipeline name of
    its own (the metric labels), and the list the sink appends to."""
    SeqSrc, Hook = _classes(pkg)
    m = PKGS[pkg]
    pipe = m["pipe"].Pipeline(name=f"{name}-{pkg}-{next(_ids)}", fuse=False,
                              **pipe_kw)
    sink = m["sink"](name="out")
    pipe.add_linked(SeqSrc(num_buffers=n), Hook(name="hook",
                                                **(hook_props or {})), sink)
    outs = []
    sink.connect(lambda b: outs.append(float(np.asarray(b.tensors[0])[0])))
    return pipe, outs


def _hook_count(pipe, name):
    """A hook counter of ``pipe``: the element's own, or summed over its
    lane clones (``hook~lK``), which run the chain when lanes are on."""
    labels = pipe.get("hook")._obs_labels()
    if not pipe._lane_execs:
        return _cval(name, **labels)
    n = pipe._lane_execs[0].n
    return sum(_cval(name, pipeline=labels["pipeline"],
                     element=f"hook~l{k}") for k in range(n))


def _run_both(spec, seed=0, n=20, **kw):
    """The same spec through both packages: (fired sets, deliveries)."""
    got = {}
    for pkg in ("jax", "port"):
        inj = PKGS[pkg]["faults"].activate(spec, seed=seed)
        pipe, outs = _build(pkg, "sup", n=n, **kw)
        msg = pipe.run(timeout=60)
        assert msg is not None and msg.kind == "eos"
        got[pkg] = (inj.fired_set("filter.invoke"), outs, pipe)
        PKGS[pkg]["faults"].deactivate()
    return got


# -- skip-frame, retry, halt ---------------------------------------------------
@pytest.mark.parametrize("spec,seed", [
    ("filter.invoke:rate=0.2", 7), ("filter.invoke:every=3", 0),
    ("filter.invoke:nth=1", 0), ("filter.invoke:rate=0.5,kind=crash", 2),
])
@pytest.mark.parametrize("lanes", [1, 4])
def test_skip_frame_delivers_the_jax_frames(spec, seed, lanes):
    got = _run_both(spec, seed, error_policy="skip-frame", lanes=lanes)
    (jfired, jouts, _), (fired, outs, pipe) = got["jax"], got["port"]
    assert fired == jfired and fired
    if lanes == 1:
        assert outs == jouts
        assert outs == [i * 2.0 + 1.0 for i in range(1, 21)
                        if i not in fired]
    else:
        # lane workers count occurrences in whatever order they run, in
        # both packages: which frames die varies, how many does not
        assert len(outs) == len(jouts) == 20 - len(fired)
        assert outs == sorted(outs)
    assert _hook_count(pipe, "nns_fault_skipped_frames_total") == len(fired)


@pytest.mark.parametrize("spec,seed", [
    ("filter.invoke:rate=0.2", 7), ("filter.invoke:every=2", 0),
])
@pytest.mark.parametrize("lanes", [1, 4])
def test_retry_delivers_every_frame(spec, seed, lanes):
    got = _run_both(spec, seed, error_policy="retry", lanes=lanes,
                    hook_props={"retry_backoff_ms": 1.0})
    (jfired, jouts, _), (fired, outs, pipe) = got["jax"], got["port"]
    assert outs == jouts == [i * 2.0 + 1.0 for i in range(1, 21)]
    assert fired == jfired and fired
    assert _hook_count(pipe, "nns_fault_recovered_total") >= 1
    if lanes == 1:
        # every failure (a retry's too) is retried once; with lanes a
        # clone that exhausts its retries hands the frame to the lane's
        # own restart-and-replay, counted on the executor
        assert _hook_count(pipe, "nns_fault_retries_total") == len(fired)


def test_exhausted_retries_halt():
    faults.activate("filter.invoke:every=1")
    pipe, _ = _build("port", "sup-exhaust", n=4, error_policy="retry",
                     hook_props={"retry_max": 2, "retry_backoff_ms": 1.0})
    with pytest.raises(FlowError, match="retry exhausted after 2"):
        pipe.run(timeout=30)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_halt_is_the_default(pkg):
    PKGS[pkg]["faults"].activate("filter.invoke:nth=3")
    pipe, outs = _build(pkg, "sup-halt", n=6)
    with pytest.raises(PKGS[pkg]["el"].FlowError, match="injected fault"):
        pipe.run(timeout=30)
    assert outs == [3.0, 5.0]


def test_element_policy_overrides_the_pipeline_default():
    faults.activate("filter.invoke:nth=2")
    pipe, outs = _build("port", "sup-override", n=6,
                        hook_props={"error_policy": "skip_frame"})
    assert pipe.run(timeout=30).kind == "eos"
    assert outs == [3.0, 7.0, 9.0, 11.0, 13.0]


def test_unknown_policy_is_a_flow_error():
    faults.activate("filter.invoke:nth=1")
    pipe, _ = _build("port", "sup-bad", n=2,
                     hook_props={"error_policy": "bogus"})
    with pytest.raises(FlowError, match="unknown error-policy 'bogus'"):
        pipe.run(timeout=30)


def test_properties_parse_from_a_launch_string():
    pipe = tnt.parse_launch(
        "videotestsrc num-buffers=1 ! queue error-policy=retry retry-max=5 "
        "retry-backoff-ms=2.5 name=q ! tensor_sink", error_policy="halt",
        watchdog_s=3, lanes=2)
    q = pipe.get("q")
    assert q.get_property("error-policy") == "retry"
    assert q.get_property("retry-max") == 5
    assert q.get_property("retry-backoff-ms") == 2.5
    assert (pipe.error_policy, pipe.watchdog_s, pipe.lanes) == \
        ("halt", 3.0, 2)


def test_backoff_is_the_jax_schedule(monkeypatch):
    slept = []
    # both modules' ``time`` is the one module: one patch records both
    monkeypatch.setattr(supervise.time, "sleep", slept.append)

    class El:
        name = "filter"

    for attempt in range(1, 12):
        jsupervise._backoff_sleep(El, attempt, 5.0)
        supervise._backoff_sleep(El, attempt, 5.0)
    assert slept[1::2] == slept[0::2] and max(slept) <= 1.0


def test_list_failure_replays_only_the_undelivered_suffix():
    """A chain_list that fails part-way, in both packages: the buffers
    before the failing one are not delivered twice, and the rest, the
    failing one first, are re-chained one by one with the policy per
    frame. The failing buffer's second chain succeeds (the fault was
    transient), so even skip-frame loses nothing (ROADMAP C.13)."""
    for pkg in ("jax", "port"):
        m = PKGS[pkg]
        got = []

        class Collect(m["el"].Element):
            ELEMENT_NAME = f"_supcollect_{pkg}"
            HANDLES_LIST = True

            def __init__(self, name=None, **props):
                super().__init__(name, **props)
                self.add_sink_pad("sink")

            def chain(self, pad, buf):
                m["faults"].ACTIVE.check("filter.invoke")
                got.append(float(np.asarray(buf.tensors[0])[0]))

        col = Collect(error_policy="skip-frame")
        col.pipeline = None
        bufs = [m["buf"]([np.full((2,), float(i), np.float32)])
                for i in range(6)]
        # the first buffer failing (marker 0) is the same case
        m["faults"].activate("filter.invoke:nth=1")
        col._chain_list_entry(col.sinkpads[0], bufs[:3])
        assert got == [0.0, 1.0, 2.0], pkg
        got.clear()
        m["faults"].activate("filter.invoke:nth=3")
        col._chain_list_entry(col.sinkpads[0], bufs)
        # frames 0 and 1 were delivered once; frame 2 failed and was
        # chained again, then 3-5 one by one
        assert got == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0], pkg
        m["faults"].deactivate()


def _uncut_small(model, labels, n):
    """bench.py's uncut string at a small size: lanes come from the
    caller, a stamp-admission ingress (blocking, so every frame reaches
    the aggregator), batch 8, the staging queue's list hand-off into the
    filter (fused region or plain), a materialize-host drain. The staging
    queue holds every window of the run."""
    return (f"videotestsrc num-buffers={n} width=16 height=16 "
            "pattern=ball ! tensor_converter ! "
            "queue name=q_ingress max-size-buffers=16 stamp-admission=true ! "
            "tensor_aggregator frames-in=1 frames-out=8 frames-flush=8 "
            "frames-dim=3 concat=true ! "
            "queue name=q_stage max-size-buffers=64 prefetch-device=true ! "
            "tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! "
            f"tensor_filter framework=jax model={model} inflight=2 ! "
            f"tensor_decoder mode=image_labeling option1={labels} "
            "option2=batched ! queue max-size-buffers=64 "
            "materialize-host=true ! tensor_sink name=out")


_FAULT_COUNTERS = ("nns_fault_retries_total", "nns_fault_skipped_frames_total")


def _gate_staging_queue(monkeypatch, pipeline_mod, windows):
    """Hold ``q_stage``'s worker until all ``windows`` and the EOS are
    queued, so it hands them on as ONE list in both packages: which
    windows a fault meets in a list and which alone is then no longer up
    to the threads' timing."""
    drain = pipeline_mod.Queue._drain

    def gated(self):
        if self.name == "q_stage":
            t_end = time.monotonic() + 60
            while self._q.qsize() < windows + 1 and \
                    not self._stop_evt.is_set() and time.monotonic() < t_end:
                time.sleep(0.001)
        return drain(self)

    monkeypatch.setattr(pipeline_mod.Queue, "_drain", gated)


def _counter_sum(reg, name, **labels):
    return sum(m.value for m in reg.collect()
               if m.name == name and all(m.labels.get(k) == v
                                         for k, v in labels.items()))


@pytest.fixture
def scores_models(tmp_path):
    """The same 4-class scorer in both packages: a frame's mean times
    1, 2, 3, 4."""
    from nnstreamer_tpu.filters.jax_backend import (
        register_jax_model,
        unregister_jax_model,
    )

    class Scores(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("w", torch.arange(1.0, 5.0)[None])

        def forward(self, x):
            return x.float().mean(dim=(1, 2, 3))[:, None] * self.w

    w = np.arange(1.0, 5.0, dtype=np.float32)[None]

    def jax_scores(x):
        return x.astype("float32").mean(axis=(1, 2, 3))[:, None] * w

    register_jax_model("sup_scores", jax_scores)
    register_torch_model("sup_scores", Scores())
    tnt.set_device("cpu")
    labels = tmp_path / "labels.txt"
    labels.write_text("".join(f"l{i}\n" for i in range(4)))
    yield "sup_scores", str(labels)
    tnt.set_device(None)
    unregister_jax_model("sup_scores")
    unregister_torch_model("sup_scores")


@pytest.mark.parametrize("policy", ["skip-frame", "retry"])
@pytest.mark.parametrize("fuse", [True, False])
def test_uncut_string_under_faults_delivers_the_jax_frames(
        scores_models, monkeypatch, policy, fuse):
    """The uncut string (lanes 4) with ``filter.invoke:every=13`` in both
    packages: the same windows (pts and bytes) reach the sink, with the
    same injected, retried and skipped counts. A failed list re-chains
    its failing window once before the policy acts (ROADMAP C.13)."""
    from nnstreamer_tpu.obs import get_registry as jget_registry

    model, labels = scores_models
    got = {}
    for pkg, reg in (("jax", jget_registry()), ("port", get_registry())):
        m = PKGS[pkg]
        _gate_staging_queue(monkeypatch, m["pipe"], 25)
        name = f"sup-uncut-{policy}-{fuse}-{pkg}-{next(_ids)}"
        inj0 = _counter_sum(reg, "nns_fault_injected_total",
                            site="filter.invoke")
        m["faults"].activate("filter.invoke:every=13")
        mod = jnt if pkg == "jax" else tnt
        pipe = mod.parse_launch(
            _uncut_small(model, labels, 200), lanes=4, error_policy=policy,
            pipeline=m["pipe"].Pipeline(name=name, fuse=fuse))
        outs = []
        pipe.get("out").connect(lambda b: outs.append(
            (b.pts, b"".join(np.asarray(t).tobytes() for t in b.tensors),
             tuple(b.meta["label"]))))
        assert pipe.run(timeout=120).kind == "eos"
        m["faults"].deactivate()
        counts = {c: _counter_sum(reg, c, pipeline=name)
                  for c in _FAULT_COUNTERS}
        counts["injected"] = _counter_sum(
            reg, "nns_fault_injected_total", site="filter.invoke") - inj0
        got[pkg] = (outs, counts)
    (outs, counts), (ref, ref_counts) = got["port"], got["jax"]
    assert counts == ref_counts
    assert [o[0] for o in outs] == [r[0] for r in ref]
    assert [o[2] for o in outs] == [r[2] for r in ref]
    assert [o[1] for o in outs] == [r[1] for r in ref]
    # fused, the region takes the list: window 13 failed inside it and
    # was re-chained, and window 25 (the 26th invoke) failed alone in the
    # per-window replay and met the policy. Unfused, every window meets
    # the filter alone and the policy answers the 13th invoke. Either
    # way skip-frame drops one window and retry delivers all 25.
    assert counts["injected"] == (1 if not fuse and policy == "skip-frame"
                                  else 2)
    assert len(outs) == (24 if policy == "skip-frame" else 25)


# -- lanes under supervision ----------------------------------------------------
@pytest.mark.parametrize("policy,delivered", [("retry", 20),
                                               ("skip-frame", 19)])
def test_crashed_lane_worker_restarts(policy, delivered):
    for pkg in ("jax", "port"):
        inj = PKGS[pkg]["faults"].activate("lane.worker:nth=5,kind=crash")
        pipe, outs = _build(pkg, f"sup-lane-{policy}", lanes=4,
                            error_policy=policy)
        assert pipe.run(timeout=60).kind == "eos"
        assert inj.injected("lane.worker") == 1
        assert len(outs) == delivered and outs == sorted(outs)
        ex = pipe._lane_execs[0]
        assert ex._delivered == ex._seq
        PKGS[pkg]["faults"].deactivate()


def test_crashed_lane_worker_halts_by_default():
    faults.activate("lane.worker:nth=5,kind=crash")
    pipe, _ = _build("port", "sup-lane-halt", lanes=4)
    with pytest.raises(FlowError, match="injected fault at lane.worker"):
        pipe.run(timeout=60)


# -- degrade ---------------------------------------------------------------------
class _Double(torch.nn.Module):
    def forward(self, x):
        return x.float() * 2.0


@pytest.fixture
def cpu_model():
    tnt.set_device("cpu")
    register_torch_model("sup_double", _Double())
    yield "sup_double"
    unregister_torch_model("sup_double")
    tnt.set_device(None)


DEGRADE = ("videotestsrc num-buffers=6 width=4 height=4 ! tensor_converter ! "
           "tensor_filter framework=jax model={m} name=filter ! "
           "queue materialize-host=true ! tensor_sink name=out")


@pytest.mark.parametrize("fuse", [False, True])
def test_degrade_reloads_the_backend(cpu_model, fuse):
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

    faults.activate("filter.invoke:nth=3")
    pipe = tnt.parse_launch(DEGRADE.format(m=cpu_model),
                            pipeline=Pipeline(fuse=fuse),
                            error_policy="degrade")
    d0 = _degraded(pipe.get("filter"))
    outs = []
    pipe.get("out").connect(lambda b: outs.append(b))
    assert pipe.run(timeout=60).kind == "eos"
    assert len(outs) == 6
    if not fuse:
        el = pipe.get("filter")
        assert _degraded(el) - d0 == 1
        # the reload rung recovered: the CPU rung never ran
        assert el.get_property("accelerator") is None


def test_degrade_reopens_on_the_cpu(cpu_model, monkeypatch):
    """A backend that fails again after its reload is reopened with
    accelerator=true:cpu, the ladder's second rung."""
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    opened = []
    real_open = TensorFilter._open_fw

    def open_fw(self):
        opened.append(self.get_property("accelerator"))
        return real_open(self)

    monkeypatch.setattr(TensorFilter, "_open_fw", open_fw)
    faults.activate("filter.invoke:nth=3;transfer.h2d:nth=999")
    fi = faults.ACTIVE
    calls = {"n": 0}
    real_check = fi.check

    def check(site, seq=None):
        # the reload's retry fails too (occurrence 4), the CPU rung's
        # passes
        if site == "filter.invoke":
            calls["n"] += 1
            if calls["n"] == 4:
                raise faults.InjectedFault(site, 4)
        return real_check(site, seq)

    fi.check = check
    pipe = tnt.parse_launch(DEGRADE.format(m=cpu_model),
                            pipeline=tpipeline.Pipeline(fuse=False),
                            error_policy="degrade")
    d0 = _degraded(pipe.get("filter"))
    outs = []
    pipe.get("out").connect(lambda b: outs.append(b))
    assert pipe.run(timeout=60).kind == "eos"
    el = pipe.get("filter")
    assert len(outs) == 6 and el.get_property("accelerator") == "true:cpu"
    assert _degraded(el) - d0 == 2
    assert opened[-1] == "true:cpu"


@pytest.mark.parametrize("how,fuse", [("injected", False), ("injected", True),
                                      ("torch", False), ("exhausted", False)])
def test_degrade_climbs_the_pressure_ladder(cpu_model, how, fuse,
                                            monkeypatch):
    """Memory pressure under ``degrade`` (an injected ``kind=oom``, or a
    ``torch.cuda.OutOfMemoryError``) takes the ladder: the ``evict`` rung
    drops the weights to host staging, the retry loads them back and the
    frame goes through. No frame is lost (ROADMAP C.12, closed). When
    every retry fails too (``exhausted``) the ladder halts after
    ``shed``, each rung counted once, and the filter is never reopened on
    the CPU: the port has no ``cpu`` rung (ROADMAP C.29)."""
    from nnstreamer_tpu_torch.filters.torch_backend import TorchFilter
    from nnstreamer_tpu_torch.tensors import memory

    base = tnt.parse_launch(DEGRADE.format(m=cpu_model),
                            pipeline=tpipeline.Pipeline(fuse=fuse))
    want = []
    base.get("out").connect(lambda b: want.append(np.asarray(b[0])))
    assert base.run(timeout=60).kind == "eos"
    if how == "injected":
        faults.activate("filter.invoke:nth=2,kind=oom")
    else:
        real, calls = TorchFilter.invoke, itertools.count(1)

        def oom(self, inputs):
            n = next(calls)
            if n == 2 or (how == "exhausted" and n > 2):
                raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried")
            return real(self, inputs)

        monkeypatch.setattr(TorchFilter, "invoke", oom)
    acct = memory.activate(1 << 30)
    try:
        rungs0 = {r: _cval("nns_mem_pressure_events_total", rung=r)
                  for r in ("evict", "pool", "shed", "cpu")}
        pipe = tnt.parse_launch(DEGRADE.format(m=cpu_model),
                                pipeline=tpipeline.Pipeline(fuse=fuse),
                                error_policy="degrade")
        got = []
        pipe.get("out").connect(lambda b: got.append(np.asarray(b[0])))
        if how == "exhausted":
            with pytest.raises(FlowError,
                               match="evict → pool → shed all failed"):
                pipe.run(timeout=60)
        else:
            assert pipe.run(timeout=60).kind == "eos"
        taken = {r: _cval("nns_mem_pressure_events_total", rung=r) - v
                 for r, v in rungs0.items()}
        assert taken == ({"evict": 1, "pool": 1, "shed": 1, "cpu": 0}
                         if how == "exhausted" else
                         {"evict": 1, "pool": 0, "shed": 0, "cpu": 0})
        assert acct.snapshot()["evictions"] >= 1
        assert pipe.get("filter").get_property("accelerator") is None
    finally:
        memory.deactivate()
    if how == "exhausted":
        # the halt may stop the queue before it hands on the first frame
        assert len(got) <= 1
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        return
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_non_filter_degrade_is_retry():
    faults.activate("filter.invoke:nth=2")
    pipe, outs = _build("port", "sup-degrade-nonfilter", n=6,
                        error_policy="degrade",
                        hook_props={"retry_backoff_ms": 1.0})
    assert pipe.run(timeout=30).kind == "eos"
    assert len(outs) == 6


# -- watchdog --------------------------------------------------------------------
@pytest.mark.parametrize("site", ["filter.invoke", "queue.push"])
def test_watchdog_trips_on_a_stall(site):
    before = set(threading.enumerate())
    pipe, _ = _build("port", f"sup-wd-{site}", n=6, watchdog_s=0.4)
    if site == "queue.push":
        from nnstreamer_tpu_torch.pipeline.pipeline import Queue

        # a queue between the hook and the sink
        q = Queue(name="q")
        hook, sink = pipe.get("hook"), pipe.get("out")
        hook.srcpad.unlink()
        pipe.add(q)
        hook.link(q)
        q.link(sink)
    faults.activate(f"{site}:nth=2,kind=stall,ms=20000")
    trips0 = _cval("nns_fault_watchdog_trips_total", pipeline=pipe.name)
    t0 = time.monotonic()
    with pytest.raises(FlowError, match="watchdog: no pipeline progress"):
        pipe.run(timeout=30)
    # detected and torn down well inside the 20 s stall
    assert time.monotonic() - t0 < 5.0
    assert _cval("nns_fault_watchdog_trips_total",
                 pipeline=pipe.name) == trips0 + 1
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and [
            t for t in threading.enumerate()
            if t not in before and t.is_alive()]:
        time.sleep(0.05)
    assert not [t for t in threading.enumerate()
                if t not in before and t.is_alive()]


def test_quiescent_pipeline_never_trips():
    pipe, outs = _build("port", "sup-wd-idle", n=4, watchdog_s=0.2)
    pipe.start()
    msg = pipe.wait(timeout=10)
    assert msg is not None and msg.kind == "eos"
    time.sleep(0.8)
    pipe.stop()
    assert len(outs) == 4
    assert _cval("nns_fault_watchdog_trips_total", pipeline=pipe.name) == 0


def test_watchdog_env_and_default_off(monkeypatch):
    monkeypatch.setenv("NNSTPU_WATCHDOG_S", "5.0")
    pipe, _ = _build("port", "sup-wd-env", n=2)
    pipe.start()
    try:
        assert pipe._watchdog is not None and \
            pipe._watchdog.deadline_s == 5.0
    finally:
        pipe.stop()
    assert pipe._watchdog is None
    monkeypatch.delenv("NNSTPU_WATCHDOG_S")
    pipe, _ = _build("port", "sup-wd-off", n=2)
    pipe.start()
    try:
        assert pipe._watchdog is None
        assert not any("watchdog" in t.name for t in threading.enumerate())
    finally:
        pipe.stop()


def test_witnesses_agree():
    """The injector's log, the counters and the ledger's marks count the
    same faults."""
    with _timeline.tracing() as tl:
        inj = faults.activate("filter.invoke:rate=0.3", seed=3)
        pipe, _ = _build("port", "sup-witness", error_policy="skip-frame")
        assert pipe.run(timeout=30).kind == "eos"
    n = inj.injected("filter.invoke")
    assert n > 0
    kinds = [r[1] for r in tl._snapshot() if r[5] == "faults"]
    assert kinds.count("fault") == kinds.count("fault_skip") == n


# -- on the card --------------------------------------------------------------------
@pytest.mark.gpu
def test_retry_under_capture_replays_the_one_graph(tmp_path):
    """filter.invoke faults at the fused region, retried: every window is
    delivered bit-identical to the clean run, the region captured once,
    and B1 ran once a window (the fault fires before any replay work)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the region captures a CUDA graph")
    from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2
    from nnstreamer_tpu_torch.ops import _counts

    labels = tmp_path / "labels.txt"
    labels.write_text("".join(f"l{i}\n" for i in range(10)))
    tnt.set_device(None)
    register_torch_model("sup_gpu", MobileNetV2(num_classes=10).eval())
    desc = ("videotestsrc num-buffers=80 width=32 height=32 pattern=ball ! "
            "tensor_converter ! queue max-size-buffers=16 ! "
            "tensor_aggregator frames-in=1 frames-out=8 frames-flush=8 "
            "frames-dim=3 concat=true ! "
            "queue max-size-buffers=8 prefetch-device=true ! "
            "tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! "
            "tensor_filter framework=jax model=sup_gpu inflight=2 ! "
            f"tensor_decoder mode=image_labeling option1={labels} "
            "option2=batched ! queue max-size-buffers=64 "
            "materialize-host=true ! tensor_sink name=out")
    runs = {}
    try:
        for key, spec in (("clean", None),
                          ("retry", "filter.invoke:every=3")):
            if spec:
                faults.activate(spec)
            _counts.reset_launches()
            pipe = tnt.parse_launch(desc, lanes=4, error_policy="retry")
            metas = []
            pipe.get("out").connect(lambda b: metas.append(b.meta))
            assert pipe.run(timeout=300).kind == "eos"
            (region,) = pipe.metrics_snapshot()["regions"].values()
            assert region["captures"] == 1 and not region["unspliced"]
            assert _counts.LAUNCHES["normalize_chain"] == 10
            runs[key] = [(lab, i, np.float32(s).tobytes())
                         for m in metas for lab, i, s in zip(
                             m["label"], m["label_index"], m["score"])]
            faults.deactivate()
    finally:
        unregister_torch_model("sup_gpu")
    assert len(runs["clean"]) == 80 and runs["retry"] == runs["clean"]
