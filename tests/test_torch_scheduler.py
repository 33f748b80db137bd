"""The SLO scheduler in the PyTorch port (``serving/scheduler.py`` and the
queue's scheduler mode), held to the JAX package's.

The cases of ``tests/test_scheduler.py`` run on both packages, and the
port must decide as the JAX package does:

- the estimator, the AIMD controller and admission give the same answers
  for the same explicit-``now`` call sequences (decisions are exact;
  floats within 1e-12);
- the EDF queue delivers the same pts and sheds by the same reasons in a
  deterministic paused-downstream scenario;
- budget unset builds no scheduler, and an unloaded budget is
  byte-identical to FIFO;
- on the card the filter's invoke times only the enqueue, so the
  completion spacing must govern: enqueue-only observations never make
  the door admit more than the sink's spacing allows;
- the engine's request path raises ``SloRejected`` under the same
  injected estimates in both packages.
"""

import threading
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.obs import get_registry as jget_registry
from nnstreamer_tpu.pipeline import element as jelement
from nnstreamer_tpu.pipeline import pipeline as jpipeline
from nnstreamer_tpu.serving import scheduler as jscheduler
from nnstreamer_tpu.tensors.buffer import TensorBuffer as JaxBuffer
from nnstreamer_tpu.tensors.types import TensorsConfig as JaxConfig
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.pipeline import element
from nnstreamer_tpu_torch.pipeline import pipeline as tpipeline
from nnstreamer_tpu_torch.serving import scheduler
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensors.types import TensorsConfig

PKGS = {
    "jax": dict(el=jelement, pipe=jpipeline, sched=jscheduler,
                buf=JaxBuffer, cfg=JaxConfig, reg=jget_registry),
    "port": dict(el=element, pipe=tpipeline, sched=scheduler,
                 buf=TensorBuffer, cfg=TensorsConfig, reg=get_registry),
}
BOTH = pytest.mark.parametrize("pkg", ["jax", "port"])


def _buf(pkg, i, deadline_t=None):
    buf = PKGS[pkg]["buf"]([np.array([float(i)], np.float32)], pts=i * 1000)
    if deadline_t is not None:
        buf.meta["deadline_t"] = deadline_t
    return buf


def _classes(pkg):
    """The JAX test's source, gate and collector on ``pkg``'s bases."""
    m = PKGS[pkg]

    class NumSrc(m["pipe"].SourceElement):
        ELEMENT_NAME = "_tsched_numsrc"
        PROPERTIES = {**m["pipe"].SourceElement.PROPERTIES,
                      "num_buffers": 5}

        def __init__(self, name=None, **props):
            super().__init__(name, **props)
            self.i = 0

        def negotiate(self):
            cfg = m["cfg"].from_arrays([np.zeros((1,), np.float32)])
            self.srcpad.set_caps(cfg.to_caps())

        def create(self):
            if self.i >= self.get_property("num_buffers"):
                return None
            buf = _buf(pkg, self.i)
            self.i += 1
            return buf

    class Gate(m["el"].Element):
        """Parks the queue worker inside chain() until released."""

        ELEMENT_NAME = "_tsched_gate"
        PROPERTIES = {}

        def __init__(self, name=None, **props):
            super().__init__(name, **props)
            self.add_sink_pad("sink")
            self.add_src_pad("src")
            self.entered = threading.Event()
            self.release = threading.Event()

        def chain(self, pad, buf):
            self.entered.set()
            assert self.release.wait(timeout=10)
            return self.srcpads[0].push(buf)

    class Collect(m["el"].Element):
        ELEMENT_NAME = "_tsched_collect"
        PROPERTIES = {}

        def __init__(self, name=None, **props):
            super().__init__(name, **props)
            self.add_sink_pad("sink")
            self.buffers = []
            self.got_eos = False

        def chain(self, pad, buf):
            self.buffers.append(buf)
            return m["el"].FlowReturn.OK

        def sink_event(self, pad, event):
            if isinstance(event, m["el"].EosEvent):
                self.got_eos = True

    return NumSrc, Gate, Collect


# -- estimator / controller / admission units -----------------------------------
@BOTH
def test_cold_estimator_admits_all(pkg):
    est = PKGS[pkg]["sched"].ServiceRateEstimator()
    assert est.service_time_s() == 0.0
    assert est.service_fps() == 0.0


@BOTH
def test_slower_witness_governs(pkg):
    est = PKGS[pkg]["sched"].ServiceRateEstimator()
    est.observe_invoke(0.010)
    est.observe_completion(100.0)
    est.observe_completion(100.05)
    assert est.service_time_s() == pytest.approx(0.05)


@BOTH
def test_stall_gap_excluded(pkg):
    est = PKGS[pkg]["sched"].ServiceRateEstimator()
    est.observe_completion(10.0)
    est.observe_completion(20.0)
    assert est.service_time_s() == 0.0
    est.observe_completion(20.02)
    assert est.service_time_s() == pytest.approx(0.02)


@BOTH
def test_rejects_unmeetable_deadline(pkg):
    sched = PKGS[pkg]["sched"].SloScheduler(budget_ms=50)
    sched.observe_service(0.1)
    ok, _dl, slack = sched.decide(now=10.0, backlog=0)
    assert not ok and slack < 0
    ok, _dl, slack5 = sched.decide(now=10.0, backlog=5)
    assert not ok and slack5 < slack


@BOTH
def test_admits_with_headroom_and_stamps(pkg):
    sched = PKGS[pkg]["sched"].SloScheduler(budget_ms=500)
    sched.observe_service(0.01)
    buf = _buf(pkg, 0)
    assert sched.admit(buf, now=10.0, backlog=3)
    assert buf.meta["admitted_t"] == 10.0
    assert buf.meta["deadline_t"] == pytest.approx(10.5)


@BOTH
def test_request_path_raises_slo_rejected(pkg):
    mod = PKGS[pkg]["sched"]
    sched = mod.SloScheduler(budget_ms=50)
    sched.observe_service(0.1)
    with pytest.raises(mod.SloRejected) as ei:
        sched.admit_request(now=10.0, backlog=2)
    assert ei.value.slack_s < 0


@BOTH
def test_note_shed_revokes_stamp_and_counts_reason(pkg):
    sched = PKGS[pkg]["sched"].SloScheduler(budget_ms=1000,
                                            name=f"tshed-unit-{pkg}")
    late, ontime = _buf(pkg, 0), _buf(pkg, 1)
    assert sched.admit(late, now=10.0, backlog=0)
    assert sched.admit(ontime, now=10.0, backlog=0)
    sched.note_shed(late, now=12.0)
    sched.note_shed(ontime, now=10.5)
    assert "admitted_t" not in late.meta and "deadline_t" not in late.meta
    snap = sched.snapshot()
    assert snap["shed_late"] == 1 and snap["shed_capacity"] == 1


@BOTH
def test_aimd_steps_and_power_of_two_cap(pkg):
    ctl = PKGS[pkg]["sched"].FeedbackController(
        budget_s=0.05, batch_cap=8, inflight=2, window=16)
    for _ in range(16):
        ctl.record_completion(0.5)
    assert ctl.maybe_step(now=1.0)
    assert ctl.batch_cap == 4 and ctl.inflight == 1
    for _ in range(16):
        ctl.record_completion(0.01)
    assert ctl.maybe_step(now=2.0)
    assert ctl.batch_cap == 8 and ctl.inflight == 2
    assert ctl.batch_cap & (ctl.batch_cap - 1) == 0


@BOTH
def test_dead_band_holds(pkg):
    ctl = PKGS[pkg]["sched"].FeedbackController(budget_s=0.05, batch_cap=8,
                                                inflight=2)
    for _ in range(64):
        ctl.record_completion(0.07)
    assert not ctl.maybe_step(now=1.0)
    assert ctl.batch_cap == 8 and ctl.inflight == 2


@BOTH
def test_interval_rate_limits_steps(pkg):
    ctl = PKGS[pkg]["sched"].FeedbackController(budget_s=0.05,
                                                interval_s=0.25)
    for _ in range(16):
        ctl.record_completion(0.5)
    assert ctl.maybe_step(now=1.0)
    for _ in range(16):
        ctl.record_completion(0.5)
    assert not ctl.maybe_step(now=1.1)


def _replay(pkg, ops, budget_ms):
    """Drive one scheduler through ``ops`` with explicit clocks; return
    every decision, the knobs after each op and the final snapshot."""
    mod = PKGS[pkg]["sched"]
    sched = mod.SloScheduler(budget_ms=budget_ms,
                             name=f"treplay-{pkg}-{budget_ms}")
    out = []
    for op in ops:
        kind = op[0]
        if kind == "service":
            sched.observe_service(op[1], frames=op[2])
        elif kind == "complete":
            sched.observe_completion(op[1], op[2], frames=op[3])
        elif kind == "retry":
            sched.note_retry(op[1])
        elif kind == "admit":
            buf = _buf(pkg, op[3])
            ok = sched.admit(buf, now=op[1], backlog=op[2])
            out.append(("admit", ok, buf.meta.get("deadline_t")))
            if ok and op[4]:
                sched.note_shed(buf, op[1] + op[4])
        elif kind == "request":
            try:
                sched.admit_request(op[1], op[2])
                out.append(("request", True))
            except mod.SloRejected as e:
                out.append(("request", False, round(e.slack_s, 12)))
        elif kind == "hold":
            sched.note_memory_pressure(op[1])
        out.append(("knobs", sched.batch_cap(), sched.inflight_target(),
                    round(sched.estimator.service_time_s(), 12)))
    snap = sched.snapshot()
    state = sched.checkpoint_state()
    return out, snap, state


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("budget_ms", [20.0, 50.0])
def test_call_sequences_decide_as_jax(seed, budget_ms):
    """A seeded sequence of observations, admissions, sheds, retries and
    memory holds with explicit clocks: both schedulers make the same
    decisions, move their knobs the same way and end in the same
    snapshot and checkpoint state."""
    rng = np.random.default_rng(seed)
    now, ops = 100.0, []
    for i in range(400):
        now += float(rng.uniform(0.0, 0.02))
        r = rng.random()
        if r < 0.25:
            ops.append(("service", float(rng.uniform(0.001, 0.03)),
                        int(rng.integers(1, 9))))
        elif r < 0.5:
            ops.append(("complete", float(rng.uniform(0.0, 0.15)), now,
                        int(rng.integers(1, 9))))
        elif r < 0.8:
            shed_after = float(rng.choice([0.0, 0.0, 0.01, 1.0]))
            ops.append(("admit", now, int(rng.integers(0, 12)), i,
                        shed_after))
        elif r < 0.93:
            ops.append(("request", now, int(rng.integers(0, 6))))
        elif r < 0.97:
            ops.append(("retry", float(rng.uniform(0.0, 0.05))))
        else:
            ops.append(("hold", int(rng.integers(1, 4))))
    got, snap, state = _replay("port", ops, budget_ms)
    ref, jsnap, jstate = _replay("jax", ops, budget_ms)
    assert got == ref
    assert snap == jsnap
    assert state == jstate
    assert snap["admitted"] > 0 and snap["rejected"] > 0
    assert snap["controller_steps"] > 0


@BOTH
def test_restore_state_round_trips(pkg):
    mod = PKGS[pkg]["sched"]
    a = mod.SloScheduler(budget_ms=40, name=f"tckpt-a-{pkg}")
    for i in range(40):
        a.observe_service(0.004 + i * 1e-4)
        a.observe_completion(0.2, 10.0 + i * 0.3)
    b = mod.SloScheduler(budget_ms=40, name=f"tckpt-b-{pkg}")
    b.restore_state(a.checkpoint_state())
    assert b.estimator.snapshot() == a.estimator.snapshot()
    assert b.controller.snapshot()["batch_cap"] == a.controller.batch_cap


def test_mesh_quantum_raises_naming_a24():
    """``note_mesh`` raised naming A.24 until the serving mesh was ported:
    it now sets the admission quantum, as the JAX scheduler's does."""
    sched = scheduler.SloScheduler(budget_ms=50)
    sched.note_mesh(2)
    assert sched.snapshot()["mesh_quantum"] == 2
    sched.controller.batch_cap = 5
    assert sched.batch_cap() == 4


def test_enqueue_only_invokes_never_widen_the_door():
    """On the card a filter's invoke is the host's enqueue (ROADMAP
    C.11): microseconds, whatever the kernels take. Fed nothing but such
    observations, the scheduler must not admit beyond what the sink's
    completion spacing (10 ms a frame here) allows within the budget."""
    sched = scheduler.SloScheduler(budget_ms=55, name="tenqueue-only")
    t = 1000.0
    for _ in range(64):
        sched.observe_service(2e-5, frames=8)      # 20 µs enqueue a window
        t += 0.08                                  # 8 frames in 80 ms
        sched.observe_completion(0.03, t, frames=8)
    assert sched.estimator.service_time_s() == pytest.approx(0.01)
    # backlog b needs (b + 1) × 10 ms ≤ 55 ms: the door closes at b = 5
    admitted = [sched.decide(now=t, backlog=b)[0] for b in range(12)]
    assert admitted == [True] * 5 + [False] * 7
    # and more enqueue-only evidence changes nothing
    for _ in range(200):
        sched.observe_service(1e-6, frames=8)
    assert [sched.decide(now=t, backlog=b)[0] for b in range(12)] == \
        admitted


# -- the queue's scheduler mode ---------------------------------------------------
def _sched_pipe(pkg, name, budget_ms=10_000.0, max_size=32):
    m = PKGS[pkg]
    _src, Gate, Collect = _classes(pkg)
    pipe = m["pipe"].Pipeline(name=name, fuse=False, slo_budget_ms=budget_ms)
    q = m["pipe"].Queue(name="q", stamp_admission=True,
                        max_size_buffers=max_size)
    gate, col = Gate(name="gate"), Collect(name="col")
    pipe.add_linked(q, gate, col)
    pipe.start()
    assert pipe._slo_scheduler is not None
    assert q._sched is pipe._slo_scheduler
    return pipe, q, gate, col


@BOTH
def test_edf_order_under_deadline_jitter(pkg):
    pipe, q, gate, col = _sched_pipe(pkg, f"tedf-jitter-{pkg}")
    EosEvent = PKGS[pkg]["el"].EosEvent
    try:
        now = time.monotonic()
        q.chain(None, _buf(pkg, 0, deadline_t=now + 9.0))
        assert gate.entered.wait(timeout=5)
        q.chain(None, _buf(pkg, 1, deadline_t=now + 3.0))
        q.chain(None, _buf(pkg, 2, deadline_t=now + 1.0))
        q.chain(None, _buf(pkg, 3, deadline_t=now + 2.0))
        gate.release.set()
        q.sink_event(None, EosEvent())
        assert [b.pts for b in col.buffers] == [0, 2000, 3000, 1000]
        assert col.got_eos
    finally:
        gate.release.set()
        pipe.stop()


def _paused_downstream(pkg):
    """The JAX test's shedding scenario: the worker parked in the gate,
    one frame going late in the heap, two overflows."""
    name = f"tedf-shed-{pkg}"
    pipe, q, gate, col = _sched_pipe(pkg, name, max_size=2)
    reg = PKGS[pkg]["reg"]()
    EosEvent = PKGS[pkg]["el"].EosEvent

    def revoked():
        c = reg.get("nns_queue_admitted_revoked_total", pipeline=name,
                    element="q")
        return float(c.value) if c is not None else 0.0

    try:
        r0 = revoked()
        now = time.monotonic()
        q.chain(None, _buf(pkg, 0, deadline_t=now + 9.0))
        assert gate.entered.wait(timeout=5)
        q.chain(None, _buf(pkg, 1, deadline_t=now + 0.05))
        q.chain(None, _buf(pkg, 2, deadline_t=now + 5.0))
        time.sleep(0.12)
        q.chain(None, _buf(pkg, 3, deadline_t=time.monotonic() + 6.0))
        after_late = pipe._slo_scheduler.snapshot()
        q.chain(None, _buf(pkg, 4, deadline_t=time.monotonic() + 7.0))
        gate.release.set()
        q.sink_event(None, EosEvent())
        shed = {reason: reg.get("nns_sched_shed_total", pipeline=name,
                                reason=reason).value
                for reason in ("late", "capacity")}
        return ([b.pts for b in col.buffers], after_late["shed_late"],
                shed, revoked() - r0,
                all("admitted_t" in b.meta for b in col.buffers))
    finally:
        gate.release.set()
        pipe.stop()


def test_shed_late_first_then_least_urgent_as_jax():
    got, ref = _paused_downstream("port"), _paused_downstream("jax")
    assert got == ref
    pts, late_first, shed, revoked, stamped = got
    assert pts == [0, 2000, 3000] and late_first == 1
    assert shed == {"late": 1.0, "capacity": 1.0}
    assert revoked == 2 and stamped


@BOTH
def test_cold_queue_rejects_once_estimator_says_unmeetable(pkg):
    pipe, q, gate, col = _sched_pipe(pkg, f"tedf-reject-{pkg}",
                                     budget_ms=50)
    try:
        pipe._slo_scheduler.observe_service(0.1)
        gate.release.set()
        q.chain(None, _buf(pkg, 0))
        q.sink_event(None, PKGS[pkg]["el"].EosEvent())
        assert col.buffers == []
        assert pipe._slo_scheduler.snapshot()["rejected"] == 1
    finally:
        gate.release.set()
        pipe.stop()


def _run_numeric(pkg, budget_ms, n=6):
    m = PKGS[pkg]
    NumSrc, _gate, Collect = _classes(pkg)
    pipe = m["pipe"].Pipeline(name=f"tident-{pkg}-{int(budget_ms)}",
                              fuse=False, slo_budget_ms=budget_ms)
    q = m["pipe"].Queue(name="q", stamp_admission=True, max_size_buffers=16)
    col = Collect(name="col")
    pipe.add_linked(NumSrc(num_buffers=n), q, col)
    msg = pipe.run(timeout=30)
    assert msg is not None and msg.kind == "eos", msg
    return pipe, [np.asarray(b.tensors[0]).tobytes() for b in col.buffers]


@BOTH
def test_budget_unset_builds_no_scheduler(pkg):
    pipe, vals = _run_numeric(pkg, 0.0)
    assert pipe._slo_scheduler is None
    assert pipe.get("q")._sched is None
    assert len(vals) == 6


def test_unloaded_output_byte_identical_to_fifo_and_jax():
    _p0, base = _run_numeric("port", 0.0)
    pipe1, sched = _run_numeric("port", 60_000.0)
    _j, ref = _run_numeric("jax", 60_000.0)
    assert sched == base == ref
    snap = pipe1._slo_scheduler.snapshot()
    assert snap["admitted"] == 6 and snap["rejected"] == 0
    assert snap["shed_late"] == snap["shed_capacity"] == 0
    assert "scheduler" in pipe1.metrics_snapshot()


def test_sched_series_exported():
    _run_numeric("port", 60_000.0)
    body = get_registry().render_prometheus()
    for series in ("nns_sched_admitted_total", "nns_sched_rejected_total",
                   "nns_sched_shed_total", "nns_sched_batch_cap",
                   "nns_sched_inflight_target", "nns_sched_service_time_ms",
                   "nns_sched_p99_ms", "nns_sched_lanes_hint",
                   "nns_sched_deadline_slack_seconds",
                   "nns_queue_admitted_total"):
        assert series in body, f"{series} missing from registry"


@BOTH
def test_admitted_population_counted_through_aggregator(pkg):
    import nnstreamer_tpu as jnt
    import nnstreamer_tpu_torch as tnt

    mod = jnt if pkg == "jax" else tnt
    pipe = mod.parse_launch(
        "videotestsrc num-buffers=16 width=8 height=8 ! tensor_converter ! "
        "queue name=q max-size-buffers=32 stamp-admission=true ! "
        "tensor_aggregator frames-in=1 frames-out=4 frames-flush=4 "
        "frames-dim=3 concat=true ! tensor_sink name=sink to-host=true")
    assert pipe.run(timeout=60).kind == "eos"
    sink = pipe.get("sink")
    assert sink.admitted_latencies.count == 16
    assert len(sink.admitted_latencies) == 16
    assert sink.latency_percentiles(99.0, base="admitted") is not None


def test_live_knob_retune_keeps_fences_in_order():
    """``_apply_knobs`` retunes the filter's ``inflight`` while entries
    are outstanding: the window fences its oldest entries in order until
    the new depth holds, and nothing is dropped or fenced twice."""
    from nnstreamer_tpu_torch.pipeline.dispatch import DispatchWindow

    class Ev:
        def __init__(self, i, log):
            self.i, self.log = i, log

        def synchronize(self):
            self.log.append(self.i)

    class Owner:
        name, pipeline = "f", None
        _props = {"inflight": 4}

        def get_property(self, key):
            return self._props[key]

    owner, fenced = Owner(), []
    win = DispatchWindow(owner)
    sched = scheduler.SloScheduler(budget_ms=50, name="tknobs")
    pipe = type("P", (), {"elements": [owner], "_flight": None,
                          "lanes": 1})()
    sched.pipeline = pipe
    for i in range(4):
        win.admit([torch.zeros(1)], None, event=Ev(i, fenced))
    assert fenced == []
    sched.controller.inflight = 1
    sched._apply_knobs()
    assert owner._props["inflight"] == 1
    win.admit([torch.zeros(1)], None, event=Ev(4, fenced))
    assert fenced == [0, 1, 2, 3]
    win.drain()
    assert fenced == [0, 1, 2, 3, 4]


# -- the engine's request path ----------------------------------------------------
def _engines(budget_ms):
    import jax.numpy as jnp

    from nnstreamer_tpu.models.transformer import TransformerConfig as JCfg
    from nnstreamer_tpu.models.transformer import init_params as jinit
    from nnstreamer_tpu.serving.engine import (
        ContinuousBatchingEngine as JEngine,
    )
    from nnstreamer_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from nnstreamer_tpu_torch.serving.engine import ContinuousBatchingEngine

    shape = dict(vocab=97, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                 max_seq=64)
    jeng = JEngine(JCfg(**shape, dtype=jnp.float32),
                   jinit(JCfg(**shape, dtype=jnp.float32), seed=3),
                   max_streams=2, steps_per_dispatch=4,
                   slo_budget_ms=budget_ms)
    cfg = TransformerConfig(**shape, dtype=torch.float32)
    teng = ContinuousBatchingEngine(cfg, init_params(cfg, seed=3),
                                    max_streams=2, steps_per_dispatch=4,
                                    slo_budget_ms=budget_ms, device="cpu")
    return {"jax": jeng, "port": teng}


def test_engine_admission_matches_jax_under_injected_estimates():
    """The same injected per-request estimates give both engines the same
    answers at submit(): admitted while the estimate fits the budget,
    ``SloRejected`` (counted in ``nns_sched_rejected_total``) once it does
    not."""
    engines = _engines(50.0)
    answers = {}
    for pkg, eng in engines.items():
        mod = PKGS[pkg]["sched"]
        eng.start()
        try:
            got = []
            for est in (0.02, 1.0, 0.001):
                # a fresh estimate: the EWMA reset to the injected value
                eng._slo.estimator.restore({"invoke_s": est,
                                            "drain_s": None})
                try:
                    eng.submit([1, 2, 3], max_new_tokens=2).result(
                        timeout=60)
                    got.append("admitted")
                except mod.SloRejected:
                    got.append("rejected")
            snap = eng._slo.snapshot()
            answers[pkg] = (got, snap["admitted"], snap["rejected"])
        finally:
            eng.stop()
    assert answers["port"] == answers["jax"]
    assert answers["port"] == (["admitted", "rejected", "admitted"], 2, 1)
    rejected = get_registry().get("nns_sched_rejected_total",
                                  pipeline=engines["port"].obs_name)
    assert rejected.value == 1


def test_no_budget_no_engine_scheduler():
    from nnstreamer_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from nnstreamer_tpu_torch.serving.engine import ContinuousBatchingEngine

    cfg = TransformerConfig(vocab=97, d_model=64, n_heads=4, n_layers=2,
                            d_ff=128, max_seq=64, dtype=torch.float32)
    eng = ContinuousBatchingEngine(cfg, init_params(cfg, seed=3),
                                   max_streams=2, steps_per_dispatch=4,
                                   device="cpu")
    assert eng._slo is None


@pytest.mark.parametrize("late", [True, False])
def test_a_shed_frame_releases_its_staged_slabs(late):
    """A frame shed from the EDF heap (late or for capacity) never reaches
    a dispatch fence: ``note_shed`` returns its pool stash at once and
    revokes its admission."""
    from nnstreamer_tpu_torch.pipeline.dispatch import POOL_STASH_META
    from nnstreamer_tpu_torch.tensors.pool import get_pool

    pool = get_pool()
    slab = pool.acquire((8, 4, 4, 3), np.uint8)
    out0 = pool.snapshot()["outstanding"]
    sched = scheduler.SloScheduler(budget_ms=100, name=f"tshed-stash-{late}")
    buf = _buf("port", 0)
    buf.meta[POOL_STASH_META] = [slab]
    assert sched.admit(buf, now=10.0, backlog=0)
    sched.note_shed(buf, now=10.2 if late else 10.05)
    assert POOL_STASH_META not in buf.meta and "admitted_t" not in buf.meta
    assert pool.snapshot()["outstanding"] == out0 - 1
    snap = sched.snapshot()
    assert (snap["shed_late"], snap["shed_capacity"]) == \
        ((1, 0) if late else (0, 1))
