"""SloScheduler — deadline admission, EDF ordering, and feedback-tuned
batch forming for the serving plane.

Port of ``nnstreamer_tpu/serving/scheduler.py`` (no JAX in it; carried
over as a copy with its imports rewritten). The budget the JAX package
measured against is 50 ms: a saturated pipeline's only overload defense
without it is the leaky ingress queue's blind tail-drop, which sheds
whichever frame is oldest with no notion of deadline. This module owns
the request population between ingress and device dispatch instead:

- **Deadlines.** Every admitted frame carries ``meta["deadline_t"]`` —
  either a per-request override stamped upstream, or
  ``admitted_t + slo_budget_ms`` from the pipeline/queue budget.
- **Admission control.** A frame whose deadline cannot be met given the
  current service-rate estimate (EWMA over the filter's invoke times
  plus the sink's completion spacing — the *slower* of the two governs,
  so a fused pipeline whose filter chain never runs is still covered) is
  rejected at the door: it never consumes queue capacity, device
  batches, or a slot in the admitted-latency population. On CUDA the
  invoke witness times the host's enqueue, not the kernels (ROADMAP
  C.11), so the completion spacing is what keeps admission honest there.
- **EDF ordering.** The admission queue (``pipeline/pipeline.py`` Queue
  in scheduler mode) replaces FIFO with an earliest-deadline-first heap;
  with a uniform budget deadlines are monotone in arrival order, so an
  unloaded pipeline's output is byte-identical to FIFO — the kill
  switch (budget unset) doesn't even build the scheduler.
- **Load shedding.** On overflow the queue sheds already-late frames
  first (they will miss regardless); only when nothing is late does it
  drop the least-urgent (latest-deadline) frame. The batch former also
  sheds any frame whose deadline passed while it sat in the heap. A shed
  frame's admission stamp is revoked so the admitted population nets
  out, and its staged pool slabs are released at once.
- **Batch forming.** The queue worker re-forms runs from whatever is
  admitted each wake, capped by the feedback controller's ``batch_cap``
  (kept a power of two). The port supports the scheduler queue BEFORE
  ``tensor_aggregator`` (bench.py's leaky ``q_ingress``): the runs it
  forms are of single frames, the aggregator still builds windows of
  ``frames-out``, and the fused region sees one input signature and
  captures once. A scheduler queue after the aggregator would hand the
  region windows as they come, and every new window shape would be a
  new CUDA-graph capture.
- **Feedback control.** An event-driven AIMD controller (no polling
  thread, no sleeps on any scheduler hot path) steps ``batch_cap`` and
  the filters' ``inflight`` toward max admitted throughput subject to
  p99 ≤ ``p99_factor`` x budget. ``lanes`` is start-time-static
  (pipeline/lanes.py splices once), so the controller publishes its lane
  recommendation as the ``nns_sched_lanes_hint`` gauge for the next
  launch.

Under an HBM budget (``tensors/memory.py``) :meth:`_memory_backlog` adds
the accountant's overage in frames. Under a serving mesh
(:meth:`note_mesh`) the batch cap rounds down to a multiple of the
mesh's fan-out.

Exported series: ``nns_sched_admitted_total``, ``nns_sched_rejected_total``,
``nns_sched_shed_total{reason}``, ``nns_sched_deadline_slack_seconds``,
``nns_sched_batch_cap``, ``nns_sched_inflight_target``,
``nns_sched_service_time_ms``, ``nns_sched_p99_ms``,
``nns_sched_lanes_hint``.
"""

from __future__ import annotations

import sys
import threading
from collections import deque
from typing import Any, Dict, Optional

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.obs import timeline as _timeline

log = get_logger("scheduler")


class SloRejected(RuntimeError):
    """Raised by request-path admission (serving engine) when the
    deadline is unmeetable under the current service-rate estimate."""

    def __init__(self, message: str, slack_s: float = 0.0):
        super().__init__(message)
        self.slack_s = slack_s


class ServiceRateEstimator:
    """EWMA per-frame service time from two independent witnesses.

    ``observe_invoke`` feeds backend invoke latencies (the unfused
    filter's hot path); ``observe_completion`` feeds the sink-side
    completion spacing (frames delivered per second of wall progress),
    which covers fused pipelines where the filter chain never runs and —
    unlike invoke timing — includes queueing between the dispatch and
    the materialization. Admission uses the SLOWER estimate: admitting
    on an optimistic rate re-creates exactly the late-frame pileup this
    subsystem exists to prevent."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._invoke_s: Optional[float] = None      # per-frame, EWMA
        self._drain_s: Optional[float] = None       # per-frame, EWMA
        self._last_completion_t: Optional[float] = None

    def observe_invoke(self, seconds: float, frames: int = 1) -> None:
        if seconds < 0 or frames < 1:
            return
        per = seconds / frames
        with self._lock:
            self._invoke_s = per if self._invoke_s is None else \
                (1 - self.alpha) * self._invoke_s + self.alpha * per

    def observe_completion(self, now: float, frames: int = 1) -> None:
        if frames < 1:
            return
        with self._lock:
            last = self._last_completion_t
            self._last_completion_t = now
            if last is None:
                return
            gap = now - last
            # a multi-second gap is a stall/warmup artifact, not steady
            # service; folding it in would poison admission for minutes
            if not (0.0 <= gap <= 5.0):
                return
            per = gap / frames
            self._drain_s = per if self._drain_s is None else \
                (1 - self.alpha) * self._drain_s + self.alpha * per

    def service_time_s(self) -> float:
        """Per-frame service-time estimate; 0.0 while cold (admit-all —
        rejecting on no evidence would deadlock a cold pipeline)."""
        with self._lock:
            cands = [v for v in (self._invoke_s, self._drain_s)
                     if v is not None]
        return max(cands) if cands else 0.0

    def service_fps(self) -> float:
        s = self.service_time_s()
        return (1.0 / s) if s > 0 else 0.0

    # -- serving continuity ---------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Checkpointable state: the two EWMAs only.
        ``_last_completion_t`` is a monotonic-clock anchor — meaningless
        in another process, it re-anchors on the first completion."""
        with self._lock:
            return {"invoke_s": self._invoke_s, "drain_s": self._drain_s}

    def restore(self, state: Dict[str, Any]) -> None:
        with self._lock:
            inv = state.get("invoke_s")
            drn = state.get("drain_s")
            self._invoke_s = float(inv) if inv is not None else None
            self._drain_s = float(drn) if drn is not None else None


class FeedbackController:
    """Event-driven AIMD over ``batch_cap`` and ``inflight``.

    Stepped from the observation path (``maybe_step`` — at most one step
    per ``interval_s``), never from a polling thread: the scheduler's
    own rule bans blocking sleeps in this subsystem.
    Policy: completion p99 above ``p99_factor`` x budget is an overload
    signal → multiplicative decrease (halve batch_cap, step inflight
    down); p99 at or under budget is headroom → additive-ish increase
    (double batch_cap toward the bucket ceiling, step inflight up).
    ``batch_cap`` stays a power of two so re-formed batches hit the
    fused region's already-traced bucketed shapes."""

    def __init__(self, budget_s: float, p99_factor: float = 2.0,
                 interval_s: float = 0.25, batch_cap: int = 8,
                 batch_cap_max: int = 64, inflight: int = 2,
                 inflight_max: int = 8, window: int = 512):
        self.budget_s = float(budget_s)
        self.p99_factor = float(p99_factor)
        self.interval_s = float(interval_s)
        self.batch_cap_max = int(batch_cap_max)
        self.inflight_max = int(inflight_max)
        self._lock = threading.Lock()
        self.batch_cap = max(1, int(batch_cap))
        self.inflight = max(1, int(inflight))
        self.steps = 0
        self.last_p99_s: Optional[float] = None
        self._last_step_t = 0.0
        self._lat: deque = deque(maxlen=int(window))

    def record_completion(self, latency_s: float) -> None:
        with self._lock:
            self._lat.append(latency_s)

    def _p99_locked(self) -> Optional[float]:
        if len(self._lat) < 8:
            return None
        vals = sorted(self._lat)
        return vals[min(len(vals) - 1, int(0.99 * (len(vals) - 1)))]

    def maybe_step(self, now: float, overload: bool = False) -> bool:
        """One AIMD step if the interval elapsed and enough completions
        accumulated. Returns True when the knobs changed. ``overload``
        forces the multiplicative-decrease branch regardless of the p99
        reading — the flight recorder's SLO burn-rate windows raise it
        while both alerting windows burn hot, which fires on a breach
        *pattern* before the windowed p99 has fully absorbed it."""
        with self._lock:
            if now - self._last_step_t < self.interval_s:
                return False
            p99 = self._p99_locked()
            if p99 is None:
                return False
            self._last_step_t = now
            self.last_p99_s = p99
            self.steps += 1
            cap0, inf0 = self.batch_cap, self.inflight
            if overload or p99 > self.p99_factor * self.budget_s:
                self.batch_cap = max(1, self.batch_cap // 2)
                self.inflight = max(1, self.inflight - 1)
            elif p99 <= self.budget_s:
                self.batch_cap = min(self.batch_cap_max, self.batch_cap * 2)
                self.inflight = min(self.inflight_max, self.inflight + 1)
            # between budget and p99_factor*budget: hold — the dead band
            # keeps the knobs from oscillating around the target
            return (self.batch_cap, self.inflight) != (cap0, inf0)

    # -- serving continuity ---------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Checkpointable state: AIMD knobs + the completion window.
        ``_last_step_t`` stays 0 — it is a monotonic-clock anchor, and
        restoring it would block the first post-restore step."""
        with self._lock:
            return {
                "batch_cap": self.batch_cap,
                "inflight": self.inflight,
                "steps": self.steps,
                "last_p99_s": self.last_p99_s,
                "latencies": list(self._lat),
            }

    def restore(self, state: Dict[str, Any]) -> None:
        with self._lock:
            self.batch_cap = max(1, int(state.get("batch_cap",
                                                  self.batch_cap)))
            self.inflight = max(1, int(state.get("inflight",
                                                 self.inflight)))
            self.steps = int(state.get("steps", 0))
            p99 = state.get("last_p99_s")
            self.last_p99_s = float(p99) if p99 is not None else None
            self._lat.clear()
            self._lat.extend(state.get("latencies", ()))


def token_deadline(now: float, deadline_t: float, remaining: int) -> float:
    """Per-TOKEN EDF key for continuous-batching decode: spread a
    stream's remaining slack evenly over its remaining token budget, so
    a nearly-late short stream sorts ahead of a comfortable long one —
    the serving engine feeds these into its lane selection each block
    (token-level preemption). Row-independent math: a stream's schedule
    key never depends on which other streams share the batch."""
    return now + max(0.0, deadline_t - now) / max(1, int(remaining))


class SloScheduler:
    """Owns the admitted population between ingress and device dispatch.

    Attach point: ``Pipeline.start()`` builds one per pipeline when
    ``slo_budget_ms`` is set (pipeline-level or on any queue); admission
    queues bind to it in their ``start()``. Also usable standalone by
    the serving engine (``pipeline=None``) for request-path admission.
    """

    def __init__(self, budget_ms: float, pipeline=None, name: str = "",
                 p99_factor: float = 2.0, step_interval_s: float = 0.25,
                 batch_cap: int = 8, batch_cap_max: int = 64,
                 inflight_max: int = 8):
        self.budget_ms = float(budget_ms)
        self.budget_s = self.budget_ms / 1e3
        self.pipeline = pipeline
        self.name = name or getattr(pipeline, "name", "") or "scheduler"
        self.estimator = ServiceRateEstimator()
        inflight0 = 2
        if pipeline is not None:
            for el in pipeline.elements:
                if "inflight" in el._props:
                    inflight0 = max(1, int(el.get_property("inflight")))
                    break
        self.controller = FeedbackController(
            budget_s=self.budget_s, p99_factor=p99_factor,
            interval_s=step_interval_s, batch_cap=batch_cap,
            batch_cap_max=batch_cap_max, inflight=inflight0,
            inflight_max=inflight_max)
        self._lanes_hint = self._current_lanes()
        #: serving-mesh dp fan-out (pipeline/fuse.py pipeline_shard_count,
        #: set via note_mesh at start): batch_cap() rounds down to a
        #: multiple of it so every admitted micro-batch splits evenly
        #: over the shards — a ragged batch pads (wastes) one chip-step
        #: on every device. 1 = single-device, no effect.
        self._mesh_quantum = 1
        #: decaying synthetic backlog set by the supervision layer's
        #: memory-pressure ladder (shed rung): each admission decision
        #: consumes one unit, so a pressure burst sheds at the door for
        #: a bounded run of arrivals and then self-heals
        self._mem_hold = 0
        self._obs_ready = False
        self._m: Dict[str, Any] = {}
        self._obs_init()

    # -- metrics --------------------------------------------------------------
    def _obs_init(self) -> None:
        reg = get_registry()
        labels = {"pipeline": self.name}
        self._m = {
            "admitted": reg.counter(
                "nns_sched_admitted_total",
                "Frames/requests admitted under the SLO budget", **labels),
            "rejected": reg.counter(
                "nns_sched_rejected_total",
                "Frames/requests rejected at admission (deadline "
                "unmeetable under the service-rate estimate)", **labels),
            "shed_late": reg.counter(
                "nns_sched_shed_total",
                "Admitted frames shed before dispatch",
                reason="late", **labels),
            "shed_capacity": reg.counter(
                "nns_sched_shed_total",
                "Admitted frames shed before dispatch",
                reason="capacity", **labels),
            "retries": reg.counter(
                "nns_fault_sched_retry_seconds_total",
                "Wall time burnt on element retries/backoff fed into the "
                "service-rate estimate (brownout-aware admission)",
                **labels),
            "slack": reg.histogram(
                "nns_sched_deadline_slack_seconds",
                "Deadline slack at admission decision time (negative = "
                "rejected)",
                buckets=(-1.0, -0.1, -0.01, 0.0, 0.01, 0.05, 0.1,
                         0.5, 1.0, 5.0), **labels),
        }
        # weakref-bound gauge callbacks: the registry holds fns forever,
        # and a strong self would keep the whole pipeline alive with it
        import weakref

        ref = weakref.ref(self)

        def _g(attr):
            def read():
                s = ref()
                return float(attr(s)) if s is not None else 0.0
            return read

        reg.gauge("nns_sched_batch_cap",
                  "Feedback controller's current batch-forming cap",
                  fn=_g(lambda s: s.controller.batch_cap), **labels)
        reg.gauge("nns_sched_inflight_target",
                  "Feedback controller's current dispatch-window target",
                  fn=_g(lambda s: s.controller.inflight), **labels)
        reg.gauge("nns_sched_service_time_ms",
                  "EWMA per-frame service-time estimate",
                  fn=_g(lambda s: s.estimator.service_time_s() * 1e3),
                  **labels)
        reg.gauge("nns_sched_p99_ms",
                  "Controller's last observed completion p99",
                  fn=_g(lambda s: (s.controller.last_p99_s or 0.0) * 1e3),
                  **labels)
        reg.gauge("nns_sched_lanes_hint",
                  "Recommended ingest lane count for the next launch "
                  "(lanes are start-time-static)",
                  fn=_g(lambda s: s._lanes_hint), **labels)
        self._obs_ready = True

    def _current_lanes(self) -> int:
        try:
            from nnstreamer_tpu_torch.pipeline.lanes import effective_lanes

            return effective_lanes(getattr(self.pipeline, "lanes", 1) or 1)
        except Exception:  # noqa: BLE001 — advisory gauge only
            return 1

    # -- admission ------------------------------------------------------------
    def decide(self, now: float, backlog: int,
               deadline_t: Optional[float] = None,
               budget_ms: Optional[float] = None):
        """Admission decision without side effects on a buffer:
        ``(admit, deadline_t, slack_s)``. ``backlog`` is the number of
        frames already ahead of this one (queued + undelivered); the
        estimated completion is ``now + (backlog + 1) * service_time``.
        Device-memory pressure adds a synthetic memory-backlog term
        (:meth:`_memory_backlog`) so an HBM-bound pipeline sheds at the
        door instead of OOM-ing mid-pipeline. A cold estimator
        (service_time 0) admits everything."""
        budget_s = (float(budget_ms) / 1e3 if budget_ms else self.budget_s)
        if deadline_t is None:
            deadline_t = now + budget_s
        est_done = now + \
            (max(0, backlog) + 1 + self._memory_backlog()) * \
            self.estimator.service_time_s()
        slack = deadline_t - est_done
        return slack >= 0.0, deadline_t, slack

    def _memory_backlog(self) -> int:
        """The admission-side memory-pressure term: the HBM budget
        accountant's current overage expressed in frames
        (``tensors/memory.py``), plus the decaying hold the supervision
        ladder's shed rung requested. Pure state reads — no waits, no
        clock; zero with no accountant and no pressure (one dict
        lookup)."""
        extra = 0
        mem = sys.modules.get("nnstreamer_tpu_torch.tensors.memory")
        if mem is not None and mem.ACTIVE is not None:
            extra = mem.ACTIVE.admission_backlog()
        hold = self._mem_hold
        if hold > 0:
            self._mem_hold = hold - 1  # one unit per admission decision
        return extra + hold

    def note_memory_pressure(self, frames: int = 8) -> None:
        """The pressure ladder's shed rung: hold admission down for the
        next ``frames`` decisions while reclamation and retries race
        fresh arrivals for the same headroom."""
        self._mem_hold = max(self._mem_hold, int(frames))
        m = self._m.get("mem_pressure")
        if m is None:
            m = self._m["mem_pressure"] = get_registry().counter(
                "nns_sched_mem_pressure_total",
                "Memory-pressure shed requests from the supervision "
                "ladder (admission held down while reclamation runs)",
                pipeline=self.name)
        m.inc()

    def admit(self, buf, now: float, backlog: int,
              budget_ms: Optional[float] = None) -> bool:
        """Frame-path admission: decide, record, and stamp. On admit the
        buffer carries ``admitted_t`` (the served-latency base the sink
        reads) and ``deadline_t`` (the EDF key); on reject nothing is
        stamped and the frame is the caller's to drop."""
        ok, deadline_t, slack = self.decide(
            now, backlog, deadline_t=buf.meta.get("deadline_t"),
            budget_ms=budget_ms)
        self._m["slack"].observe(slack)
        if not ok:
            self._m["rejected"].inc()
            tl = _timeline.ACTIVE
            if tl is not None:
                tl.mark("sched_reject",
                        buf.meta.get(_timeline.TRACE_SEQ_META),
                        track="scheduler",
                        slack_ms=round(slack * 1e3, 3))
            return False
        buf.meta.setdefault("admitted_t", now)
        buf.meta["deadline_t"] = deadline_t
        self._m["admitted"].inc()
        return True

    def admit_request(self, now: float, backlog: int,
                      deadline_t: Optional[float] = None) -> None:
        """Request-path admission (serving engine): raises
        :class:`SloRejected` when unmeetable, else counts the admit."""
        ok, deadline_t, slack = self.decide(now, backlog,
                                            deadline_t=deadline_t)
        self._m["slack"].observe(slack)
        if not ok:
            self._m["rejected"].inc()
            raise SloRejected(
                f"{self.name}: deadline unmeetable — backlog {backlog} x "
                f"{self.estimator.service_time_s() * 1e3:.1f} ms/frame "
                f"overruns the budget by {-slack * 1e3:.1f} ms",
                slack_s=slack)
        self._m["admitted"].inc()

    def note_shed(self, buf, now: float) -> None:
        """An admitted frame was dropped before dispatch: revoke its
        admission stamp (the admitted population must net out — a shed
        frame must never surface as a served-latency sample through a
        shared-meta path like a tee branch) and count it by reason."""
        late = buf.meta.get("deadline_t", now) <= now
        buf.meta.pop("admitted_t", None)
        buf.meta.pop("deadline_t", None)
        self._m["shed_late" if late else "shed_capacity"].inc()
        # a shed frame never reaches a dispatch fence: release its pool
        # staging stash and an exclusively-owned device payload now
        # rather than letting shed work pin device memory/slabs until GC
        from nnstreamer_tpu_torch.pipeline.dispatch import (
            release_shed_payload,
        )

        release_shed_payload(buf)
        if "_net_expire" in buf.meta:
            # the frame arrived over the query wire with a propagated
            # deadline: tell the origin client it was shed so its
            # in-flight slot frees now instead of timing out
            from nnstreamer_tpu_torch.query import resilience

            resilience.note_remote_shed(buf)
        tl = _timeline.ACTIVE
        if tl is not None:
            tl.mark("sched_shed", buf.meta.get(_timeline.TRACE_SEQ_META),
                    track="scheduler", late=late)

    def note_shed_request(self, now: float, late: bool = True) -> None:
        """Request-path analog of :meth:`note_shed`: an ADMITTED decode
        stream had its KV blocks revoked back to the pool (serving
        engine cache-pressure shed). Replays the admission revocation
        accounting — the admitted population nets out through the same
        shed counters the frame path uses."""
        self._m["shed_late" if late else "shed_capacity"].inc()
        tl = _timeline.ACTIVE
        if tl is not None:
            tl.mark("sched_shed", None, track="scheduler", late=late)

    # -- observation feeds ----------------------------------------------------
    def observe_service(self, seconds: float, frames: int = 1) -> None:
        """Backend invoke latency (elements/filter.py hot path)."""
        self.estimator.observe_invoke(seconds, frames)

    def note_retry(self, busy_s: float) -> None:
        """An element recovered (or exhausted) a retry ladder after
        ``busy_s`` of failed attempts + backoff (pipeline/supervise.py).
        That wall time is real per-frame service cost during a brownout:
        folding it into the invoke-side estimate raises the service-time
        EWMA, so admission tightens exactly while the element is flaky
        instead of over-admitting against the healthy-path estimate."""
        if busy_s <= 0:
            return
        self._m["retries"].inc(busy_s)
        self.estimator.observe_invoke(busy_s, 1)

    def observe_completion(self, latency_s: float, now: float,
                           frames: int = 1) -> None:
        """A served frame reached the sink: feed the drain-rate estimate
        and the controller's p99 window, then give the controller its
        event-driven chance to step."""
        self.estimator.observe_completion(now, frames)
        self.controller.record_completion(latency_s)
        fr = getattr(self.pipeline, "_flight", None)
        overload = fr is not None and fr.burn_overload(now)
        if self.controller.maybe_step(now, overload=overload):
            self._apply_knobs()

    # -- knob application -----------------------------------------------------
    def note_mesh(self, shard_count: int) -> None:
        """Adopt the pipeline's serving-mesh fan-out (Pipeline.start()
        after region fusion): the admission quantum becomes the dp shard
        count so drained micro-batches always split evenly over devices."""
        self._mesh_quantum = max(1, int(shard_count))

    def batch_cap(self) -> int:
        cap = self.controller.batch_cap
        q = self._mesh_quantum
        if q > 1:
            # align DOWN to the shard quantum (but never below one full
            # mesh-wide batch): the AIMD controller keeps its power-of-
            # two ladder; only the value handed to the queue drain is
            # quantized, so controller state stays mesh-agnostic
            cap = max(q, (cap // q) * q)
        return cap

    def inflight_target(self) -> int:
        return self.controller.inflight

    def _apply_knobs(self) -> None:
        """Push the controller's inflight target onto every element that
        has the knob. Writes ``_props`` directly: ``set_property`` would
        invalidate the fused region's plan on every step, and the window
        depth changes nothing the plan depends on — the DispatchWindow
        reads the property live at each admit and fences its oldest
        entries, in order, until at most that many are outstanding."""
        pipe = self.pipeline
        if pipe is None:
            return
        target = self.controller.inflight
        for el in pipe.elements:
            if "inflight" in el._props and el._props["inflight"] != target:
                el._props["inflight"] = target
        # lanes are spliced once at start(): publish the recommendation
        # instead of pretending to retune a static knob. Healthy p99 with
        # capacity sheds means ingest (not the device) is starving the
        # budget — one more lane is the next launch's cheapest lever.
        shed = (self._m["shed_capacity"].value
                + self._m["shed_late"].value)
        p99 = self.controller.last_p99_s or 0.0
        cur = self._current_lanes()
        hint = cur + 1 if (shed > 0 and p99 <= self.budget_s) else cur
        # the flight recorder's attribution engine is the second vote:
        # ingest/reorder-dominated e2e spread means the host side is the
        # variance source, and one more lane is the advisory fix even
        # without capacity sheds on record
        fr = getattr(pipe, "_flight", None)
        if fr is not None:
            hints = fr.attribution().get("hints", {})
            delta = int(hints.get("lanes_hint_delta", 0) or 0)
            if delta > 0:
                hint = max(hint, cur + delta)
        self._lanes_hint = hint

    # -- reporting ------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        c = self.controller
        return {
            "budget_ms": self.budget_ms,
            "admitted": int(self._m["admitted"].value),
            "rejected": int(self._m["rejected"].value),
            "shed_late": int(self._m["shed_late"].value),
            "shed_capacity": int(self._m["shed_capacity"].value),
            "service_time_ms": round(
                self.estimator.service_time_s() * 1e3, 3),
            "batch_cap": c.batch_cap,
            "mesh_quantum": self._mesh_quantum,
            "inflight_target": c.inflight,
            "controller_steps": c.steps,
            "p99_ms": round((c.last_p99_s or 0.0) * 1e3, 3),
            "lanes_hint": self._lanes_hint,
            "memory_hold": self._mem_hold,
        }

    def shed_total(self) -> int:
        return int(self._m["shed_late"].value
                   + self._m["shed_capacity"].value)

    # -- serving continuity ---------------------------------------------------
    # (checkpoint_state/restore_state, distinct from the reporting
    # snapshot() above; the keys of the pair are symmetric)
    def checkpoint_state(self) -> Dict[str, Any]:
        """The durable serving state a restarted process would otherwise
        re-learn from cold: the service-rate EWMAs and the controller's
        AIMD knobs/window, plus the advisory knob outputs. Counters stay
        in the metrics registry — they are observability, not state."""
        return {
            "estimator": self.estimator.snapshot(),
            "controller": self.controller.snapshot(),
            "lanes_hint": self._lanes_hint,
            "mem_hold": self._mem_hold,
        }

    def restore_state(self, state: Dict[str, Any]) -> None:
        est = state.get("estimator")
        if est:
            self.estimator.restore(est)
        ctl = state.get("controller")
        if ctl:
            self.controller.restore(ctl)
        self._mem_hold = int(state.get("mem_hold", 0))
        # push the restored inflight target onto the elements now —
        # otherwise the warm knobs only take effect after the first
        # post-restore controller step (this recomputes the lanes hint
        # from the fresh process's zeroed shed counters, so the saved
        # hint is applied after and the larger recommendation wins)
        self._apply_knobs()
        self._lanes_hint = max(self._lanes_hint,
                               int(state.get("lanes_hint", 0)))


def ensure_scheduler(pipeline) -> Optional[SloScheduler]:
    """Build (once) the pipeline's scheduler from its budget
    configuration: the pipeline-level ``slo_budget_ms`` wins, else the
    largest per-queue ``slo_budget_ms`` property. Returns None when no
    budget is configured — the kill switch: no scheduler object exists
    and every queue runs its exact pre-scheduler path."""
    existing = getattr(pipeline, "_slo_scheduler", None)
    if existing is not None:
        return existing
    budget = float(getattr(pipeline, "slo_budget_ms", 0.0) or 0.0)
    if budget <= 0:
        budget = max((float(el._props["slo_budget_ms"])
                      for el in pipeline.elements
                      if "slo_budget_ms" in el._props), default=0.0)
    if budget <= 0:
        return None
    sched = SloScheduler(budget_ms=budget, pipeline=pipeline)
    pipeline._slo_scheduler = sched
    log.info("%s: SLO scheduler attached (budget %.1f ms)",
             pipeline.name, budget)
    return sched
