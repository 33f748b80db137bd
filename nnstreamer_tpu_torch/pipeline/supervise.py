"""Supervision layer — per-element error policies and the pipeline watchdog.

Port of ``nnstreamer_tpu/pipeline/supervise.py``. Any exception in an
element's ``chain`` used to become a ``FlowError`` on the bus and end the
pipeline. Robustness here is the per-element ``error-policy`` property
(or ``Pipeline(error_policy=...)``), enforced at the uniform
``_chain_entry`` boundary (``pipeline/element.py``):

- ``halt``       — (default) wrap, raise, bus error.
- ``skip-frame`` — drop the failing frame, count it
  (``nns_fault_skipped_frames_total``), keep streaming. Loss equals the
  failure count; everything else is byte-identical.
- ``retry``      — re-run the element's ``chain`` up to ``retry-max``
  times with bounded exponential backoff and deterministic jitter
  (``retry-backoff-ms`` base, 1 s cap). Retries exhausted → ``halt``.
- ``degrade``    — ``tensor_filter`` only: reload the backend and retry
  once; still failing → reopen with ``accelerator=cpu`` and retry once
  more; still failing → ``halt``. Other elements fall back to ``retry``
  semantics. The CPU rung runs only under this explicit policy; each
  rung counts ``nns_fault_degraded_total`` and drops a ``fault_degrade``
  mark.

  A *memory-pressure* failure (an injected ``kind=oom`` or a
  ``torch.cuda.OutOfMemoryError``) under ``degrade`` takes the
  memory-pressure ladder instead (:func:`_pressure_ladder`): ``evict``
  (every resident weight unit of the HBM accountant, ``tensors/memory.py``,
  to host staging), ``pool`` (drain the window, free the staging arenas,
  ``torch.cuda.empty_cache()``), ``shed`` (the SLO scheduler sheds at
  admission), then halt. It has no ``cpu`` rung: memory pressure never
  moves a kernel's work to the host (ROADMAP C.29). Each rung counts
  ``nns_mem_pressure_events_total{rung}`` when an accountant is active.

The wall time burnt on retries (failed attempts and backoff) is reported
to the pipeline's SLO scheduler (:meth:`SloScheduler.note_retry`), so
admission does not over-admit while the service is browning out.

The **watchdog** (:class:`PipelineWatchdog`) is the liveness half: a
thread that samples a pipeline-wide progress vector (chain invokes,
lane deliveries) and, when in-flight work exists but no progress lands
within ``watchdog_s``, fails the pipeline — a bus error naming the
stalled elements, sources parked — instead of hanging a fence or an EOS
drain forever. Enabled per pipeline (``Pipeline(watchdog_s=...)``) or via
``NNSTPU_WATCHDOG_S``; default off, zero threads, byte-identical. The
watchdog thread makes no CUDA call: it reads counters and queue depths.

Every recovery emits ``nns_fault_*`` metrics and a frame-ledger mark
(``fault_retry`` / ``fault_skip`` / ``fault_degrade`` /
``watchdog_trip``), so the timeline shows which frames died and why.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.obs import timeline as _timeline
from nnstreamer_tpu_torch.pipeline.element import FlowError, FlowReturn

log = get_logger("supervise")

POLICIES: Tuple[str, ...] = ("halt", "skip-frame", "retry", "degrade")

#: backoff ceiling — a retry ladder must never park a streaming thread
#: for longer than this per attempt
_BACKOFF_CAP_S = 1.0


def effective_policy(el) -> str:
    """The element's error policy: its own property first, then the
    pipeline-level default (``Pipeline(error_policy=...)``), then
    ``halt``. Read only on the error path — the hot path never pays."""
    pol = el._props.get("error_policy")
    if not pol:
        pol = getattr(el.pipeline, "error_policy", None) or "halt"
    pol = str(pol).replace("_", "-")
    if pol not in POLICIES:
        raise FlowError(
            f"{el.name}: unknown error-policy {pol!r} "
            f"(policies: {', '.join(POLICIES)})")
    return pol


def _metrics(el) -> Dict[str, Any]:
    """Per-element recovery counters, cached on the element (created on
    first failure — a healthy pipeline allocates nothing)."""
    m = getattr(el, "_supervise_m", None)
    if m is None:
        reg = get_registry()
        labels = el._obs_labels()
        m = el._supervise_m = {
            "retries": reg.counter(
                "nns_fault_retries_total",
                "Chain re-invocations under error-policy=retry/degrade",
                **labels),
            "recovered": reg.counter(
                "nns_fault_recovered_total",
                "Failures recovered without frame loss (retry/degrade "
                "succeeded)", **labels),
            "skipped": reg.counter(
                "nns_fault_skipped_frames_total",
                "Frames dropped under error-policy=skip-frame", **labels),
            "degraded": reg.counter(
                "nns_fault_degraded_total",
                "Degrade-ladder rungs taken (backend reload / CPU "
                "fallback)", **labels),
        }
    return m


def _mark(kind: str, buf, **args) -> None:
    tl = _timeline.ACTIVE
    if tl is not None:
        seq = buf.meta.get(_timeline.TRACE_SEQ_META) \
            if buf is not None else None
        tl.mark(kind, seq, track="faults", **args)


def _note_scheduler_retry(el, busy_s: float) -> None:
    """Feed the wall time burnt on failed attempts and backoff into the
    SLO scheduler's service-rate estimate: during a brownout each served
    frame costs its retries too, and admission computed from the healthy
    path's estimate would over-admit exactly when capacity is lowest."""
    sched = getattr(el.pipeline, "_slo_scheduler", None)
    if sched is not None and busy_s > 0:
        sched.note_retry(busy_s)


def _backoff_sleep(el, attempt: int, base_ms: float) -> float:
    """Bounded exponential backoff with deterministic jitter: the delay
    for (element, attempt) is a pure function, so a seeded fault spec
    reproduces the same recovery timeline run over run."""
    base_s = max(0.0, float(base_ms)) / 1e3
    delay = min(base_s * (2 ** (attempt - 1)), _BACKOFF_CAP_S)
    # string seed: sha512-based, stable across processes (tuple seeds
    # hash through PYTHONHASHSEED and would vary run to run)
    jitter = 0.5 + 0.5 * random.Random(f"{el.name}:{attempt}").random()
    delay *= jitter
    if delay > 0:
        time.sleep(delay)
    return delay


# --------------------------------------------------------------------------
# chain-error recovery (called from Element._chain_entry's except path)
# --------------------------------------------------------------------------
def recover_chain(el, pad, buf, exc: BaseException) -> FlowReturn:
    """Apply the element's non-halt error policy to a failed ``chain``
    invocation. Returns the recovered FlowReturn or raises ``FlowError``
    when the policy is exhausted (halt semantics)."""
    policy = effective_policy(el)
    if policy == "retry":
        return _retry(el, pad, buf, exc)
    if policy == "degrade":
        return _degrade(el, pad, buf, exc)
    if policy == "skip-frame":
        return _skip(el, buf, exc)
    raise _wrap(el, exc)  # halt


def recover_chain_list(el, pad, bufs: List[Any],
                       exc: BaseException) -> FlowReturn:
    """List-entry twin: a failed ``chain_list`` falls back to per-buffer
    ``chain`` calls with the policy applied per frame, so one poisoned
    frame in a drained batch costs (at most) itself, not the batch.

    The default ``chain_list`` marks how many leading buffers were fully
    chained before the failure (``_nns_list_done``): those were pushed
    downstream and are not replayed. The rest, the failing buffer first,
    are re-chained one by one through ``el.chain`` with the policy per
    frame, as the JAX module does: the failing buffer gets one more
    chain before any policy acts on it, so a transient fault in a list
    costs no frame even under ``skip-frame``. On the card the re-chain of
    a fused region is the region's own ``chain`` (copy in, replay). A
    custom ``chain_list`` without the marker replays every buffer."""
    policy = effective_policy(el)
    if policy == "halt":
        raise _wrap(el, exc)
    done = int(getattr(exc, "_nns_list_done", 0) or 0)
    if 0 < done <= len(bufs):
        bufs = bufs[done:]
    log.warning("%s: chain_list failed (%s); replaying %d undelivered "
                "buffer(s) individually under error-policy=%s", el.name,
                exc, len(bufs), policy)
    ret: FlowReturn = FlowReturn.OK
    for b in bufs:
        try:
            r = el.chain(pad, b)
        except Exception as e:  # noqa: BLE001 — per-frame policy below
            r = recover_chain(el, pad, b, e)
        if r is FlowReturn.EOS:
            return r
        if r is not None:
            ret = r
    return ret


def _wrap(el, exc: BaseException) -> FlowError:
    return exc if isinstance(exc, FlowError) \
        else FlowError(f"{el.name}: {exc}")


def _skip(el, buf, exc: BaseException) -> FlowReturn:
    m = _metrics(el)
    m["skipped"].inc()
    _mark("fault_skip", buf, element=el.name)
    el.log.warning("%s: dropping frame under error-policy=skip-frame: %s",
                   el.name, exc)
    # an admitted frame that dies here leaves the served population —
    # revoke the stamp so shared-meta consumers never report it as a
    # served-latency sample (same contract as scheduler shedding)
    if buf is not None:
        buf.meta.pop("admitted_t", None)
    return FlowReturn.OK


def _retry(el, pad, buf, exc: BaseException,
           exhausted: str = "halt") -> FlowReturn:
    m = _metrics(el)
    retry_max = max(1, int(el._props.get("retry_max") or 3))
    base_ms = float(el._props.get("retry_backoff_ms") or 5.0)
    t0 = time.monotonic()
    last: BaseException = exc
    for attempt in range(1, retry_max + 1):
        _backoff_sleep(el, attempt, base_ms)
        m["retries"].inc()
        _mark("fault_retry", buf, element=el.name, attempt=attempt)
        try:
            ret = el.chain(pad, buf)
        except Exception as e:  # noqa: BLE001 — bounded ladder, re-raised
            # as FlowError below when attempts run out
            last = e
            continue
        _note_scheduler_retry(el, time.monotonic() - t0)
        m["recovered"].inc()
        el.log.warning("%s: recovered on retry %d/%d (first failure: %s)",
                       el.name, attempt, retry_max, exc)
        return FlowReturn.OK if ret is None else ret
    _note_scheduler_retry(el, time.monotonic() - t0)
    if exhausted == "skip":
        return _skip(el, buf, last)
    raise FlowError(
        f"{el.name}: error-policy=retry exhausted after {retry_max} "
        f"attempt(s): {last}") from last


def _is_memory_pressure(exc: BaseException) -> bool:
    """Discriminate an OOM-class failure from an ordinary backend fault:
    an injected ``kind=oom`` fault, a ``torch.cuda.OutOfMemoryError``, or
    a runtime error whose text carries the allocator's exhaustion
    signature."""
    from nnstreamer_tpu_torch.pipeline.faults import InjectedFault

    if isinstance(exc, InjectedFault):
        return exc.kind == "oom"
    import torch

    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    text = str(exc).lower()
    return "out of memory" in text or "ran out of memory" in text


def _degrade(el, pad, buf, exc: BaseException) -> FlowReturn:
    """The tensor_filter degrade ladder: (1) reload the backend in place
    and retry — a wedged session/compilation cache is the common
    transient; (2) reopen with ``accelerator=cpu`` and retry — the
    accelerator is presumed sick, serve degraded rather than die;
    (3) halt. Elements without a backend get ``retry`` semantics.
    OOM-class failures take :func:`_pressure_ladder` instead — the
    accelerator isn't sick, it's FULL, and a reload would re-lose the
    same allocation race."""
    if _is_memory_pressure(exc):
        return _pressure_ladder(el, pad, buf, exc)
    if not hasattr(el, "_open_fw"):
        log.warning("%s: error-policy=degrade on a non-filter element — "
                    "applying retry semantics", el.name)
        return _retry(el, pad, buf, exc)
    m = _metrics(el)
    last = exc
    for stage in ("reload", "cpu"):
        m["degraded"].inc()
        _mark("fault_degrade", buf, element=el.name, stage=stage)
        try:
            _reopen_backend(el, force_cpu=(stage == "cpu"))
        except Exception as e:  # noqa: BLE001 — a failed reopen is just
            # a failed rung; the ladder continues (cpu) or halts below
            el.log.warning("%s: degrade stage %r reopen failed: %s",
                           el.name, stage, e)
            last = e
            continue
        m["retries"].inc()
        try:
            ret = el.chain(pad, buf)
        except Exception as e:  # noqa: BLE001 — next rung or halt below
            last = e
            continue
        m["recovered"].inc()
        el.log.warning(
            "%s: degraded (%s) after backend failure: %s", el.name,
            "reloaded backend" if stage == "reload"
            else "CPU fallback", exc)
        return FlowReturn.OK if ret is None else ret
    raise FlowError(
        f"{el.name}: error-policy=degrade exhausted "
        f"(reload + CPU fallback both failed): {last}") from last


def _pressure_ladder(el, pad, buf, exc: BaseException) -> FlowReturn:
    """The memory-pressure rungs, in escalation order (see
    ``tensors/memory.py`` PRESSURE_RUNGS and docs/robustness.md):

    1. ``evict`` — drop every resident weight unit to host staging; the
       one this frame needs prefetches back in on the retry.
    2. ``pool``  — drain the element's dispatch window (outstanding
       batches release their staging stashes), free every pool arena's
       free-listed slabs, and return the CUDA caching allocator's free
       blocks (``torch.cuda.empty_cache()``). A live CUDA graph's private
       pool is not freed that way: its blocks stay reserved until the
       region drops the graph.
    3. ``shed``  — tell the SLO scheduler to shed at admission for a
       while (memory-backlog term) so retried work isn't racing fresh
       arrivals for the same headroom; reclaim again.

    Then the ladder halts with a FlowError naming the rungs tried. The
    JAX ladder has a fourth rung, ``cpu``, that reopens the filter on the
    host; the port has none, because a kernel's work never moves to its
    plain version on the CPU (ROADMAP C.29).

    Every rung counts ``nns_fault_degraded_total`` and
    ``nns_mem_pressure_events_total{rung=...}`` and marks the ledger, so
    a recovery is attributable to the rung that made room. On a fused
    region the retry replays the region: an evicted weight unit loads
    back into new storage, and the region, seeing the unit's load count
    change, drops its graphs and captures anew (``pipeline/fuse.py``)."""
    m = _metrics(el)
    last = exc
    from nnstreamer_tpu_torch.tensors.memory import PRESSURE_RUNGS

    for rung in PRESSURE_RUNGS:
        m["degraded"].inc()
        _mark("fault_degrade", buf, element=el.name, stage=rung)
        _count_pressure_rung(rung)
        try:
            _apply_pressure_rung(el, rung)
        except Exception as e:  # noqa: BLE001 — a failed rung is just a
            # failed rung; escalation continues and halt is below
            el.log.warning("%s: pressure rung %r failed: %s",
                           el.name, rung, e)
            last = e
            continue
        m["retries"].inc()
        try:
            ret = el.chain(pad, buf)
        except Exception as e:  # noqa: BLE001 — next rung or halt below
            last = e
            continue
        m["recovered"].inc()
        el.log.warning("%s: recovered from memory pressure at rung %r "
                       "(first failure: %s)", el.name, rung, exc)
        return FlowReturn.OK if ret is None else ret
    raise FlowError(
        f"{el.name}: memory-pressure ladder exhausted "
        f"({' → '.join(PRESSURE_RUNGS)} all failed; the port has no CPU "
        f"rung): {last}") from last


def _count_pressure_rung(rung: str) -> None:
    import sys

    mem = sys.modules.get("nnstreamer_tpu_torch.tensors.memory")
    if mem is not None and mem.ACTIVE is not None:
        mem.ACTIVE.pressure_events += 1
        mem.ACTIVE.count_pressure(rung)


def _apply_pressure_rung(el, rung: str) -> None:
    """The reclamation action for one rung (no retry here — the caller
    owns the retry loop)."""
    import sys

    mem = sys.modules.get("nnstreamer_tpu_torch.tensors.memory")
    acct = mem.ACTIVE if mem is not None else None
    if rung == "evict":
        if acct is not None:
            acct.residency.evict_all()
        return
    if rung == "pool":
        from nnstreamer_tpu_torch.tensors.pool import release_all_pools

        window = getattr(el, "_window", None)
        if window is not None:
            window.drain(on_error="log")
        release_all_pools()
        _empty_cache()
        return
    if rung == "shed":
        sched = getattr(el.pipeline, "_slo_scheduler", None)
        if sched is not None:
            sched.note_memory_pressure()
        # shedding only relieves FUTURE admissions; this frame still
        # needs room now, so run the reclamation rungs again too
        if acct is not None:
            acct.residency.evict_all()
        from nnstreamer_tpu_torch.tensors.pool import release_all_pools

        release_all_pools()
        _empty_cache()


def _empty_cache() -> None:
    """Give the caching allocator's free blocks back to the device.
    Blocks a captured CUDA graph still owns (its private pool) stay
    reserved."""
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _reopen_backend(el, force_cpu: bool) -> None:
    """Close and reopen a tensor_filter's backend, optionally pinned to
    the CPU. Outstanding dispatches read the old backend's params, so
    the window is fenced (errors logged, not raised — the batch that
    poisoned it is the reason we're here) before the close."""
    window = getattr(el, "_window", None)
    if window is not None:
        window.drain(on_error="log")
    # the drained window just released its staging stashes — return the
    # arenas' free slabs too: a reopen (especially force_cpu) means the
    # old working set's peak-rate slabs are dead weight
    from nnstreamer_tpu_torch.tensors.pool import release_all_pools

    release_all_pools()
    if el.fw is not None:
        try:
            el._close_fw()
        except Exception as e:  # noqa: BLE001 — a dying backend failing
            # to close cleanly must not block its own replacement
            el.log.warning("%s: backend close during degrade failed: %s",
                           el.name, e)
        el.fw = None
    if force_cpu:
        # the port's accelerator grammar (device.parse_accelerator)
        el._props["accelerator"] = "true:cpu"
    el._open_fw()
    region = getattr(el, "_fused_region", None)
    if region is not None:
        region.invalidate()


# --------------------------------------------------------------------------
# watchdog
# --------------------------------------------------------------------------
class PipelineWatchdog:
    """Liveness monitor: fails a stalled pipeline instead of letting a
    wedged fence or EOS drain hang forever.

    Samples a progress vector — total chain invokes across elements and
    fused regions, lane-executor deliveries — and, for in-flight work,
    queue depths, dispatch-window occupancy and live source threads. A trip requires BOTH no progress for
    ``deadline_s`` AND evidence of in-flight work (depth, window
    occupancy, or a live source): a pipeline that drained cleanly and
    sits idle after EOS never trips. On trip it posts a bus error
    naming the suspect elements, parks the sources, and bumps
    ``nns_fault_watchdog_trips_total`` — ``stop()`` then tears down as
    for any other bus error."""

    def __init__(self, pipeline, deadline_s: float,
                 poll_s: Optional[float] = None):
        self.pipeline = pipeline
        self.deadline_s = float(deadline_s)
        self.poll_s = poll_s if poll_s is not None \
            else max(0.05, min(self.deadline_s / 4.0, 1.0))
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.trips = 0
        self._m_trips = get_registry().counter(
            "nns_fault_watchdog_trips_total",
            "Watchdog detections of a stalled pipeline (no sink/chain "
            "progress within the deadline while work was in flight)",
            pipeline=pipeline.name)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"{self.pipeline.name}-watchdog",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            if t.is_alive():
                log.warning("%s: watchdog thread leaked past stop()",
                            self.pipeline.name)
            self._thread = None

    # -- sampling ------------------------------------------------------------
    def _progress_vector(self) -> Tuple[int, ...]:
        """Monotone counters that advance whenever any frame moves."""
        pipe = self.pipeline
        total = 0
        for el in list(pipe.elements) + list(pipe._regions or ()):
            total += el.stats.total_invokes
        delivered = 0
        for ex in pipe._lane_execs or ():
            delivered += ex._delivered
        return (total, delivered)

    def _inflight_evidence(self) -> List[str]:
        """Names of elements that hold undelivered work — the idle-vs-
        stalled discriminator and the trip message's suspect list."""
        pipe = self.pipeline
        suspects: List[str] = []
        # fused regions are spliced, not in pipe.elements; their dispatch
        # windows hold the in-flight work of their members
        for el in list(pipe.elements) + list(pipe._regions or ()):
            depth = getattr(el, "_depth", None)
            if depth is not None and depth() > 0:
                suspects.append(f"{el.name} (queue depth {depth()})")
            window = getattr(el, "_window", None)
            if window is not None and len(window) > 0:
                suspects.append(
                    f"{el.name} (dispatch window {len(window)} in flight)")
        for ex in pipe._lane_execs or ():
            backlog = ex._seq - ex._delivered
            if backlog > 0:
                suspects.append(f"{ex.name} (reorder backlog {backlog})")
        if any(t.is_alive() for t in pipe._threads):
            suspects.append("live source thread")
        return suspects

    def _run(self) -> None:
        from nnstreamer_tpu_torch.pipeline.pipeline import State

        last = self._progress_vector()
        last_t = time.monotonic()
        while not self._stop_evt.wait(self.poll_s):
            if self.pipeline.state is not State.PLAYING:
                last_t = time.monotonic()
                continue
            cur = self._progress_vector()
            now = time.monotonic()
            if cur != last:
                last, last_t = cur, now
                continue
            if now - last_t < self.deadline_s:
                continue
            suspects = self._inflight_evidence()
            if not suspects:
                # quiescent, not stalled (post-EOS idle): keep watching
                last_t = now
                continue
            self._trip(now - last_t, suspects)
            return  # one trip per run: teardown is already in motion

    def _trip(self, stalled_s: float, suspects: List[str]) -> None:
        self.trips += 1
        self._m_trips.inc()
        tl = _timeline.ACTIVE
        if tl is not None:
            tl.mark("watchdog_trip", None, track="faults",
                    stalled_s=round(stalled_s, 3))
        err = FlowError(
            f"watchdog: no pipeline progress for {stalled_s:.1f}s "
            f"(deadline {self.deadline_s:.1f}s) with work in flight — "
            f"{'; '.join(suspects)}")
        log.error("%s: %s", self.pipeline.name, err)
        # park the sources so no new frames pile onto the stall, then
        # fail the pipeline: wait()/run() returns the error and stop()
        # fences what it can on the way down
        from nnstreamer_tpu_torch.pipeline.pipeline import SourceElement

        for el in self.pipeline.elements:
            if isinstance(el, SourceElement):
                el._stop_evt.set()
        # the JAX watchdog also frees the pools' idle slabs here; dropping
        # a page-locked slab may call CUDA, so in the port that waits for
        # Pipeline.stop(), which frees them on every teardown
        self.pipeline.post_error(None, err)
