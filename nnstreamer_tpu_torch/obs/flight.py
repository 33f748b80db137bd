"""Always-on tail-latency flight recorder.

Port of ``nnstreamer_tpu/obs/flight.py`` (no JAX in it; carried over as
a copy with its imports rewritten). The Timeline (``obs/timeline.py``)
answers "where did this frame's time go?" — but only when someone turned
tracing on BEFORE the outlier happened. This module keeps a black-box
recorder running on every pipeline, always:

- :class:`FlightRecorder` is a :class:`~.timeline.Timeline` subclass
  that ``Pipeline.start()`` installs as the process-wide ``ACTIVE``
  ledger whenever no explicit/env timeline claimed the slot. Every
  existing span site feeds it unchanged — there are no new hot-path
  hooks — and it folds each frame's stage spans into a compact bounded
  stage-vector ring as the sink completes them.
- Per-stage and end-to-end latency distributions are tracked with P²
  streaming quantiles (``obs/quantiles.py`` — five markers per
  quantile, no sample storage) and exported as ``nns_stage_p50_ms`` /
  ``nns_stage_p99_ms`` gauges; with an SLO budget present, fast/slow
  burn-rate windows drive ``nns_slo_burn_rate`` and rate-limited bus
  warnings.
- Tail events — frame e2e above k× the rolling median, an SLO deadline
  breach, any fault mark, a watchdog trip — arm a *pending dump*; once
  the post-window frames have completed (so the dump shows what
  happened AFTER the offender too), the surrounding window of full span
  detail is written to a timestamped JSON file under
  ``--flight-dir`` / ``NNSTPU_FLIGHT``, rate-limited so a saturated
  pipeline produces one dump per interval, not one per frame.
- The attribution engine is the continuous version of the Timeline's
  ``variance_report``: per-stage MAD over the completed-frame ring
  names the dominant-spread stage in ``metrics_snapshot()``, and turns
  it into advisory scheduler hints (``lanes_hint`` for ingest-dominated
  spread, inflight / batch_cap pressure for fence- and hold-dominated
  spread).

On CUDA the ``device`` stage is the host's enqueue of a region's replay
or a filter's kernels, not kernel time (ROADMAP C.11): a slow kernel
shows in ``fence_wait`` and ``d2h``.

Kill switch: ``NNSTPU_FLIGHT=0`` (or false/no/off) disables the
recorder entirely — ``ACTIVE`` stays ``None`` and the off path records
nothing. Unset means recorder ON, dumps OFF; a path value enables dumps
into that directory.
"""

from __future__ import annotations

import json
import os
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from nnstreamer_tpu_torch.obs import timeline as _timeline
from nnstreamer_tpu_torch.obs.quantiles import BurnRateWindow, P2Quantile
from nnstreamer_tpu_torch.obs.registry import get_registry

_ENV = "NNSTPU_FLIGHT"
_FALSY = ("0", "false", "no", "off")
_TRUTHY = ("1", "true", "yes", "on")

#: ring capacity for completed-frame stage vectors (attribution window)
_VECTOR_CAP = 512
#: cap on in-flight (not yet sink-completed) frame accumulators
_FRAMES_CAP = 2048
#: remembered dump paths (for snapshots/tests; files persist on disk)
_DUMPS_CAP = 16


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def flight_enabled() -> bool:
    """False only when ``NNSTPU_FLIGHT`` is an explicit falsy spelling —
    the recorder is on by default (that is the point of a black box)."""
    v = os.environ.get(_ENV, "").strip()
    return not (v and v.lower() in _FALSY)


def env_dump_dir() -> Optional[str]:
    """The dump directory carried in ``NNSTPU_FLIGHT``, if it names one
    (boolean spellings keep the recorder on with dumps off)."""
    v = os.environ.get(_ENV, "").strip()
    if not v or v.lower() in _FALSY + _TRUTHY:
        return None
    return v


class FlightRecorder(_timeline.Timeline):
    """Bounded always-on frame ledger with tail-event dump, streaming
    SLO quantiles, and continuous variance attribution."""

    def __init__(self, capacity: int = 4096, *,
                 dump_dir: Optional[str] = None,
                 slo_budget_s: Optional[float] = None,
                 tail_k: Optional[float] = None,
                 window_frames: Optional[int] = None,
                 min_interval_s: Optional[float] = None,
                 min_samples: Optional[int] = None,
                 pipeline=None):
        super().__init__(capacity)
        self.dump_dir = dump_dir
        self.slo_budget_s = slo_budget_s
        #: a frame is a tail event when its e2e exceeds k× rolling median
        self.tail_k = tail_k if tail_k is not None else \
            _env_float("NNSTPU_FLIGHT_K", 4.0)
        #: frames of full span detail kept around the offender in a dump
        self.window_frames = int(window_frames) if window_frames else \
            int(_env_float("NNSTPU_FLIGHT_WINDOW", 8))
        #: minimum seconds between dump files (rate limiter)
        self.min_interval_s = min_interval_s if min_interval_s is not None \
            else _env_float("NNSTPU_FLIGHT_INTERVAL_S", 30.0)
        #: completions before the rolling-median trigger arms (a cold
        #: first frame must not dump)
        self.min_samples = int(min_samples) if min_samples else \
            int(_env_float("NNSTPU_FLIGHT_MIN_SAMPLES", 16))
        self.pipeline_name = getattr(pipeline, "name", None) or "pipeline"
        self._pipe_ref = weakref.ref(pipeline) if pipeline is not None \
            else None

        self._fl_lock = threading.Lock()
        # per-stage + end-to-end streaming quantiles, pre-created so
        # gauge callbacks read them without taking the lock
        self._q: Dict[str, Dict[str, P2Quantile]] = {
            name: {"p50": P2Quantile(0.5), "p99": P2Quantile(0.99)}
            for name in _timeline.STAGES + ("e2e", "e2e_admitted")
        }
        #: completed per-frame stage vectors — the attribution window
        self._vectors: deque = deque(maxlen=_VECTOR_CAP)
        #: seq -> accumulating stage durations for in-flight frames
        self._frames: Dict[int, Dict[str, float]] = {}
        self._completed = 0
        self._rolling_med: Optional[float] = None

        # SLO burn: fast window catches an active incident, slow window
        # confirms it is material; warn only when both burn hot
        self.burn_fast = BurnRateWindow(_env_float(
            "NNSTPU_FLIGHT_BURN_FAST_S", 5.0))
        self.burn_slow = BurnRateWindow(_env_float(
            "NNSTPU_FLIGHT_BURN_SLOW_S", 60.0))
        self.burn_warn_threshold = _env_float(
            "NNSTPU_FLIGHT_BURN_WARN", 2.0)
        self._last_warn_mono: Optional[float] = None

        # tail-event dump machinery
        self._pending: Optional[Dict[str, Any]] = None
        self._last_dump_mono: Optional[float] = None
        self.dump_paths: deque = deque(maxlen=_DUMPS_CAP)
        self.dump_count = 0
        self.suppressed_dumps = 0
        self.trigger_counts: Dict[str, int] = {}
        self.last_trigger: Optional[Dict[str, Any]] = None

    # -- recording (hot path) -------------------------------------------------
    def span(self, kind: str, seq: Optional[int], t0: float, t1: float,
             track: Optional[str] = None, **args) -> None:
        super().span(kind, seq, t0, t1, track, **args)
        if seq is None:
            return
        if kind in self._q:
            with self._fl_lock:
                d = self._frames.get(seq)
                if d is None:
                    if len(self._frames) >= _FRAMES_CAP:
                        self._prune_frames_locked()
                    d = self._frames[seq] = {}
                d[kind] = d.get(kind, 0.0) + (t1 - t0)
        if kind == "sink" and args and "e2e_s" in args:
            adm = args.get("e2e_adm_s")
            self._complete(seq, float(args["e2e_s"]),
                           float(adm) if adm is not None else None, t1)

    def mark(self, kind: str, seq: Optional[int],
             t: Optional[float] = None, track: Optional[str] = None,
             **args) -> None:
        if t is None:
            t = time.monotonic()
        super().mark(kind, seq, t, track, **args)
        # every fault-track mark is a trigger: injected/real faults
        # (``fault``), supervision outcomes (``fault_skip`` /
        # ``fault_retry`` / ``fault_degrade``), watchdog trips. The
        # watchdog means the pipeline may be wedged — flush immediately
        # rather than waiting for post-window completions that may
        # never come.
        if track == "faults":
            detail = {"mark": kind}
            if args:
                detail.update(args)
            trig = "watchdog" if kind == "watchdog_trip" else "fault"
            self._trigger(trig, seq, t, detail,
                          immediate=(trig == "watchdog"))

    def _prune_frames_locked(self) -> None:
        # drop the oldest in-flight accumulators (shed/errored frames
        # never reach the sink, so the map needs a pressure valve)
        drop = max(len(self._frames) - _FRAMES_CAP + 1,
                   _FRAMES_CAP // 8)
        for s in sorted(self._frames)[:drop]:
            del self._frames[s]

    def frame_stages(self, seq: int) -> Dict[str, float]:
        """One frame's accumulated stage durations — O(1) from the
        in-flight accumulator (overrides the Timeline's ring scan); a
        frame that already completed is found in the attribution ring.
        This is the span-vector source a query server reads at result
        egress (obs/distributed)."""
        with self._fl_lock:
            d = self._frames.get(seq)
            if d is not None:
                return dict(d)
            for s, vec in reversed(self._vectors):
                if s == seq:
                    return {k: v for k, v in vec.items() if k != "e2e"}
        return {}

    # -- completion -----------------------------------------------------------
    def _complete(self, seq: int, e2e_s: float,
                  e2e_adm_s: Optional[float], t: float) -> None:
        with self._fl_lock:
            vec = self._frames.pop(seq, None) or {}
            vec["e2e"] = e2e_s
            self._vectors.append((seq, vec))
            self._completed += 1
            completed = self._completed
        for kind, dur in vec.items():
            if kind != "e2e" and kind in self._q:
                self._q[kind]["p50"].observe(dur)
                self._q[kind]["p99"].observe(dur)
        self._q["e2e"]["p50"].observe(e2e_s)
        self._q["e2e"]["p99"].observe(e2e_s)
        if e2e_adm_s is not None:
            self._q["e2e_admitted"]["p50"].observe(e2e_adm_s)
            self._q["e2e_admitted"]["p99"].observe(e2e_adm_s)
        med = self._q["e2e"]["p50"].quantile()
        with self._fl_lock:
            self._rolling_med = med

        budget = self.slo_budget_s
        if budget is not None and budget > 0:
            lat = e2e_adm_s if e2e_adm_s is not None else e2e_s
            breached = lat > budget
            self.burn_fast.add(t, breached)
            self.burn_slow.add(t, breached)
            if breached:
                self._trigger("deadline", seq, t,
                              {"e2e_ms": round(lat * 1e3, 3),
                               "budget_ms": round(budget * 1e3, 3)})
            self._maybe_warn_burn(t)
        if (completed >= self.min_samples and med is not None
                and med > 0 and e2e_s > self.tail_k * med):
            self._trigger("tail", seq, t,
                          {"e2e_ms": round(e2e_s * 1e3, 3),
                           "median_ms": round(med * 1e3, 3),
                           "k": self.tail_k})
        # a pending dump flushes once the post-offender window completed
        # (read under the lock: _trigger — possibly just called above —
        # installs _pending under it)
        with self._fl_lock:
            pending = self._pending
        if pending is not None and pending["seq"] is not None \
                and seq >= pending["seq"] + self.window_frames:
            self._flush()

    # -- triggers & dumps -----------------------------------------------------
    def _trigger(self, kind: str, seq: Optional[int], t: float,
                 detail: Dict[str, Any], immediate: bool = False) -> None:
        with self._fl_lock:
            self.trigger_counts[kind] = self.trigger_counts.get(kind, 0) + 1
            self.last_trigger = {"kind": kind, "seq": seq,
                                 "detail": detail}
            if self._pending is None:
                self._pending = {"kind": kind, "seq": seq, "t": t,
                                 "detail": detail}
        if immediate:
            self._flush()

    def _flush(self) -> None:
        """Write the pending dump if the rate limiter allows it."""
        with self._fl_lock:
            pending = self._pending
            if pending is None:
                return
            self._pending = None
            now = time.monotonic()
            if self._last_dump_mono is not None and \
                    now - self._last_dump_mono < self.min_interval_s:
                self.suppressed_dumps += 1
                return
            if not self.dump_dir:
                return
            self._last_dump_mono = now
            self.dump_count += 1
            n = self.dump_count
        try:
            path = self._write_dump(pending, n)
        except OSError:
            return  # an unwritable flight dir must not take down serving
        self.dump_paths.append(path)

    def _write_dump(self, pending: Dict[str, Any], n: int) -> str:
        seq = pending["seq"]
        lo = hi = None
        if seq is not None:
            lo, hi = seq - self.window_frames, seq + self.window_frames
        spans: List[Dict[str, Any]] = []
        for thread, kind, s, t0, t1, track, args in self._snapshot():
            in_window = (lo is None or
                         (s is not None and lo <= s <= hi) or
                         track == "faults")
            if not in_window:
                continue
            spans.append({
                "thread": thread, "kind": kind, "seq": s,
                "t0_ms": round((t0 - self.epoch) * 1e3, 3),
                "t1_ms": round((t1 - self.epoch) * 1e3, 3)
                if t1 is not None else None,
                "track": track, "args": args,
            })
        with self._fl_lock:
            frames = {
                str(s): {k: round(v * 1e3, 4) for k, v in vec.items()}
                for s, vec in self._vectors
                if lo is None or lo <= s <= hi
            }
        doc = {
            "trigger": {"kind": pending["kind"], "seq": seq,
                        "t_ms": round((pending["t"] - self.epoch) * 1e3, 3),
                        "detail": pending["detail"]},
            "window": {"frames_before": self.window_frames,
                       "frames_after": self.window_frames,
                       "seq_lo": lo, "seq_hi": hi},
            "pipeline": self.pipeline_name,
            "wall_time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "frames_ms": frames,
            "spans": spans,
            "slo": self.slo_snapshot(),
            "attribution": self.attribution(),
        }
        os.makedirs(self.dump_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%dT%H%M%S")
        path = os.path.join(
            self.dump_dir,
            f"flight-{stamp}-{n:03d}-{pending['kind']}.json")
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        return path

    def flush_pending(self) -> None:
        """Force the pending dump out (pipeline stop / retirement): an
        offender near EOS must not lose its dump to the post-window
        completion wait."""
        self._flush()

    # -- burn-rate warning ----------------------------------------------------
    def burn_rates(self, now: Optional[float] = None
                   ) -> Tuple[float, float]:
        if now is None:
            now = time.monotonic()
        return self.burn_fast.rate(now), self.burn_slow.rate(now)

    def burn_overload(self, now: Optional[float] = None) -> bool:
        """True while BOTH burn windows exceed the warn threshold — the
        scheduler treats this as an overload signal."""
        if self.slo_budget_s is None:
            return False
        fast, slow = self.burn_rates(now)
        return fast > self.burn_warn_threshold and \
            slow > self.burn_warn_threshold

    def _maybe_warn_burn(self, now: float) -> None:
        if not self.burn_overload(now):
            return
        if self._last_warn_mono is not None and \
                now - self._last_warn_mono < 10.0:
            return
        self._last_warn_mono = now
        pipe = self._pipe_ref() if self._pipe_ref is not None else None
        if pipe is None:
            return
        fast, slow = self.burn_rates(now)
        pipe.post_warning(
            None, f"SLO burn rate high: fast={fast:.1f}x "
            f"slow={slow:.1f}x of error budget "
            f"(budget {self.slo_budget_s * 1e3:.0f} ms)")

    # -- snapshots ------------------------------------------------------------
    def slo_snapshot(self) -> Dict[str, Any]:
        """Stage/e2e streaming quantiles + burn rates — the
        ``metrics_snapshot()["slo"]`` section."""
        now = time.monotonic()
        stages: Dict[str, Any] = {}
        for name, qs in self._q.items():
            c = qs["p50"].count
            if c == 0:
                continue
            p50 = qs["p50"].quantile()
            p99 = qs["p99"].quantile()
            stages[name] = {
                "p50_ms": round((p50 or 0.0) * 1e3, 4),
                "p99_ms": round((p99 or 0.0) * 1e3, 4),
                "count": c,
            }
        out: Dict[str, Any] = {
            "stages": stages,
            # a monotonic int: a snapshot reads it at worst one frame
            # stale, never torn
            "completed": self._completed,  # nns-lint: disable=NNS201 -- monotonic int; an export snapshot at worst reads one frame stale, never torn
        }
        if self.slo_budget_s is not None:
            fast, slow = self.burn_rates(now)
            out["burn"] = {
                "budget_ms": round(self.slo_budget_s * 1e3, 3),
                "fast": round(fast, 4),
                "slow": round(slow, 4),
                "warn_threshold": self.burn_warn_threshold,
                "overloaded": self.burn_overload(now),
            }
        if self.dump_count or self.suppressed_dumps or self.last_trigger:
            out["dumps"] = {
                "written": self.dump_count,
                "suppressed": self.suppressed_dumps,
                "paths": list(self.dump_paths),
                "last_trigger": self.last_trigger,
                "triggers": dict(self.trigger_counts),
            }
        return out

    def quantile_states(self) -> Dict[str, Dict[str, dict]]:
        """Serializable P² marker states per stage — what a replica's
        ``/metrics.json`` exposes so a FederatedMetrics aggregator can
        marker-merge fleet quantiles without ever shipping samples."""
        return {name: {w: q.snapshot() for w, q in qs.items()}
                for name, qs in self._q.items()
                if qs["p50"].count > 0}

    def attribution(self) -> Dict[str, Any]:
        """Continuous variance attribution over the completed-frame
        ring: per-stage MAD vs e2e MAD, dominant stage, and advisory
        scheduler hints."""
        with self._fl_lock:
            done = [vec for _, vec in self._vectors]
        base = {"frames": len(done), "e2e_mad_ms": 0.0,
                "stage_mad_ms": {}, "dominant_stage": None,
                "dominant_share": 0.0, "hints": {}}
        if len(done) < 8:
            return base

        def _mad(vals: List[float]) -> float:
            vals = sorted(vals)
            med = vals[len(vals) // 2]
            dev = sorted(abs(v - med) for v in vals)
            return dev[len(dev) // 2]

        stage_mad = {k: _mad([d.get(k, 0.0) for d in done]) * 1e3
                     for k in _timeline.STAGES}
        e2e_mad = _mad([d.get("e2e", 0.0) for d in done]) * 1e3
        dominant = max(stage_mad, key=lambda k: stage_mad[k])
        if stage_mad[dominant] <= 0.0:
            return base
        hints: Dict[str, Any] = {}
        if dominant in ("ingest", "lane_reorder"):
            # host-side ingest spread: more lanes absorb it
            hints["lanes_hint_delta"] = 1
        elif dominant == "fence_wait":
            # frames block on the dispatch window's own fence: the
            # inflight target is too high for the device's service rate
            hints["inflight_pressure"] = True
        elif dominant in ("sched_hold", "queue_wait"):
            # spread accumulates while parked pre-dispatch: batches form
            # too slowly / too large for the arrival pattern
            hints["batch_cap_pressure"] = True
        base.update({
            "e2e_mad_ms": round(e2e_mad, 4),
            "stage_mad_ms": {k: round(v, 4)
                             for k, v in stage_mad.items()},
            "dominant_stage": dominant,
            "dominant_share": round(stage_mad[dominant] / e2e_mad, 4)
            if e2e_mad > 0 else 0.0,
            "hints": hints,
        })
        return base

    # -- serving continuity ---------------------------------------------------
    def checkpoint_state(self) -> Dict[str, Any]:
        """Durable recorder state for ``Pipeline.checkpoint()``: the P²
        marker sets (so stage/e2e quantile gauges resume warm), the
        completed-frame attribution ring, and the completion count.
        Burn-rate windows are NOT included — their events are anchored
        to this process's monotonic clock and a restored breach history
        would fire stale overload signals in the new process."""
        with self._fl_lock:
            vectors = list(self._vectors)
            completed = self._completed
            rolling_med = self._rolling_med
        return {
            "quantiles": {name: {w: q.snapshot() for w, q in qs.items()}
                          for name, qs in self._q.items()},
            "vectors": vectors,
            "completed": completed,
            "rolling_med": rolling_med,
        }

    def restore_state(self, state: Dict[str, Any]) -> None:
        for name, pair in (state.get("quantiles") or {}).items():
            qs = self._q.get(name)
            if qs is None:
                continue
            for w, qstate in pair.items():
                q = qs.get(w)
                if q is not None:
                    q.restore(qstate)
        med = state.get("rolling_med")
        with self._fl_lock:
            self._vectors.extend(state.get("vectors") or ())
            self._completed = int(state.get("completed", 0))
            self._rolling_med = float(med) if med is not None else None

    # -- gauges ---------------------------------------------------------------
    def register_gauges(self) -> None:
        """Export the streaming quantiles and burn rates through the
        process registry (both Prometheus text and the JSON snapshot go
        through ``collect()``, so one registration serves both)."""
        reg = get_registry()
        ref = weakref.ref(self)

        def _q_fn(name: str, which: str):
            def read() -> float:
                fr = ref()
                if fr is None:
                    return 0.0
                v = fr._q[name][which].quantile()
                return (v or 0.0) * 1e3
            return read

        def _burn_fn(window: str):
            def read() -> float:
                fr = ref()
                if fr is None or fr.slo_budget_s is None:
                    return 0.0
                fast, slow = fr.burn_rates()
                return fast if window == "fast" else slow
            return read

        labels = {"pipeline": self.pipeline_name}
        for name in _timeline.STAGES + ("e2e", "e2e_admitted"):
            reg.gauge("nns_stage_p50_ms",
                      "Streaming P2 median of per-frame stage seconds "
                      "(flight recorder)",
                      fn=_q_fn(name, "p50"), stage=name, **labels)
            reg.gauge("nns_stage_p99_ms",
                      "Streaming P2 p99 of per-frame stage seconds "
                      "(flight recorder)",
                      fn=_q_fn(name, "p99"), stage=name, **labels)
        for window in ("fast", "slow"):
            reg.gauge("nns_slo_burn_rate",
                      "SLO error-budget burn rate over the fast/slow "
                      "alerting window (1.0 = sustainable)",
                      fn=_burn_fn(window), window=window, **labels)


def maybe_install(pipeline) -> Optional[FlightRecorder]:
    """``Pipeline.start()`` hook: install the always-on recorder as the
    process-wide ledger unless tracing already claimed the slot or
    ``NNSTPU_FLIGHT`` says no. Returns the installed recorder."""
    if not flight_enabled():
        return None
    if _timeline.ACTIVE is not None:
        # an explicit or NNSTPU_TRACE timeline wins: it records the
        # same spans at full capacity, and the flight machinery would
        # only double the hot-path work
        return None
    budget_s: Optional[float] = None
    sched = getattr(pipeline, "_slo_scheduler", None)
    if sched is not None:
        budget_s = getattr(sched, "budget_s", None)
    elif getattr(pipeline, "slo_budget_ms", 0.0) > 0:
        budget_s = pipeline.slo_budget_ms / 1e3
    fr = FlightRecorder(
        capacity=int(_env_float("NNSTPU_FLIGHT_CAPACITY", 4096)),
        dump_dir=getattr(pipeline, "flight_dir", None) or env_dump_dir(),
        slo_budget_s=budget_s,
        pipeline=pipeline)
    fr._env_owned = False
    _timeline.ACTIVE = fr
    fr.register_gauges()
    return fr


def retire(fr: Optional[FlightRecorder]) -> None:
    """``Pipeline.stop()`` hook: flush any pending dump and release the
    process-wide slot (the recorder object stays readable — the CLI's
    post-EOS footer reads its snapshots after stop)."""
    if fr is None:
        return
    fr.flush_pending()
    if _timeline.ACTIVE is fr:
        _timeline.ACTIVE = None


class LMTokenStats:
    """Per-token serving-latency quantiles for ONE decode engine —
    the flight recorder's LM-serving split: time-to-first-token (queue
    wait + prefill + first sample, the interactive-feel number) tracked
    separately from the steady-state inter-token interval (decode
    throughput per stream). Four P² estimators, no sample storage,
    exported as ``nns_lm_ttft_p50/p99_ms`` and
    ``nns_lm_token_p50/p99_ms`` gauges labeled by engine.

    Gauges read through a weakref so a dropped engine (and its stats)
    unregisters cleanly instead of pinning itself via the registry.
    """

    def __init__(self, engine: str):
        self._q = {
            "ttft": {"p50": P2Quantile(0.5), "p99": P2Quantile(0.99)},
            "token": {"p50": P2Quantile(0.5), "p99": P2Quantile(0.99)},
        }
        reg = get_registry()
        ref = weakref.ref(self)

        def _q_fn(name, which):
            def read():
                st = ref()
                if st is None:
                    return 0.0
                v = st._q[name][which].quantile()
                return (v or 0.0) * 1e3

            return read

        for which in ("p50", "p99"):
            reg.gauge(f"nns_lm_ttft_{which}_ms",
                      "time-to-first-token (submit -> first emitted "
                      "token), streaming quantile",
                      fn=_q_fn("ttft", which), engine=engine)
            reg.gauge(f"nns_lm_token_{which}_ms",
                      "steady-state inter-token interval per stream, "
                      "streaming quantile",
                      fn=_q_fn("token", which), engine=engine)

    def observe_ttft(self, seconds: float) -> None:
        self._q["ttft"]["p50"].observe(seconds)
        self._q["ttft"]["p99"].observe(seconds)

    def observe_token(self, seconds: float) -> None:
        self._q["token"]["p50"].observe(seconds)
        self._q["token"]["p99"].observe(seconds)
