"""Transport resilience — the policy layer under the query/gRPC/MQTT hops.

Every ROADMAP scale-out item (multi-chip fan-out, multi-tenant front
end, edge-cloud split pipelines) rides a network hop, and a hop is only
as strong as its failure story. This module holds the mechanism pieces
that story is built from; the transports compose them:

- :class:`RetryPolicy` — bounded exponential backoff with deterministic
  jitter (same pure-function discipline as ``pipeline/supervise.py``'s
  ``_backoff_sleep``: the delay for (key, attempt) is reproducible, so a
  seeded chaos run replays the same recovery timeline).
- :class:`CircuitBreaker` — per-endpoint closed/open/half-open breaker.
  A dead endpoint costs one connect timeout per reset window instead of
  one per frame; a half-open probe re-closes it on the first success.
- :class:`EndpointStats` — EWMA + reservoir-p99 latency tracker. Its
  :meth:`~EndpointStats.hedge_timeout` is the p99-based hedge timer: a
  recv that outlives it fails over to the next replica instead of
  waiting out the full protocol timeout.
- :class:`DedupWindow` — server-side idempotency: a bounded per-client
  map of request-id → pending/cached-reply. Reconnect resends and
  hedged duplicates replay the cached reply; they never double-invoke.
- :class:`PendingEntry` — one in-flight request on a reliable client
  connection: enough state (packed body, deadline) to resend the
  undelivered suffix in order after a reconnect.
- :func:`note_remote_shed` — the scheduler hook: when the remote SLO
  scheduler sheds a propagated-deadline frame, the origin server sends
  the client an EXPIRED notice so the slot frees instead of timing out.

Deadline propagation itself rides the extended wire commands in
``query/protocol.py`` (``TRANSFER_EX`` carries ``(req_id, slack_s)``);
the client half lives in ``elements/query.py`` (``reliable=true``), the
server half in ``query/server.py``. Everything is off by default: no
knob set means no extended command ever crosses the wire and the
protocol bytes are identical to a build without this module.

Metrics (NNS106 ``nns_net_`` prefix):

- ``nns_net_retries_total``        — frames resent after a reconnect
- ``nns_net_hedges_total``         — hedged failovers to another replica
- ``nns_net_breaker_state``        — per-endpoint gauge (0 closed /
  1 open / 2 half-open)
- ``nns_net_dedup_hits_total``     — duplicate requests absorbed by the
  server dedup window (the zero-double-invoke witness)
- ``nns_net_deadline_expired_remote_total`` — frames the remote end
  expired (on arrival or via a scheduler shed) instead of serving late

Port of ``nnstreamer_tpu/query/resilience.py``: a copy with its imports
rewritten. A reply a :class:`DedupWindow` caches is the packed wire frame
(``(command, bytes)``), so a window never holds a device tensor.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from nnstreamer_tpu_torch.log import get_logger

log = get_logger("resilience")

#: breaker states (the ``nns_net_breaker_state`` gauge values)
CLOSED, OPEN, HALF_OPEN = 0, 1, 2

#: hedge timer = max(configured floor, p99 * this factor) — the EWMA
#: must blow well past the tail estimate before a failover fires
HEDGE_P99_FACTOR = 1.5

#: a retry ladder must never park a streaming thread longer than this
#: per attempt (same ceiling as pipeline/supervise.py)
BACKOFF_CAP_S = 2.0


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------
_METRICS: Optional[Dict[str, Any]] = None
_BREAKER_GAUGES: Dict[str, Any] = {}
_METRICS_LOCK = threading.Lock()


def metrics() -> Dict[str, Any]:
    """Lazy shared counters (safe to call from any transport thread)."""
    global _METRICS
    if _METRICS is None:
        with _METRICS_LOCK:
            if _METRICS is None:
                from nnstreamer_tpu_torch.obs import get_registry

                reg = get_registry()
                _METRICS = {
                    "retries": reg.counter(
                        "nns_net_retries_total",
                        "Frames resent over a rebuilt transport "
                        "connection"),
                    "hedges": reg.counter(
                        "nns_net_hedges_total",
                        "Hedged failovers to another replica after the "
                        "hedge timer fired"),
                    "dedup_hits": reg.counter(
                        "nns_net_dedup_hits_total",
                        "Duplicate requests absorbed by the server dedup "
                        "window (replayed or dropped, never re-invoked)"),
                    "expired_remote": reg.counter(
                        "nns_net_deadline_expired_remote_total",
                        "Frames expired at the remote end (deadline "
                        "propagation: shed on arrival or by the remote "
                        "scheduler)"),
                }
    return _METRICS


def breaker_gauge(endpoint: str):
    """Per-endpoint ``nns_net_breaker_state`` gauge, cached by label."""
    g = _BREAKER_GAUGES.get(endpoint)
    if g is None:
        with _METRICS_LOCK:
            g = _BREAKER_GAUGES.get(endpoint)
            if g is None:
                from nnstreamer_tpu_torch.obs import get_registry

                g = get_registry().gauge(
                    "nns_net_breaker_state",
                    "Circuit-breaker state per endpoint "
                    "(0 closed / 1 open / 2 half-open)",
                    endpoint=endpoint)
                _BREAKER_GAUGES[endpoint] = g
    return g


# --------------------------------------------------------------------------
# retry / backoff
# --------------------------------------------------------------------------
class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter.

    ``delay(attempt)`` is a pure function of ``(key, attempt)`` — a
    string-seeded RNG (sha512-hashed, PYTHONHASHSEED-independent), so a
    seeded chaos run reproduces the same recovery timeline across
    processes. ``attempt`` is 1-based.
    """

    def __init__(self, base_ms: float = 50.0, cap_s: float = BACKOFF_CAP_S,
                 key: str = ""):
        self.base_s = max(0.0, float(base_ms)) / 1e3
        self.cap_s = float(cap_s)
        self.key = key

    def delay(self, attempt: int) -> float:
        d = min(self.base_s * (2 ** (max(1, attempt) - 1)), self.cap_s)
        jitter = 0.5 + 0.5 * random.Random(
            f"{self.key}:{attempt}").random()
        return d * jitter

    def sleep(self, attempt: int) -> float:
        d = self.delay(attempt)
        if d > 0:
            time.sleep(d)
        return d


# --------------------------------------------------------------------------
# circuit breaker
# --------------------------------------------------------------------------
class CircuitBreaker:
    """Per-endpoint closed → open → half-open breaker.

    - **closed**: all traffic allowed; ``failures`` consecutive recorded
      failures trip it open.
    - **open**: :meth:`allow` refuses until ``reset_s`` elapses, then the
      breaker moves to half-open and admits probes.
    - **half-open**: traffic allowed; the first success re-closes, the
      first failure re-opens (and restarts the reset clock).

    Thread-safe; state changes mirror into the per-endpoint
    ``nns_net_breaker_state`` gauge when ``endpoint`` is set.
    """

    def __init__(self, failures: int = 5, reset_s: float = 1.0,
                 endpoint: str = ""):
        self.failure_threshold = max(1, int(failures))
        self.reset_s = max(0.0, float(reset_s))
        self.endpoint = endpoint
        self._lock = threading.Lock()
        self._state = CLOSED
        self._fail_count = 0
        self._opened_t = 0.0
        #: state transition log (monotonic_t, state) — chaos-test witness
        self.transitions: List[Tuple[float, int]] = []

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    def _set_state(self, state: int, now: float) -> None:
        if state == self._state:
            return
        self._state = state
        self.transitions.append((now, state))
        if self.endpoint:
            breaker_gauge(self.endpoint).set(state)

    def allow(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._state == OPEN:
                if now - self._opened_t >= self.reset_s:
                    self._set_state(HALF_OPEN, now)
                    return True
                return False
            return True

    def record_success(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._fail_count = 0
            self._set_state(CLOSED, now)

    def record_failure(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._fail_count += 1
            if self._state == HALF_OPEN or \
                    self._fail_count >= self.failure_threshold:
                self._opened_t = now
                self._set_state(OPEN, now)


# --------------------------------------------------------------------------
# endpoint latency stats / hedge timer
# --------------------------------------------------------------------------
class EndpointStats:
    """EWMA + bounded-reservoir p99 of round-trip latencies.

    The hedge timer is ``max(floor, p99 * HEDGE_P99_FACTOR)`` once at
    least :attr:`MIN_SAMPLES` observations exist; before that, the
    configured floor alone (a cold endpoint must not hedge off noise).
    """

    MIN_SAMPLES = 8

    def __init__(self, alpha: float = 0.2, window: int = 128):
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._ewma: Optional[float] = None
        self._sample: Deque[float] = deque(maxlen=max(8, int(window)))

    def observe(self, rtt_s: float) -> None:
        rtt_s = max(0.0, float(rtt_s))
        with self._lock:
            self._ewma = rtt_s if self._ewma is None else \
                (1 - self.alpha) * self._ewma + self.alpha * rtt_s
            self._sample.append(rtt_s)

    def ewma(self) -> Optional[float]:
        with self._lock:
            return self._ewma

    def p99(self) -> Optional[float]:
        with self._lock:
            if len(self._sample) < self.MIN_SAMPLES:
                return None
            ordered = sorted(self._sample)
        idx = min(len(ordered) - 1, round(0.99 * (len(ordered) - 1)))
        return ordered[idx]

    def hedge_timeout(self, floor_s: float) -> float:
        p = self.p99()
        if p is None:
            return floor_s
        return max(floor_s, p * HEDGE_P99_FACTOR)


# --------------------------------------------------------------------------
# idempotent delivery
# --------------------------------------------------------------------------
#: DedupWindow.admit verdicts
NEW = "new"
PENDING = "pending"


class DedupWindow:
    """Bounded request-id → pending/cached-reply map (server side).

    One window per client *instance* (the HELLO-announced identity that
    survives reconnects), so a resend after a connection flap lands in
    the same window as the original:

    - :meth:`admit` returns :data:`NEW` for a first-seen id (marks it
      pending), :data:`PENDING` while the original invocation is still
      in flight (drop the duplicate — its reply will route to the
      instance's current connection), or the cached reply tuple for an
      already-resolved id (replay it, don't re-invoke).
    - :meth:`resolve` stores the serialized reply for future replays.

    Bounded FIFO: oldest entries fall out past ``size``. Size it to
    cover the client's in-flight window plus a reconnect burst.
    """

    def __init__(self, size: int = 64):
        self.size = max(1, int(size))
        self._lock = threading.Lock()
        self._entries: "OrderedDict[int, Any]" = OrderedDict()

    def admit(self, req_id: int):
        with self._lock:
            got = self._entries.get(req_id)
            if got is None:
                self._entries[req_id] = PENDING
                while len(self._entries) > self.size:
                    self._entries.popitem(last=False)
                return NEW
            return got  # PENDING or the cached reply

    def forget(self, req_id: int) -> None:
        """Drop an admitted entry whose frame failed to parse — without
        this the id would sit at PENDING forever and the client's resend
        of the (now intact) frame would be swallowed as a duplicate."""
        with self._lock:
            self._entries.pop(req_id, None)

    def resolve(self, req_id: int, reply) -> None:
        with self._lock:
            self._entries[req_id] = reply
            self._entries.move_to_end(req_id)
            while len(self._entries) > self.size:
                self._entries.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- serving continuity --------------------------------------------------
    def snapshot(self) -> dict:
        """Checkpointable window state: resolved replies only. PENDING
        entries are dropped — after a restart the in-flight invocation
        is gone, and the client's resend must re-invoke, which dedup
        handles exactly as a first send."""
        with self._lock:
            entries = [(rid, reply) for rid, reply in self._entries.items()
                       if reply is not PENDING]
            # size is read under the same lock restore() resizes under
            return {"size": self.size, "entries": entries}

    def restore(self, state: dict) -> None:
        with self._lock:
            self.size = max(self.size, int(state.get("size", self.size)))
            for rid, reply in state.get("entries", ()):
                self._entries[rid] = reply
                self._entries.move_to_end(rid)
            while len(self._entries) > self.size:
                self._entries.popitem(last=False)


@dataclasses.dataclass
class PendingEntry:
    """One reliable-mode request in flight: everything a reconnect needs
    to resend it (the packed classic body — slack is recomputed from
    ``deadline_t`` at each send so a resend carries the *remaining*
    budget, not the original one)."""

    req_id: int
    pts: Optional[int]
    meta: dict
    body: bytes
    deadline_t: Optional[float] = None  # monotonic; None = no deadline
    sent_t: float = 0.0
    sent_wall: float = 0.0  # advisory wall stamp for dist-trace splits
    #: (host, port) the last send went to — RTT observations credit this
    #: endpoint's EndpointStats, not whichever endpoint is current when
    #: the result lands (a hedged result may arrive after a failover)
    endpoint: Optional[Tuple[str, int]] = None

    def slack_s(self, now: float) -> float:
        """Wire slack for this send: negative = no deadline; 0.0 = the
        deadline already passed (the server expires it on arrival)."""
        if self.deadline_t is None:
            return -1.0
        return max(0.0, self.deadline_t - now)


# --------------------------------------------------------------------------
# remote-shed hook (called from SloScheduler.note_shed)
# --------------------------------------------------------------------------
def note_remote_shed(buf) -> None:
    """A remote scheduler shed a frame that arrived with a propagated
    deadline: notify the origin client with an EXPIRED notice so its
    in-flight slot frees now instead of waiting out a recv timeout.
    No-op for frames without transport meta; never raises (the shed
    path must stay non-blocking and failure-proof)."""
    hook = buf.meta.pop("_net_expire", None)
    if hook is None:
        return
    server, instance, req_id = hook
    try:
        server.send_expired(instance, req_id)
    except Exception as e:  # noqa: BLE001 — a dead client connection
        # must not break the scheduler's shed path
        log.info("expired notice for req %d not deliverable: %s",
                 req_id, e)
