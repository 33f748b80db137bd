"""Join-shortest-slack endpoint selection — the fleet's front door.

A replicated serving fleet (``serving/fleet.py``) is N interchangeable
``tensor_query_server`` replicas behind one discovery operation. The
client-side balancer (``tensor_query_client balance=shortest-slack``)
scores every live, breaker-closed endpoint by its *expected completion
time* for the next frame and routes to the argmin — the endpoint whose
admitted work leaves the most slack. The score composes three signals,
freshest first:

1. the client's own in-flight count to that endpoint (updated per send,
   the only per-request-fresh signal);
2. the per-endpoint RTT EWMA from ``resilience.EndpointStats`` (updated
   per result);
3. the load block from the replica's refreshed discovery ad
   (``queue_depth`` / ``service_ms`` / ``slack_headroom_ms`` out of the
   ``SloScheduler`` snapshot, updated at the ad-refresh cadence).

Pre-fleet ads carry no ``load`` block and parse as *load-unknown*
(:func:`parse_ad_load` returns ``None``): the balancer falls back to
RTT + local in-flight alone, so a mixed fleet of old and new replicas
still balances. Everything here is a pure function of its arguments —
no sockets, no clocks — so the policy is unit-testable in isolation.

Metrics (NNS106 ``nns_lb_`` prefix):

- ``nns_lb_route_total{endpoint}`` — frames routed per endpoint
- ``nns_lb_score_ms``              — the winning score of the last route

Port of ``nnstreamer_tpu/query/balance.py``: a copy (it imports nothing
of the package but the metrics registry).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: balance property values (tensor_query_client)
MODE_OFF = "off"
MODE_SHORTEST_SLACK = "shortest-slack"

#: RTT assumed for an endpoint with no samples yet (seconds): below any
#: real network RTT, so a cold replica out-scores warmed-up siblings and
#: gets probed immediately (one result gives it a real EWMA), but
#: nonzero so the tie against an idle sibling still breaks on load
DEFAULT_RTT_S = 0.0005


@dataclasses.dataclass(frozen=True)
class EndpointLoad:
    """The live load block a refreshed discovery ad carries."""

    #: frames sitting in the replica's ingress queue ahead of a new send
    queue_depth: int = 0
    #: scheduler's per-frame service-time estimate (EWMA), milliseconds
    service_ms: Optional[float] = None
    #: budget minus the expected wait of a newly admitted frame,
    #: milliseconds; negative = the replica is already over budget
    slack_headroom_ms: Optional[float] = None


def parse_ad_load(info: Optional[dict]) -> Optional[EndpointLoad]:
    """Parse the ``load`` block out of a discovery-ad payload.

    ``None`` for pre-fleet ads (no ``load`` key) and for malformed
    blocks: load-unknown, the balancer scores on RTT + local in-flight
    alone — the compat contract that lets a PR-20 client balance across
    replicas still running older builds."""
    load = (info or {}).get("load")
    if not isinstance(load, dict):
        return None
    try:
        svc = load.get("service_ms")
        head = load.get("slack_headroom_ms")
        return EndpointLoad(
            queue_depth=max(0, int(load.get("queue_depth", 0))),
            service_ms=float(svc) if svc is not None else None,
            slack_headroom_ms=float(head) if head is not None else None,
        )
    except (TypeError, ValueError):
        return None


def score(rtt_s: Optional[float], inflight: int,
          load: Optional[EndpointLoad]) -> float:
    """Expected completion time (seconds) of the next frame sent to this
    endpoint — lower is better.

    ``rtt_s`` None (no samples yet) scores at :data:`DEFAULT_RTT_S`.
    With a load block, queued depth converts to time through the
    replica's own service estimate; without one (load-unknown), the
    local in-flight count converts through the RTT itself — pessimistic
    but monotone, which is all join-shortest-queue needs. A negative
    slack headroom (replica over budget) adds its full deficit, pushing
    an overloaded replica to the back of the ranking even when its RTT
    history still looks good."""
    base = DEFAULT_RTT_S if rtt_s is None else max(0.0, float(rtt_s))
    per_frame = None
    if load is not None and load.service_ms:
        per_frame = max(0.0, load.service_ms) / 1e3
    if per_frame is None or per_frame <= 0.0:
        per_frame = max(base, 1e-4)
    s = base + max(0, int(inflight)) * per_frame
    if load is not None:
        s += load.queue_depth * per_frame
        if load.slack_headroom_ms is not None and \
                load.slack_headroom_ms < 0.0:
            s += -load.slack_headroom_ms / 1e3
    return s


def rank(candidates: Sequence[Tuple[Tuple[str, int], Optional[float], int,
                                    Optional[EndpointLoad]]]
         ) -> List[Tuple[float, Tuple[str, int]]]:
    """Rank ``(endpoint, rtt_s, inflight, load)`` candidates best-first.

    Breaker-open endpoints must already be excluded by the caller (the
    breaker is stateful; this module stays pure). Ties break on the
    endpoint tuple itself — (host, port) lexicographic — so two equal
    replicas always rank in the same deterministic order."""
    scored = [(score(rtt, inflight, load), ep)
              for ep, rtt, inflight, load in candidates]
    scored.sort(key=lambda t: (t[0], t[1]))
    return scored


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------
_LB_METRICS: Optional[Dict[str, Any]] = None
_ROUTE_COUNTERS: Dict[str, Any] = {}
_METRICS_LOCK = threading.Lock()


def lb_metrics() -> Dict[str, Any]:
    """Lazy shared balancer metrics (any transport thread may route)."""
    global _LB_METRICS
    if _LB_METRICS is None:
        with _METRICS_LOCK:
            if _LB_METRICS is None:
                from nnstreamer_tpu_torch.obs import get_registry

                reg = get_registry()
                _LB_METRICS = {
                    "score_ms": reg.gauge(
                        "nns_lb_score_ms",
                        "Winning shortest-slack score of the most "
                        "recent route (expected completion, ms)"),
                    "reroutes": reg.counter(
                        "nns_lb_reroutes_total",
                        "In-flight frames re-routed to another replica "
                        "after their endpoint exhausted reconnects"),
                }
    return _LB_METRICS


def route_counter(endpoint: str):
    """Per-endpoint ``nns_lb_route_total`` counter, cached by label."""
    c = _ROUTE_COUNTERS.get(endpoint)
    if c is None:
        with _METRICS_LOCK:
            c = _ROUTE_COUNTERS.get(endpoint)
            if c is None:
                from nnstreamer_tpu_torch.obs import get_registry

                c = get_registry().counter(
                    "nns_lb_route_total",
                    "Frames routed to this endpoint by the "
                    "shortest-slack balancer",
                    endpoint=endpoint)
                _ROUTE_COUNTERS[endpoint] = c
    return c


def note_route(endpoint: Tuple[str, int], score_s: float) -> None:
    """Record one routing decision in the balancer metrics."""
    route_counter(f"{endpoint[0]}:{endpoint[1]}").inc()
    lb_metrics()["score_ms"].set(score_s * 1e3)
