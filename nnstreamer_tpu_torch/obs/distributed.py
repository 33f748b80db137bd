"""Distributed observability plane — cross-hop trace propagation and
fleet metrics federation.

Every observability surface built so far (metrics registry, frame-ledger
Timeline, flight recorder, P² SLO quantiles, MAD variance attribution)
is per-process: the moment a frame crosses a ``tensor_query`` / gRPC /
MQTT hop its ledger goes dark and the remote half of its latency is one
unattributed blob. This module makes one frame's ledger span the whole
edge-cloud graph, in two halves:

Trace-context propagation
-------------------------
The reliable query wire (PR-11 TRANSFER_EX / RESULT_EX) grows an EX2
variant carrying a u64 trace id + wall-clock send stamp outbound and a
compact per-frame *span blob* (stage→seconds durations, remote total,
endpoint name) inbound, negotiated through a ``dt1`` HELLO feature token
so a pre-16 peer keeps every wire byte identical. The client splices the
remote vector into its own ledger as the :data:`~.timeline.DIST_STAGES`
(``hop_send`` / ``remote_queue`` / ``remote_device`` / ``remote_other``
/ ``hop_recv``).

**Skew anchoring rule**: remote spans are *durations*, anchored strictly
inside the client's observed ``[sent_t, recv_t]`` monotonic RTT window —
raw remote clocks are never compared against local ones. The only use of
wall stamps is to split the residual wire time into its send/receive
halves, and only when that split lands inside the window (clocks sane);
otherwise the split falls back to symmetric halves. When
``NNSTPU_NTP_SERVERS`` is set both peers pre-correct their wall stamps
via ``query/ntp.py``, tightening the split without changing the rule.

Because the spliced kinds are members of ``timeline.STAGES``, the flight
recorder's stage vectors, P² gauges, MAD variance attribution, and
forensic dumps name *remote* stages with zero extra wiring — a tail dump
can finally say "the p99.9 frame spent 310 ms in remote_device on
endpoint B".

Fleet metrics federation
------------------------
:class:`FederatedMetrics` scrapes N replica ``/metrics.json`` endpoints
(static list, or discovered via ``query/discovery.py`` metrics-port
advertisements), merging counters by sum, gauges by labeled instance,
and P² quantile marker states via :func:`~.quantiles.merge_p2_snapshots`
— replicas ship five-marker states, never raw samples. The merged view
is exposed as ``/fleet/metrics`` (Prometheus text, ``nns_fleet_*``
names) and ``/fleet/metrics.json`` on the MetricsServer, including
per-endpoint SLO burn-rate windows — the signal the ROADMAP's
join-shortest-slack fleet balancer will consume.

Port of ``nnstreamer_tpu/obs/distributed.py``: a copy with its imports
rewritten (the port's frame ledger, P² quantiles, discovery and SNTP
client). On the card a server's ``remote_device`` is the host's enqueue
of the region's replay and the result's fetch (ROADMAP C.11), not kernel
time.

Kill switch: ``NNSTPU_DIST_TRACE=0`` (or false/no/off) disables the
feature offer entirely — no ``dt1`` token, no EX2 commands, byte-
identical wire vs the pre-distributed build. Talking to a peer that does
not echo the token has the same effect per connection.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.obs import timeline as _timeline
from nnstreamer_tpu_torch.obs.quantiles import merge_p2_snapshots

log = get_logger("obs.distributed")

_ENV = "NNSTPU_DIST_TRACE"
_FALSY = ("0", "false", "no", "off")

#: HELLO feature token: both peers must speak it before EX2 is used
FEATURE = "dt1"

#: remote stage kinds folded into each spliced client-side stage
REMOTE_QUEUE_KINDS = ("ingest", "lane_reorder", "queue_wait",
                      "sched_hold", "fence_wait")
REMOTE_DEVICE_KINDS = ("device", "d2h")


def enabled() -> bool:
    """True unless ``NNSTPU_DIST_TRACE`` is an explicit falsy spelling —
    like the flight recorder, the distributed plane is on by default and
    *negotiated* per connection, so the off path costs nothing."""
    v = os.environ.get(_ENV, "").strip()
    return not (v and v.lower() in _FALSY)


# -- HELLO feature negotiation ----------------------------------------------
def hello_offer() -> str:
    """Suffix the client appends to its ``instance:window`` HELLO
    payload: ``:dt1`` when armed, empty (classic bytes) when not."""
    return f":{FEATURE}" if enabled() else ""


def parse_features(text: str) -> frozenset:
    """Feature tokens from the tail of a HELLO payload or reply."""
    return frozenset(t for t in text.split(":") if t and not t.isdigit())


def hello_accepts(reply: bytes) -> bool:
    """Did the server's HELLO echo grant the dt1 feature?"""
    try:
        return FEATURE in parse_features(reply.decode())
    except UnicodeDecodeError:
        return False


# -- wall-clock stamps -------------------------------------------------------
_ntp_lock = threading.Lock()
_ntp_offset_s: Optional[float] = None


def wall_offset_s() -> float:
    """Best-effort local wall-clock correction (seconds to add) from
    ``query/ntp.py`` when ``NNSTPU_NTP_SERVERS`` names servers; 0.0
    otherwise. Measured once, cached — stamps stay cheap."""
    global _ntp_offset_s
    with _ntp_lock:
        if _ntp_offset_s is not None:
            return _ntp_offset_s
        spec = os.environ.get("NNSTPU_NTP_SERVERS", "").strip()
        if not spec:
            _ntp_offset_s = 0.0
            return 0.0
        try:
            from nnstreamer_tpu_torch.query import ntp

            servers = []
            for item in spec.split(","):
                h, _, p = item.strip().partition(":")
                servers.append((h, int(p) if p else 123))
            _ntp_offset_s = (ntp.corrected_epoch_ns(tuple(servers))
                             - time.time_ns()) / 1e9
        except (OSError, ValueError) as e:
            log.warning("ntp correction unavailable (%s); wall stamps "
                        "stay uncorrected", e)
            _ntp_offset_s = 0.0
        return _ntp_offset_s


def wall_now() -> float:
    """Epoch seconds, NTP-corrected when configured — what goes on the
    wire as an advisory stamp."""
    wall = time.time()
    return wall + wall_offset_s()


# -- span blobs --------------------------------------------------------------
def pack_span_blob(stages: Dict[str, float], total_s: float,
                   recv_wall: float, send_wall: float,
                   endpoint: str) -> bytes:
    """The compact per-frame span vector a server piggybacks on
    RESULT_EX2: durations only (skew-safe), plus advisory wall stamps."""
    return json.dumps({
        "v": 1,
        "total": round(total_s, 9),
        "stages": {k: round(v, 9) for k, v in stages.items() if v > 0.0},
        "recv_wall": recv_wall,
        "send_wall": send_wall,
        "endpoint": endpoint,
    }).encode()


def unpack_span_blob(blob: bytes) -> Dict[str, Any]:
    if not blob:
        return {}
    try:
        doc = json.loads(blob.decode())
        return doc if isinstance(doc, dict) else {}
    except (ValueError, UnicodeDecodeError):
        return {}


def collect_frame_stages(seq: Optional[int]) -> Dict[str, float]:
    """Per-frame stage durations from the process-wide ledger — O(1)
    from a flight recorder's accumulator, a bounded scan from a plain
    Timeline, empty when no ledger is installed."""
    tl = _timeline.ACTIVE
    if tl is None or seq is None:
        return {}
    return tl.frame_stages(seq)


# -- trace meta for non-query hops (gRPC / MQTT payload headers) -------------
TRACE_ID_META = "dist_trace_id"
SENT_WALL_META = "dist_sent_wall"


def attach_trace_meta(meta: Dict[str, Any],
                      seq: Optional[int] = None) -> Dict[str, Any]:
    """Stamp outbound trace context into a payload-meta dict (the gRPC
    flex codec / MQTT header carriers). No-op when disarmed."""
    if enabled():
        if seq is None:
            seq = meta.get(_timeline.TRACE_SEQ_META)
        meta[TRACE_ID_META] = int(seq) if seq is not None else 0
        meta[SENT_WALL_META] = wall_now()
    return meta


def extract_trace_meta(meta: Dict[str, Any]
                       ) -> Optional[Tuple[int, float]]:
    """(trace_id, sent_wall) from an inbound meta dict, or None."""
    tid = meta.get(TRACE_ID_META)
    if tid is None:
        return None
    try:
        return int(tid), float(meta.get(SENT_WALL_META, 0.0))
    except (TypeError, ValueError):
        return None


# -- the splice --------------------------------------------------------------
def splice_remote(tl, seq: Optional[int], sent_t: float, recv_t: float,
                  sent_wall: float, span: Dict[str, Any]) -> None:
    """Splice a remote span blob into the client ledger as the five
    DIST_STAGES, anchored sequentially inside ``[sent_t, recv_t]`` (the
    client's own monotonic RTT window — see the skew-anchoring rule in
    the module docstring).

    ``tl`` is the client's active Timeline/FlightRecorder; ``seq`` the
    client frame's trace seq. Remote stage durations are clamped (scaled
    down proportionally if the remote ledger over-reports) so the five
    spans always tile the window exactly.
    """
    if tl is None or seq is None:
        return
    rtt = recv_t - sent_t
    if rtt <= 0.0:
        return
    endpoint = str(span.get("endpoint") or "remote")
    total = float(span.get("total") or 0.0)
    total = min(max(total, 0.0), rtt)
    wire = rtt - total

    # wall-stamp split of the wire time into its outbound/inbound halves,
    # used only when it lands inside the window; symmetric otherwise
    hop_send = wire / 2.0
    recv_wall = span.get("recv_wall")
    if recv_wall and sent_wall:
        fwd = float(recv_wall) - float(sent_wall)
        if 0.0 <= fwd <= wire:
            hop_send = fwd
    hop_recv = wire - hop_send

    stages = span.get("stages") or {}
    queue = sum(float(stages.get(k, 0.0)) for k in REMOTE_QUEUE_KINDS)
    device = sum(float(stages.get(k, 0.0)) for k in REMOTE_DEVICE_KINDS)
    known = queue + device
    if known > total > 0.0:
        scale = total / known
        queue *= scale
        device *= scale
        known = total
    elif known > 0.0 and total <= 0.0:
        queue = device = known = 0.0
    other = max(total - known, 0.0)

    # hop spans are the LOCAL view of the wire (they stay on this
    # process's "net" track); the remote_* spans carry the endpoint arg,
    # which the Chrome exporter renders as that endpoint's own process
    t = sent_t
    tl.span("hop_send", seq, t, t + hop_send, track="net", peer=endpoint)
    t += hop_send
    for kind, dur in (("remote_queue", queue),
                      ("remote_device", device),
                      ("remote_other", other)):
        tl.span(kind, seq, t, t + dur, track="remote",
                endpoint=endpoint)
        t += dur
    tl.span("hop_recv", seq, t, recv_t, track="net", peer=endpoint)


# -- fleet metrics federation ------------------------------------------------
class FederatedMetrics:
    """Scrape-and-merge aggregator over N replica ``/metrics.json``
    endpoints.

    Merge rules (the federation contract, see docs/distributed.md):

    - **counters** sum across replicas per (name, labels) series;
    - **gauges** keep one sample per replica, labeled
      ``instance="host:port"`` (averaging a gauge lies);
    - **P² quantile states** (the ``quantiles`` section each replica
      exposes) merge via the marker-merge path into fleet-level
      p50/p99 per stage;
    - **burn-rate windows** stay per endpoint — a fleet-average burn
      rate would hide a single replica on fire.

    ``endpoints`` is a list of ``(host, port)`` metrics addresses;
    alternatively pass ``operation`` (+ broker coordinates) to discover
    replicas that advertise a ``metrics_port`` through
    ``query/discovery.py``.
    """

    def __init__(self, endpoints: Optional[List[Tuple[str, int]]] = None,
                 operation: Optional[str] = None,
                 broker_host: str = "127.0.0.1", broker_port: int = 1883,
                 timeout: float = 2.0):
        self.endpoints: List[Tuple[str, int]] = list(endpoints or [])
        self.operation = operation
        self.broker_host = broker_host
        self.broker_port = broker_port
        self.timeout = float(timeout)
        self._lock = threading.Lock()
        #: "host:port" → last scrape result / error witness
        self._last: Dict[str, Dict[str, Any]] = {}

    # -- discovery -----------------------------------------------------------
    def discover(self, timeout: float = 5.0) -> List[Tuple[str, int]]:
        """Refresh the endpoint list from broker discovery (replicas
        advertising a ``metrics_port``); static endpoints are kept."""
        if not self.operation:
            return self.endpoints
        from nnstreamer_tpu_torch.query.discovery import ServerDiscovery

        disco = ServerDiscovery(self.broker_host, self.broker_port,
                                str(self.operation))
        try:
            disco.wait_servers(timeout=timeout)
            found = disco.metrics_endpoints()
        finally:
            disco.close()
        merged = dict.fromkeys(self.endpoints)
        merged.update(dict.fromkeys(found))
        self.endpoints = list(merged)
        return self.endpoints

    # -- scraping ------------------------------------------------------------
    def scrape_one(self, host: str, port: int) -> Optional[Dict[str, Any]]:
        url = f"http://{host}:{port}/metrics.json"
        try:
            with urllib.request.urlopen(url, timeout=self.timeout) as r:
                return json.loads(r.read().decode())
        except (OSError, ValueError) as e:
            log.warning("federation scrape of %s failed: %s", url, e)
            return None

    def collect(self) -> Dict[str, Any]:
        """Scrape every endpoint and return the merged fleet view."""
        wall_ts = time.time()
        counters: Dict[Tuple[str, tuple], float] = {}
        counter_help: Dict[str, str] = {}
        gauges: List[Dict[str, Any]] = []
        quantile_states: Dict[str, Dict[str, List[dict]]] = {}
        burn: Dict[str, Any] = {}
        endpoints: Dict[str, Dict[str, Any]] = {}
        for host, port in list(self.endpoints):
            inst = f"{host}:{port}"
            snap = self.scrape_one(host, port)
            endpoints[inst] = {"ok": snap is not None, "ts": wall_ts}
            if snap is None:
                continue
            for m in snap.get("metrics", ()):
                name = m.get("name")
                if not name:
                    continue
                labels = m.get("labels") or {}
                if m.get("type") == "counter":
                    key = (name, tuple(sorted(labels.items())))
                    counters[key] = counters.get(key, 0.0) + \
                        float(m.get("value", 0.0))
                    counter_help.setdefault(name, m.get("help", ""))
                elif m.get("type") == "gauge":
                    gauges.append({"name": name,
                                   "labels": {**labels, "instance": inst},
                                   "value": float(m.get("value", 0.0))})
            for stage, pair in (snap.get("quantiles") or {}).items():
                slot = quantile_states.setdefault(
                    stage, {"p50": [], "p99": []})
                for w in ("p50", "p99"):
                    state = pair.get(w)
                    if state:
                        slot[w].append(state)
            b = (snap.get("slo") or {}).get("burn")
            if b:
                burn[inst] = b
        quantiles: Dict[str, Any] = {}
        for stage, states in quantile_states.items():
            p50 = merge_p2_snapshots(states["p50"], 0.5)
            p99 = merge_p2_snapshots(states["p99"], 0.99)
            if p50 is None and p99 is None:
                continue
            quantiles[stage] = {
                "p50_ms": round((p50 or 0.0) * 1e3, 4),
                "p99_ms": round((p99 or 0.0) * 1e3, 4),
                "count": sum(int(s.get("count", 0))
                             for s in states["p50"]),
            }
        out = {
            "ts": wall_ts,
            "endpoints": endpoints,
            "counters": [
                {"name": name, "labels": dict(labels), "value": value}
                for (name, labels), value in sorted(counters.items())
            ],
            "gauges": gauges,
            "quantiles": quantiles,
            "burn": burn,
        }
        with self._lock:
            self._last = endpoints
        return out

    # -- rendering -----------------------------------------------------------
    @staticmethod
    def _labels(labels: Dict[str, Any]) -> str:
        if not labels:
            return ""
        inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
        return "{" + inner + "}"

    def render_prometheus(self) -> str:
        """The ``nns_fleet_*`` text view of :meth:`collect`."""
        view = self.collect()
        lines: List[str] = []
        up = view["endpoints"]
        lines.append("# TYPE nns_fleet_endpoint_up gauge")
        for inst, st in sorted(up.items()):
            lines.append(f'nns_fleet_endpoint_up'
                         f'{{instance="{inst}"}} '
                         f'{1 if st["ok"] else 0}')
        seen_counter = set()
        for c in view["counters"]:
            fleet = f"nns_fleet_{c['name']}"
            if fleet not in seen_counter:
                lines.append(f"# TYPE {fleet} counter")
                seen_counter.add(fleet)
            lines.append(f"{fleet}{self._labels(c['labels'])} "
                         f"{c['value']:g}")
        seen_gauge = set()
        for g in view["gauges"]:
            fleet = f"nns_fleet_{g['name']}"
            if fleet not in seen_gauge:
                lines.append(f"# TYPE {fleet} gauge")
                seen_gauge.add(fleet)
            lines.append(f"{fleet}{self._labels(g['labels'])} "
                         f"{g['value']:g}")
        for which in ("p50", "p99"):
            lines.append(f"# TYPE nns_fleet_stage_{which}_ms gauge")
            for stage, q in sorted(view["quantiles"].items()):
                lines.append(f'nns_fleet_stage_{which}_ms'
                             f'{{stage="{stage}"}} '
                             f'{q[f"{which}_ms"]:g}')
        lines.append("# TYPE nns_fleet_burn_rate gauge")
        for inst, b in sorted(view["burn"].items()):
            for window in ("fast", "slow"):
                if window in b:
                    lines.append(
                        f'nns_fleet_burn_rate{{instance="{inst}",'
                        f'window="{window}"}} {b[window]:g}')
        return "\n".join(lines) + "\n"
