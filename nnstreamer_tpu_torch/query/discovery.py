"""Broker-based query-server discovery (reference tensor_query_hybrid).

Reference: ``gst/nnstreamer/tensor_query/tensor_query_hybrid.c`` (375 LoC):
servers publish their endpoint under an MQTT topic named after the
``operation`` they serve; clients subscribe, collect the candidate server
list, and fail over through it (tensor_query_hybrid.h:49-116).

Endpoints are JSON ``{"host": ..., "port": ..., "ts": ...}`` retained
under ``nns-query/<operation>/<host>:<port>``. The broker transport is
selected by the ``broker_host`` spelling: a plain host speaks the
in-process shim protocol (``query.pubsub``); ``mqtt://host[:port]``
speaks real MQTT 3.1.1 (``query.mqtt.MqttClient``) so discovery works
through any conformant broker and interops with reference query-hybrid
peers (tensor_query_hybrid.c publishes through paho the same way).

Port of ``nnstreamer_tpu/query/discovery.py``: a copy with its imports
rewritten. The ad's ``load`` block feeds the fleet balancer
(``query/balance.py``) and its ``metrics_port`` fleet federation
(``obs/distributed.py``).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional, Tuple

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.query.pubsub import Client

log = get_logger("discovery")

TOPIC_PREFIX = "nns-query/"


def make_broker_client(broker_host: str, broker_port: int):
    """Broker transport factory: ``mqtt`` / ``mqtt://h[:p]`` → real MQTT
    client, anything else is a plain shim-broker host. The mqtt dialect
    is parsed by the shared :func:`~nnstreamer_tpu_torch.query.pubsub.
    parse_broker_spec` (same spelling as the pubsub elements' ``broker``
    property); both transports expose the same publish/subscribe/close
    surface, retain included."""
    spec = str(broker_host or "").strip()
    if spec == "mqtt" or spec.startswith("mqtt://"):
        from nnstreamer_tpu_torch.query.mqtt import MqttClient
        from nnstreamer_tpu_torch.query.pubsub import parse_broker_spec

        _, h, p = parse_broker_spec(spec, "127.0.0.1", int(broker_port))
        return MqttClient(h, p)
    return Client(spec or "127.0.0.1", int(broker_port))


class ServerAdvertiser:
    """Server side: publish (retained) this server's endpoint for an
    operation (reference tensor_query_hybrid_publish).

    With ``refresh_s`` > 0 the ad is re-published on that cadence (meant
    to ride under a client's ``stale_s`` TTL, so a live replica never
    ages out), each refresh carrying a fresh ``ts`` and — when a
    ``load_fn`` is wired — a fresh ``load`` block (queue depth / slack
    headroom from the replica's scheduler) for the shortest-slack
    balancer. ``refresh_s`` 0 keeps the classic publish-once behavior."""

    def __init__(self, broker_host: str, broker_port: int, operation: str,
                 host: str, port: int, metrics_port: Optional[int] = None,
                 load_fn=None, refresh_s: float = 0.0):
        self.client = make_broker_client(broker_host, broker_port)
        self.topic = f"{TOPIC_PREFIX}{operation}/{host}:{port}"
        wall_ts = time.time()  # advertised epoch timestamp, read by peers
        self.endpoint = {"host": host, "port": port, "ts": wall_ts}
        if metrics_port:
            # fleet federation (obs/distributed.py) scrapes replicas that
            # advertise where their /metrics.json lives
            self.endpoint["metrics_port"] = int(metrics_port)
        #: () → load dict for the ad's ``load`` block (or None to omit);
        #: see query/balance.py:parse_ad_load for the field contract
        self.load_fn = load_fn
        self.refresh_s = float(refresh_s or 0.0)
        self._stop = threading.Event()
        self._refresher: Optional[threading.Thread] = None

    def _payload(self) -> bytes:
        ad = dict(self.endpoint)
        wall_ts = time.time()  # refreshed stamp: peers judge staleness
        ad["ts"] = wall_ts
        if self.load_fn is not None:
            try:
                load = self.load_fn()
            except Exception as e:  # noqa: BLE001 — an ad without a load
                # block is still a valid ad; the balancer falls back to
                # RTT-only for this endpoint instead of losing it
                log.warning("advertiser load_fn failed: %s", e)
                load = None
            if load:
                ad["load"] = load
        return json.dumps(ad).encode()

    def publish(self) -> None:
        self.client.publish(self.topic, self._payload(), retain=True)
        if self.refresh_s > 0 and self._refresher is None:
            self._refresher = threading.Thread(
                target=self._refresh_loop, name="discovery-refresh",
                daemon=True)
            self._refresher.start()

    def _refresh_loop(self) -> None:
        while not self._stop.wait(self.refresh_s):
            try:
                self.client.publish(self.topic, self._payload(),
                                    retain=True)
            except OSError as e:
                log.warning("ad refresh lost broker: %s", e)
                return

    def retract(self) -> None:
        self._stop.set()
        if self._refresher is not None:
            self._refresher.join(timeout=2.0)
            self._refresher = None
        self.client.publish(self.topic, b"", retain=True)  # tombstone
        self.client.close()


class ServerDiscovery:
    """Client side: subscribe to an operation's topic and keep the live
    server list (reference tensor_query_hybrid_subscribe /
    _get_server_info)."""

    def __init__(self, broker_host: str, broker_port: int, operation: str,
                 stale_s: Optional[float] = None):
        #: entries whose advertised ``ts`` is older than this many
        #: seconds are filtered out of ``wait_servers`` results — a
        #: server that died without retracting leaves a retained ad
        #: behind forever otherwise. ``None`` (default) keeps the
        #: classic trust-the-broker behavior.
        self.stale_s = stale_s
        self.client = make_broker_client(broker_host, broker_port)
        #: key → (host, port, advertised epoch ts; 0.0 = no ts in ad)
        self._servers: Dict[str, Tuple[str, int, float]] = {}
        #: key → full advertised payload (extra fields like metrics_port)
        self._meta: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self._seen = threading.Event()
        self.client.subscribe(f"{TOPIC_PREFIX}{operation}/#", self._on_msg)

    def _on_msg(self, topic: str, body: bytes) -> None:
        key = topic.rsplit("/", 1)[-1]
        with self._lock:
            if not body:
                self._servers.pop(key, None)  # tombstone
                self._meta.pop(key, None)
            else:
                try:
                    info = json.loads(body.decode())
                    self._servers[key] = (info["host"], int(info["port"]),
                                          float(info.get("ts", 0.0)))
                    self._meta[key] = info
                except (ValueError, KeyError) as e:
                    log.warning("bad discovery payload on %s: %s", topic, e)
                    return
                self._seen.set()  # only live endpoints count as "seen"

    def _live_locked(self) -> List[Tuple[str, int]]:
        if self.stale_s is None:
            return [(h, p) for h, p, _ts in self._servers.values()]
        # deliberately wall-clock: the advertised ts is a peer's epoch
        # stamp, comparable only against our own epoch clock
        wall_now = time.time()
        cutoff = wall_now - self.stale_s
        out = []
        for key, (h, p, ts) in list(self._servers.items()):
            # ts==0.0 = ad without a timestamp (older peer): trusted,
            # staleness can only be judged against an advertised clock
            if ts and ts < cutoff:
                log.info("discovery: dropping stale ad %s (%.1fs old)",
                         key, wall_now - ts)
                self._servers.pop(key)
                self._meta.pop(key, None)
                continue
            out.append((h, p))
        return out

    def wait_servers(self, timeout: float = 5.0,
                     settle: float = 0.2) -> List[Tuple[str, int]]:
        """Wait up to ``timeout`` for at least one live server, then a
        short ``settle`` window so same-burst retained messages land and
        the failover list is complete — a tombstone alone never satisfies
        the wait. Mid-wait retractions are honored: a server that
        advertises and then tombstones before the settle window closes
        is not returned."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._seen.wait(timeout=min(0.1, max(0.0, deadline -
                                                    time.monotonic()))):
                with self._lock:
                    have = bool(self._live_locked())
                if have:
                    break
                self._seen.clear()  # everything seen so far went stale
        with self._lock:
            have = bool(self._servers)
        if have and settle > 0:
            time.sleep(settle)  # collect the rest of the retained burst
        with self._lock:
            return self._live_locked()

    def servers_now(self) -> List[Tuple[str, int]]:
        """Non-blocking live-server snapshot (stale ads evicted) — the
        balancer's per-route refresh, vs ``wait_servers`` which blocks
        for the first ad."""
        with self._lock:
            return self._live_locked()

    def load(self, host: str, port: int) -> Optional[dict]:
        """The raw ``load`` block of this endpoint's latest ad, or None
        when the ad carries none (pre-fleet replica, or the endpoint is
        unknown). Parsing/validation is the balancer's job
        (``query.balance.parse_ad_load``)."""
        with self._lock:
            info = self._meta.get(f"{host}:{port}")
        if not info:
            return None
        load = info.get("load")
        return load if isinstance(load, dict) else None

    def metrics_endpoints(self) -> List[Tuple[str, int]]:
        """``(host, metrics_port)`` for every live server whose ad
        carries a ``metrics_port`` — the fleet-federation scrape list
        (see :class:`~nnstreamer_tpu_torch.obs.distributed.
        FederatedMetrics`)."""
        with self._lock:
            out = []
            for key in list(self._servers):
                info = self._meta.get(key) or {}
                mp = info.get("metrics_port")
                if mp:
                    out.append((str(info.get("host", "")), int(mp)))
            return out

    def close(self) -> None:
        self.client.close()
