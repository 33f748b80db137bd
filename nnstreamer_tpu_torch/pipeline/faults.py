"""Deterministic fault injection — the chaos half of the supervision layer.

Port of ``nnstreamer_tpu/pipeline/faults.py`` (a copy: the spec grammar,
the seeded decisions, the metric and the ledger marks are the JAX
module's). A production serving plane is defined by what it does when
things break, and "what it does" is untestable without a way to break
things on demand, repeatably. This module is a seeded, spec-driven
injector with hooks at the places the async substrate can fail:

- ``filter.invoke``   — backend invoke (``elements/filter.py``) and the
  fused region's dispatch (``pipeline/fuse.py``), before any replay work
- ``filter.open``     — backend open / weight load (``elements/filter.py``)
- ``transfer.h2d``    — host→device upload (``tensors/buffer.py``)
- ``transfer.d2h``    — device→host materialization (``tensors/buffer.py``)
- ``pool.alloc``      — pool slab growth (``tensors/pool.py``)
- ``lane.worker``     — per-frame lane worker loop (``pipeline/lanes.py``)
- ``queue.push``      — queue ingress (``pipeline/pipeline.py``)
- ``dispatch.fence``  — dispatch-window fence (``pipeline/dispatch.py``)
- ``mqtt.publish``    — MQTT client publish (``query/mqtt.py``): ``drop``
  swallows the send, ``disconnect`` severs the broker link, ``corrupt``
  writes a reserved packet type; a dropped QoS1 copy recovers by DUP

The JAX package also hooks the transport sites ``query.send`` and
``query.recv`` (ROADMAP 26a) and ``grpc.call`` (26f). The grammar still
parses them, but :func:`activate` raises
``NotImplementedError`` naming the item for a spec that names one: a
rule no hook can fire would report "the system survives faults"
vacuously.

Spec grammar (``NNSTPU_FAULTS``)::

    site:key=val,key=val;site:key=val,...

    NNSTPU_FAULTS="filter.invoke:rate=0.01,kind=raise;\
    lane.worker:nth=37,kind=crash;dispatch.fence:kind=stall,ms=500"

Per-site keys:

- ``kind``  — ``raise`` (ordinary exception, recoverable under an
  error-policy), ``crash`` (simulated abrupt worker death — lane
  supervision treats it as a restart, everything else like ``raise``),
  ``stall`` (sleep ``ms`` milliseconds — watchdog bait), ``oom``
  (simulated device-memory exhaustion — raises :class:`InjectedOom`;
  under ``error-policy=degrade`` it takes the memory-pressure ladder of
  ``pipeline/supervise.py``, as a ``torch.cuda.OutOfMemoryError`` does),
  or one of the
  transport kinds ``drop`` (the bytes silently vanish), ``disconnect``
  (the connection dies mid-operation), ``corrupt`` (the bytes arrive
  mangled). Transport kinds are interpreted by :meth:`FaultInjector.
  action` hooks; at a :meth:`FaultInjector.check` hook (the compute
  sites) they degrade to ``raise`` — a drop has no meaning for a
  backend invoke.
- trigger — exactly one of ``rate=<float>`` (seeded Bernoulli per
  occurrence), ``nth=<int>`` (fire on exactly the nth occurrence,
  1-based), or ``every=<int>`` (every k·every-th occurrence).
- ``ms``    — stall duration (``kind=stall`` only), default 100.
- ``seed``  — per-site seed override; else ``NNSTPU_FAULTS_SEED``
  (default 0).

Determinism contract: the decision for the *n*-th occurrence at a site
is a pure function of ``(seed, site, n)`` — independent of thread
interleaving — so the same spec + seed reproduces the same fired set
across runs even with parallel lanes racing on the counters.

An injected ``stall`` sleeps on an event that :meth:`FaultInjector.
release_stalls` sets; ``Pipeline.stop()`` calls it, so a pipeline failed
by its watchdog tears down without waiting out a stall that models a
hung device.

Kill-switch discipline (same as ``obs/timeline.py``): the process-wide
:data:`ACTIVE` injector is ``None`` by default; every hook site is one
module-attribute read and an ``is None`` test, so the unset path stays
byte-identical to a build without this module. ``Pipeline.start()``
honors the env via :func:`maybe_activate_env`.

Every fired fault increments ``nns_fault_injected_total{site,kind}``
and drops a ``fault`` mark on the frame ledger (``obs/timeline.py``),
so tests can assert injected counts from three independent witnesses:
the injector's log, the metric, and the trace.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.obs import timeline as _timeline

log = get_logger("faults")

_ENV = "NNSTPU_FAULTS"
_ENV_SEED = "NNSTPU_FAULTS_SEED"

#: the injection-hook sites wired through the async substrate
SITES: Tuple[str, ...] = ("filter.invoke", "filter.open",
                          "transfer.h2d", "transfer.d2h", "pool.alloc",
                          "lane.worker", "queue.push", "dispatch.fence",
                          "query.send", "query.recv", "grpc.call",
                          "mqtt.publish")

#: sites whose hook the port does not have yet → the ROADMAP.md item that
#: brings it
UNPORTED_SITES: Dict[str, str] = {
    "query.send": "26a resilient transport",
    "query.recv": "26a resilient transport",
    "grpc.call": "26f gRPC",
}

KINDS: Tuple[str, ...] = ("raise", "crash", "stall", "oom",
                          "drop", "disconnect", "corrupt")

#: kinds a transport hook interprets itself (returned by :meth:`action`)
#: rather than having raised at it
ACTION_KINDS: Tuple[str, ...] = ("drop", "disconnect", "corrupt")

#: the process-wide injector; ``None`` (default) means injection is OFF
#: and every hook site reduces to one attribute read + is-None test
ACTIVE: Optional["FaultInjector"] = None


class InjectedFault(RuntimeError):
    """An injector-raised failure (``kind=raise``). Deliberately an
    ordinary exception: recovery machinery must not special-case it."""

    def __init__(self, site: str, n: int, kind: str = "raise"):
        super().__init__(f"injected fault at {site} (occurrence {n})")
        self.site = site
        self.n = n
        self.kind = kind


class InjectedCrash(InjectedFault):
    """``kind=crash``: simulated abrupt worker death. Lane supervision
    restarts the worker's clone chain on this (no per-frame retry of a
    corpse); everywhere else it behaves like :class:`InjectedFault`."""

    def __init__(self, site: str, n: int):
        super().__init__(site, n, kind="crash")


class InjectedOom(InjectedFault):
    """``kind=oom``: simulated device-memory exhaustion (the shape of a
    real ``torch.cuda.OutOfMemoryError``). Under ``error-policy=degrade``
    the supervision layer climbs the memory-pressure ladder (evict →
    pool → shed → cpu); everywhere else it behaves like
    :class:`InjectedFault`."""

    def __init__(self, site: str, n: int):
        super().__init__(site, n, kind="oom")


@dataclasses.dataclass
class FaultRule:
    """One parsed ``site:...`` clause of the spec."""

    site: str
    kind: str = "raise"
    rate: float = 0.0
    nth: Optional[int] = None
    every: Optional[int] = None
    ms: float = 100.0
    seed: Optional[int] = None


def parse_faults(spec: str) -> List[FaultRule]:
    """Parse the ``NNSTPU_FAULTS`` grammar. Raises ``ValueError`` on an
    unknown site/kind/key — a typo'd chaos spec that silently injects
    nothing would report "system survives faults" vacuously."""
    rules: List[FaultRule] = []
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        site, _, body = clause.partition(":")
        site = site.strip()
        if site not in SITES:
            raise ValueError(
                f"NNSTPU_FAULTS: unknown site {site!r} (sites: "
                f"{', '.join(SITES)})")
        rule = FaultRule(site=site)
        for item in body.split(","):
            item = item.strip()
            if not item:
                continue
            key, _, val = item.partition("=")
            key, val = key.strip(), val.strip()
            if key == "kind":
                if val not in KINDS:
                    raise ValueError(
                        f"NNSTPU_FAULTS: unknown kind {val!r} at {site} "
                        f"(kinds: {', '.join(KINDS)})")
                rule.kind = val
            elif key == "rate":
                rule.rate = float(val)
            elif key == "nth":
                rule.nth = int(val)
            elif key == "every":
                rule.every = max(1, int(val))
            elif key == "ms":
                rule.ms = float(val)
            elif key == "seed":
                rule.seed = int(val)
            else:
                raise ValueError(
                    f"NNSTPU_FAULTS: unknown key {key!r} at {site} "
                    f"(keys: kind, rate, nth, every, ms, seed)")
        rules.append(rule)
    return rules


class FaultInjector:
    """Spec-driven deterministic injector.

    One occurrence counter per site (under a lock — lane workers hit
    their site concurrently); the fire decision for occurrence ``n`` is
    a pure function of ``(seed, site, n)``, so the fired set is
    reproducible regardless of thread interleaving."""

    def __init__(self, rules: List[FaultRule], seed: int = 0):
        self._rules: Dict[str, FaultRule] = {r.site: r for r in rules}
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        #: every fired fault as ``(site, occurrence, kind)``, in fire
        #: order per site — the determinism tests' ground truth
        self.fired: List[Tuple[str, int, str]] = []
        self._m = None  # lazy: {(site, kind): Counter}
        #: set by release_stalls(): every pending and later stall returns
        self._released = threading.Event()

    # -- observation ---------------------------------------------------------
    def _count_metric(self, site: str, kind: str) -> None:
        if self._m is None:
            self._m = {}
        key = (site, kind)
        c = self._m.get(key)
        if c is None:
            from nnstreamer_tpu_torch.obs import get_registry

            c = self._m[key] = get_registry().counter(
                "nns_fault_injected_total",
                "Faults fired by the deterministic injector "
                "(pipeline/faults.py)", site=site, kind=kind)
        c.inc()

    def injected(self, site: Optional[str] = None) -> int:
        """Fired-fault count, total or per site."""
        with self._lock:
            if site is None:
                return len(self.fired)
            return sum(1 for s, _n, _k in self.fired if s == site)

    def fired_set(self, site: str) -> List[int]:
        """The occurrence indices that fired at ``site`` (sorted) — two
        runs with the same spec + seed must produce the same list."""
        with self._lock:
            return sorted(n for s, n, _k in self.fired if s == site)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for s, _n, _k in self.fired:
                out[s] = out.get(s, 0) + 1
            return out

    def release_stalls(self) -> None:
        """End every injected stall now, and make later ones return at
        once: the pipeline that hosts them is tearing down."""
        self._released.set()

    def _stall(self, rule: FaultRule) -> None:
        self._released.wait(rule.ms / 1e3)

    # -- hot path ------------------------------------------------------------
    def _decide(self, rule: FaultRule, n: int) -> bool:
        if rule.nth is not None:
            return n == rule.nth
        if rule.every is not None:
            return n % rule.every == 0
        if rule.rate > 0.0:
            seed = rule.seed if rule.seed is not None else self.seed
            # a STRING seed hashes via sha512 — stable across processes
            # (a tuple seed would go through hash(), which PYTHONHASHSEED
            # randomizes per process, silently breaking cross-run
            # reproducibility)
            rng = random.Random(f"{seed}:{rule.site}:{n}")
            return rng.random() < rule.rate
        return False

    def _fire(self, site: str, seq: Optional[int]
              ) -> Optional[Tuple[int, FaultRule]]:
        """Count the occurrence and decide; on fire, log/meter/mark and
        return ``(n, rule)`` for the caller to act on. The decision for
        occurrence ``n`` stays the same pure function of
        ``(seed, site, n)`` regardless of which hook entry counted it."""
        rule = self._rules.get(site)
        if rule is None:
            return None
        with self._lock:
            n = self._counts.get(site, 0) + 1
            self._counts[site] = n
        if not self._decide(rule, n):
            return None
        with self._lock:
            self.fired.append((site, n, rule.kind))
        self._count_metric(site, rule.kind)
        tl = _timeline.ACTIVE
        if tl is not None:
            tl.mark("fault", seq, track="faults", site=site,
                    fault_kind=rule.kind, n=n)
        log.info("fault injected: site=%s kind=%s occurrence=%d seq=%s",
                 site, rule.kind, n, seq)
        return n, rule

    def check(self, site: str, seq: Optional[int] = None) -> None:
        """The compute-site hook entry: count the occurrence, fire per
        the rule. ``raise``/``crash`` raise; ``stall`` sleeps ``ms`` and
        returns; the transport kinds degrade to ``raise`` (a drop has no
        meaning mid-invoke). ``seq`` is the frame-ledger id for the
        trace mark."""
        fired = self._fire(site, seq)
        if fired is None:
            return
        n, rule = fired
        if rule.kind == "stall":
            self._stall(rule)
            return
        if rule.kind == "crash":
            raise InjectedCrash(site, n)
        if rule.kind == "oom":
            raise InjectedOom(site, n)
        raise InjectedFault(site, n, kind=rule.kind)

    def action(self, site: str, seq: Optional[int] = None) -> Optional[str]:
        """The transport-site hook entry: like :meth:`check`, but the
        kinds a transport can act out itself come back as a verdict —
        ``"drop"`` / ``"disconnect"`` / ``"corrupt"`` — for the hook to
        interpret (swallow the send, kill the socket, mangle the bytes).
        ``None`` means no fault fired; ``stall`` sleeps here and returns
        ``None``; ``raise``/``crash`` raise exactly as at a check
        site."""
        fired = self._fire(site, seq)
        if fired is None:
            return None
        n, rule = fired
        if rule.kind == "stall":
            self._stall(rule)
            return None
        if rule.kind == "crash":
            raise InjectedCrash(site, n)
        if rule.kind == "oom":
            raise InjectedOom(site, n)
        if rule.kind == "raise":
            raise InjectedFault(site, n)
        return rule.kind


# --------------------------------------------------------------------------
# activation (timeline.ACTIVE-style kill switch)
# --------------------------------------------------------------------------
def activate(spec: str, seed: int = 0) -> FaultInjector:
    """Install a process-wide injector from a spec string. A rule at a
    site the port has no hook for raises ``NotImplementedError`` naming
    the site's ROADMAP.md item."""
    global ACTIVE
    rules = parse_faults(spec)
    for rule in rules:
        item = UNPORTED_SITES.get(rule.site)
        if item is not None:
            from nnstreamer_tpu_torch.pipeline.element import not_ported

            raise not_ported(f"the fault-injection hook {rule.site!r}",
                             item)
    inj = FaultInjector(rules, seed=seed)
    ACTIVE = inj
    return inj


def deactivate() -> None:
    global ACTIVE
    ACTIVE = None


def maybe_activate_env() -> Optional[FaultInjector]:
    """``Pipeline.start()`` hook: honor ``NNSTPU_FAULTS`` /
    ``NNSTPU_FAULTS_SEED`` without code changes. Idempotent; an
    explicitly installed injector wins; unset env leaves :data:`ACTIVE`
    ``None`` — the byte-identical off path."""
    if ACTIVE is not None:
        return ACTIVE
    spec = os.environ.get(_ENV, "").strip()
    if not spec:
        return None
    raw_seed = os.environ.get(_ENV_SEED, "").strip()
    try:
        seed = int(raw_seed) if raw_seed else 0
    except ValueError:
        log.warning("%s=%r is not an int; using seed 0", _ENV_SEED,
                    raw_seed)
        seed = 0
    inj = activate(spec, seed=seed)
    log.info("fault injection active: %s (seed %d)", spec, seed)
    return inj
