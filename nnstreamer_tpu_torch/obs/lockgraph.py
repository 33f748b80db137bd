"""Runtime lock-order witness — the dynamic half of the NNS202 story.

The port of the JAX package's witness: it instruments only locks that
``nnstreamer_tpu_torch`` code creates (a file under the port's package
directory; the JAX package's locks stay real), and :func:`cross_check`
holds the observed graph against the port's static NNS202 graph
(``analysis.concurrency.static_lock_graph`` over ``nnstreamer_tpu_torch``).

The static analyzer (``analysis/concurrency.py``) derives a lock-order
graph from the code; this module records the orders the process
*actually* takes. With ``NNSTPU_LOCKGRAPH=1`` the ``threading.Lock`` /
``threading.RLock`` factories are replaced by ones that, **only for
locks created from nnstreamer_tpu_torch code** (creator-frame filtered),
return an instrumented wrapper that

- records per-thread acquisition stacks and every held→acquired edge
  into one process-wide digraph, keyed by the lock's creation site
  (``relpath:lineno`` — the same key the static graph's ``sites`` map
  translates to symbolic names);
- detects cycles online at edge insertion (a cycle = two threads have
  taken these locks in opposite orders = a potential deadlock that the
  interleaving happened not to trigger this run);
- dumps the observed graph as JSON (``NNSTPU_LOCKGRAPH=<path>`` dumps
  at exit), so CI can assert acyclicity and cross-check against the
  static NNS202 graph with :func:`cross_check` — each view validating
  the other is the point: the static graph proves paths the test run
  never exercised, the runtime graph proves orders the analyzer's
  heuristics could not see.

With ``NNSTPU_LOCKGRAPH`` unset (the default) importing this module
changes nothing: the factories are untouched and every lock in the
process is a plain ``threading.Lock`` — a byte-identical no-op, same as
the fault-injection and flight-recorder kill switches.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Set, Tuple

#: the REAL factories, bound at import time — the witness's own state
#: must never be guarded by an instrumented lock (infinite recursion),
#: and deactivate() must restore exactly these
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock

#: filesystem root of the package: locks created by files under this
#: root are instrumented, everything else (stdlib, site-packages, test
#: files) gets a real lock untouched
_PKG_ROOT = str(Path(__file__).resolve().parent.parent)
_REL_BASE = str(Path(_PKG_ROOT).parent)

ENV = "NNSTPU_LOCKGRAPH"


class LockGraph:
    """Process-wide observed acquisition-order digraph.

    Nodes are lock creation sites (``relpath:lineno``); an edge a→b
    means some thread acquired b while holding a. ``violations``
    collects every cycle the moment its closing edge is inserted."""

    def __init__(self) -> None:
        self._mu = _REAL_LOCK()
        self._tls = threading.local()
        self.nodes: Dict[str, str] = {}            # site -> kind
        self.edges: Dict[Tuple[str, str], int] = {}
        self._adj: Dict[str, Set[str]] = {}
        self.acquisitions = 0
        self.violations: List[Dict[str, Any]] = []

    # -- per-thread stack ---------------------------------------------------
    def _stack(self) -> List[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def note_created(self, site: str, kind: str) -> None:
        with self._mu:
            self.nodes.setdefault(site, kind)

    def note_acquired(self, site: str) -> None:
        st = self._stack()
        with self._mu:
            self.acquisitions += 1
            if site not in st:       # reentrant re-acquire adds no order
                for held in st:
                    self._add_edge(held, site)
        st.append(site)

    def note_released(self, site: str) -> None:
        st = self._stack()
        # pop the innermost occurrence: releases may legally interleave
        # (lock A, lock B, release A, release B)
        for i in range(len(st) - 1, -1, -1):
            if st[i] == site:
                del st[i]
                return

    # -- graph --------------------------------------------------------------
    def _add_edge(self, a: str, b: str) -> None:
        """Caller holds ``self._mu``. Insert a→b; if b can already reach
        a, this edge closes a cycle — record it as a violation."""
        if a == b:
            if self.nodes.get(a) != "rlock":
                self.edges[(a, b)] = self.edges.get((a, b), 0) + 1
                self.violations.append({
                    "cycle": [a, a],
                    "thread": threading.current_thread().name,
                    "edge": [a, b],
                })
            return
        is_new = (a, b) not in self.edges
        self.edges[(a, b)] = self.edges.get((a, b), 0) + 1
        if not is_new:
            return
        self._adj.setdefault(a, set()).add(b)
        self._adj.setdefault(b, set())
        path = self._find_path(b, a)
        if path is not None:
            self.violations.append({
                "cycle": path + [b],
                "thread": threading.current_thread().name,
                "edge": [a, b],
            })

    def _find_path(self, src: str, dst: str) -> Optional[List[str]]:
        """Iterative DFS src→dst over ``_adj``; returns the node path or
        None. Caller holds ``self._mu``."""
        if src == dst:
            return [src]
        parent: Dict[str, str] = {src: src}
        work = [src]
        while work:
            n = work.pop()
            for m in self._adj.get(n, ()):
                if m in parent:
                    continue
                parent[m] = n
                if m == dst:
                    path = [m]
                    while path[-1] != src:
                        path.append(parent[path[-1]])
                    return list(reversed(path))
                work.append(m)
        return None

    def snapshot(self) -> Dict[str, Any]:
        with self._mu:
            return {
                "version": 1,
                "nodes": dict(self.nodes),
                "edges": [{"from": a, "to": b, "count": n}
                          for (a, b), n in sorted(self.edges.items())],
                "acquisitions": self.acquisitions,
                "violations": [dict(v) for v in self.violations],
            }


class _InstrumentedLock:
    """Wraps a real lock; reports acquire/release to the graph.

    Unknown attributes delegate to the inner lock, which keeps
    ``threading.Condition`` working either way: wrapping an RLock,
    Condition finds the real ``_release_save``/``_acquire_restore`` and
    bypasses the wrapper symmetrically across ``wait()`` (held stack
    correctly unchanged); wrapping a Lock, the delegation raises
    AttributeError and Condition falls back to ``acquire``/``release``,
    which do report."""

    __slots__ = ("_inner", "_site")

    def __init__(self, inner, site: str):
        self._inner = inner
        self._site = site

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            _GRAPH.note_acquired(self._site)
        return got

    def release(self) -> None:
        self._inner.release()
        _GRAPH.note_released(self._site)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<InstrumentedLock {self._site} of {self._inner!r}>"

    def __getattr__(self, name: str):
        return getattr(self._inner, name)


_GRAPH = LockGraph()
_active = False
_dump_path: Optional[str] = None


def _creation_site() -> Optional[str]:
    """``relpath:lineno`` of the frame calling the lock factory, or
    None when that frame is not nnstreamer_tpu_torch code (stdlib internals —
    queue.Queue's mutex, Condition's default RLock — stay real)."""
    try:
        frame = sys._getframe(2)
    except ValueError:          # pragma: no cover — no caller frame
        return None
    fn = frame.f_code.co_filename
    if not fn.startswith(_PKG_ROOT + os.sep) or fn == __file__:
        return None
    rel = os.path.relpath(fn, _REL_BASE)
    return f"{rel.replace(os.sep, '/')}:{frame.f_lineno}"


def _lock_factory():
    site = _creation_site()
    inner = _REAL_LOCK()
    if site is None:
        return inner
    _GRAPH.note_created(site, "lock")
    return _InstrumentedLock(inner, site)


def _rlock_factory():
    site = _creation_site()
    inner = _REAL_RLOCK()
    if site is None:
        return inner
    _GRAPH.note_created(site, "rlock")
    return _InstrumentedLock(inner, site)


def is_active() -> bool:
    return _active


def graph() -> LockGraph:
    return _GRAPH


def activate() -> None:
    """Patch the ``threading`` lock factories. Idempotent. Locks created
    BEFORE activation stay real — arm before importing modules whose
    import creates locks (the package ``__init__`` does this when the
    env var is set, ahead of every other import)."""
    global _active
    if _active:
        return
    _active = True
    threading.Lock = _lock_factory          # type: ignore[assignment]
    threading.RLock = _rlock_factory        # type: ignore[assignment]


def deactivate() -> LockGraph:
    """Restore the real factories; existing instrumented locks keep
    working (they hold real locks inside). Returns the graph."""
    global _active
    threading.Lock = _REAL_LOCK             # type: ignore[assignment]
    threading.RLock = _REAL_RLOCK           # type: ignore[assignment]
    _active = False
    return _GRAPH


def reset() -> None:
    """Fresh graph (tests): forget nodes, edges, and violations."""
    global _GRAPH
    _GRAPH = LockGraph()


def snapshot() -> Dict[str, Any]:
    return _GRAPH.snapshot()


def dump(path: str) -> str:
    """Write the observed graph as JSON (atomic tmp+rename)."""
    snap = snapshot()
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(snap, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    return path


def _dump_atexit() -> None:     # pragma: no cover — exercised via CI
    if _dump_path:
        try:
            dump(_dump_path)
        except OSError as e:
            # lazy import: lockgraph must import nothing that creates
            # locks (it runs before every other nnstreamer_tpu_torch import)
            from nnstreamer_tpu_torch.log import get_logger
            get_logger("obs.lockgraph").warning(
                "lockgraph: dump to %s failed: %s", _dump_path, e)


def maybe_activate_env() -> bool:
    """Arm from ``NNSTPU_LOCKGRAPH``: unset/``0`` → do nothing (the
    byte-identical default), ``1`` → record in-process, any other value
    → record AND dump the JSON graph to that path at exit."""
    global _dump_path
    val = os.environ.get(ENV, "").strip()
    if val in ("", "0"):
        return False
    if val != "1" and _dump_path is None:
        _dump_path = val
        atexit.register(_dump_atexit)
    activate()
    return True


def cross_check(runtime: Dict[str, Any],
                static: Dict[str, Any]) -> List[str]:
    """Validate the observed graph against the static NNS202 graph.

    Translates runtime creation-site nodes to the static graph's
    symbolic names through its ``sites`` map, unions both edge sets,
    and reports:

    - every runtime-observed cycle (``violations``);
    - any cycle in the union graph — a static order A→B combined with
      an observed order B→A is a deadlock neither view sees alone.

    Returns a list of human-readable contradictions; empty = the two
    views agree on an acyclic order."""
    sites: Dict[str, str] = static.get("sites", {})
    problems: List[str] = []
    for v in runtime.get("violations", []):
        cyc = " -> ".join(sites.get(s, s) for s in v["cycle"])
        problems.append(f"observed lock-order cycle on thread "
                        f"{v['thread']}: {cyc}")

    adj: Dict[str, Set[str]] = {}

    def add(a: str, b: str) -> None:
        if a != b:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())

    for e in static.get("edges", []):
        add(e["from"], e["to"])
    for e in runtime.get("edges", []):
        add(sites.get(e["from"], e["from"]), sites.get(e["to"], e["to"]))

    # cycle scan (iterative coloring) over the union graph
    WHITE, GREY, BLACK = 0, 1, 2
    color = {n: WHITE for n in adj}
    for root in sorted(adj):
        if color[root] != WHITE:
            continue
        stack: List[Tuple[str, Any]] = [(root, iter(sorted(adj[root])))]
        color[root] = GREY
        trail = [root]
        while stack:
            node, it = stack[-1]
            for child in it:
                if color[child] == GREY:
                    i = trail.index(child)
                    cyc = " -> ".join(trail[i:] + [child])
                    problems.append(
                        f"static/runtime contradiction: the union of "
                        f"the two graphs is cyclic: {cyc}")
                    continue
                if color[child] == WHITE:
                    color[child] = GREY
                    trail.append(child)
                    stack.append((child, iter(sorted(adj[child]))))
                    break
            else:
                color[node] = BLACK
                trail.pop()
                stack.pop()
    return problems
