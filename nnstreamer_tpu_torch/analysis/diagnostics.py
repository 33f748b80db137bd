"""Diagnostics model shared by the pipeline verifier and the AST lint.

The port of the JAX package's model; the codes and the JSON schema are
the same, and only the meanings of the five rules that looked for JAX
calls (NNS107, NNS108, NNS113, NNS117, NNS118) name PyTorch's.

One value type for every finding (``Diagnostic``: code, severity,
location, message, hint) so both halves of ``nns-lint`` — the static
pipeline verifier (``NNS0xx``) and the project-invariant AST rules
(``NNS1xx``) — render through the same text and JSON writers and gate CI
through the same exit-code policy. The shape mirrors what compiler-first
stream checkers emit (one record per finding, machine-readable), which is
what lets the CI job and ``tests/test_static_gates.py`` consume the same
output.

JSON schema (documented in ``docs/linting.md``; ``version`` bumps on any
incompatible change)::

    {"version": 1,
     "diagnostics": [{"code": "NNS001", "severity": "error",
                      "message": "...", "hint": "..." | null,
                      "loc": {"source": "...", "line": 1, "column": 37}}],
     "summary": {"error": N, "warning": N, "info": N}}
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

ERROR = "error"
WARNING = "warning"
INFO = "info"

_SEV_ORDER = {ERROR: 0, WARNING: 1, INFO: 2}

#: every diagnostic code with its one-line meaning — the table rendered in
#: docs/linting.md. NNS0xx: pipeline-graph findings; NNS1xx: AST rules;
#: NNS2xx: whole-program concurrency analysis.
CODE_TABLE: Dict[str, str] = {
    # -- graph (static pipeline verifier) ------------------------------------
    "NNS001": "unknown element factory",
    "NNS002": "unknown element property",
    "NNS003": "duplicate element name",
    "NNS004": "unknown element/pad reference",
    "NNS005": "empty caps intersection on a link (format mismatch)",
    "NNS006": "dangling pad (unlinked input, or dropped output)",
    "NNS007": "cycle in the pipeline graph",
    "NNS008": "mux/merge sync-policy conflict",
    "NNS009": "tee fan-out without queue (serialization/deadlock risk)",
    "NNS010": "leaky queue without drop monitoring",
    "NNS011": "unknown tensor_filter framework / subplugin",
    "NNS012": "description syntax error",
    # -- code (project-invariant AST lint) -----------------------------------
    "NNS101": "wall-clock time.time() where monotonic is required",
    "NNS102": "blocking call (sleep/join/socket IO) while holding a lock",
    "NNS103": "print() in library code (use log.py)",
    "NNS104": "bare or blind except (silently swallowed broad exception)",
    "NNS105": "thread created without an explicit daemon= choice",
    "NNS106": "metric name violates the nns_<subsystem>_ convention",
    "NNS107": "sync-forcing call in a per-frame hot path (defeats the "
              "dispatch window)",
    "NNS108": "direct tensor materialization outside the sanctioned "
              "to_host() site (bypasses the buffer's host-view cache and "
              "the transfer counters)",
    "NNS109": "REORDER_SAFE class whose per-frame chain mutates self "
              "state (lane clones would diverge from the serial element)",
    "NNS110": "blocking sleep or unbounded wait in a scheduler/dispatch "
              "hot path (stales admission decisions, wedges EOS)",
    "NNS111": "broad except in an element chain/worker loop that "
              "neither re-raises nor posts to the pipeline bus (a dead "
              "frame becomes a silent hang)",
    "NNS112": "socket/channel send-recv in a transport hot path without "
              "an explicit timeout (a dead peer hangs the path instead "
              "of feeding the retry/hedge/breaker machinery)",
    "NNS113": "direct upload (.to(<device>), .cuda(), torch.as_tensor("
              "..., device=)) outside the HBM budget accountant's "
              "tracked entry points (bytes land in device memory that "
              "nns_mem_used_bytes never sees, so the pressure ladder "
              "runs on an undercount)",
    "NNS114": "unbounded list.append/deque() without maxlen in an obs "
              "hot-path recording function (always-on telemetry records "
              "on every frame for the process lifetime — an unbounded "
              "container there is a slow leak)",
    "NNS115": "checkpoint save/load key-set drift: a snapshot/restore or "
              "checkpoint_state/restore_state pair whose literal state "
              "keys disagree (a saved key the load never reads is dead "
              "state; a read key the save never writes is absent on "
              "every real restore)",
    "NNS116": "wire-header struct format vs pack/unpack site field-count "
              "disagreement (a NAME.pack(...) passing the wrong number "
              "of values, or a tuple-unpack binding the wrong number of "
              "names, raises only at runtime — on the first real frame, "
              "usually on the peer)",
    "NNS117": "mesh placement constructed outside the parallel package "
              "(Placement/ShardedTensor/shard_tensor anywhere else "
              "scatters placement decisions the parallel package keeps "
              "auditable — pass a mesh spec or plan instead)",
    "NNS118": "direct subscript of a paged KV arena outside "
              "serving/kvpool.py (block refcounts, the trash block and "
              "the storage a captured graph replays against live in the "
              "pool; a raw arena index elsewhere can read a freed "
              "block's stale bytes or rebind a leaf the graph writes)",
    "NNS119": "hard-coded host:port endpoint literal outside "
              "query/discovery.py, config modules, and tests (fleet "
              "replicas bind ephemeral ports and move at every deploy — "
              "a baked-in endpoint pins code to one replica and "
              "bypasses discovery, the breaker, and the balancer)",
    "NNS199": "nns-lint pragma without a justification",
    # -- concurrency (whole-program analysis) --------------------------------
    "NNS201": "access to a lock-guarded attribute outside the lock (the "
              "class mutates it under its lock everywhere else, so the "
              "unguarded access races every locked reader/writer)",
    "NNS202": "lock-order cycle in the project-wide acquisition graph "
              "(two threads taking the same locks in opposite orders "
              "deadlock), or a non-reentrant lock re-acquired while held",
    "NNS203": "check-then-act race: membership test and mutation of a "
              "lock-guarded container in separate critical sections "
              "(another thread can interleave between test and act)",
    "NNS204": "foreign call under lock: a callback/hook/fn-gauge or "
              "pipeline-bus post invoked while holding a subsystem lock "
              "(the callee may block or re-enter — the reentrancy-"
              "deadlock shape)",
}


@dataclasses.dataclass(frozen=True)
class Location:
    """Where a finding points: a source identifier plus 1-based line and
    column. For pipeline descriptions ``source`` is the file (or
    ``<description>``) and ``line`` is 1 unless the description came from
    a multi-line file."""

    source: str = "<description>"
    line: int = 1
    column: int = 1

    def __str__(self):
        return f"{self.source}:{self.line}:{self.column}"


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: stable code, severity, location, message, fix hint."""

    code: str
    severity: str          # ERROR | WARNING | INFO
    loc: Location
    message: str
    hint: Optional[str] = None

    def render(self) -> str:
        out = f"{self.loc}: {self.severity}: {self.code} {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out

    def to_json(self) -> dict:
        return {
            "code": self.code,
            "severity": self.severity,
            "message": self.message,
            "hint": self.hint,
            "loc": {"source": self.loc.source, "line": self.loc.line,
                    "column": self.loc.column},
        }


def sort_diagnostics(diags: List[Diagnostic]) -> List[Diagnostic]:
    """Stable order: by source, line, column, then severity."""
    return sorted(diags, key=lambda d: (d.loc.source, d.loc.line,
                                        d.loc.column,
                                        _SEV_ORDER.get(d.severity, 9),
                                        d.code))


def summarize(diags: List[Diagnostic]) -> Dict[str, int]:
    out = {ERROR: 0, WARNING: 0, INFO: 0}
    for d in diags:
        out[d.severity] = out.get(d.severity, 0) + 1
    return out


def render_text(diags: List[Diagnostic]) -> str:
    diags = sort_diagnostics(diags)
    lines = [d.render() for d in diags]
    s = summarize(diags)
    lines.append(f"nns-lint: {s[ERROR]} error(s), {s[WARNING]} warning(s), "
                 f"{s[INFO]} info")
    return "\n".join(lines)


def render_json(diags: List[Diagnostic]) -> str:
    diags = sort_diagnostics(diags)
    return json.dumps(
        {"version": 1,
         "diagnostics": [d.to_json() for d in diags],
         "summary": summarize(diags)},
        indent=2)


def has_errors(diags: List[Diagnostic]) -> bool:
    return any(d.severity == ERROR for d in diags)
