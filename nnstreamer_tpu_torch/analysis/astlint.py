"""Project-invariant AST lint — the ``NNS1xx`` half of ``nns-lint``.

The port of the JAX package's lint over ``nnstreamer_tpu_torch``. Every
rule keeps the JAX logic except the five that looked for JAX calls and
now look for their PyTorch counterparts: NNS107, NNS108, NNS113, NNS117
and NNS118.

These rules encode invariants this codebase has already been burned by
(see docs/linting.md for the rationale of each):

- NNS101: ``time.time()`` measures wall-clock, which jumps under NTP
  steps; durations and deadlines must use ``time.monotonic()``. Binding
  the value to a ``wall*``-prefixed name marks the intentional wall-clock
  uses (export timestamps) without a pragma.
- NNS102: sleeping, joining a thread, or doing socket IO while holding a
  lock serializes every other waiter behind the blocking call.
- NNS103: library code logs through ``utils/log.py``; ``print`` is only
  for CLI entry points.
- NNS104: a bare ``except:`` (or ``except Exception: pass``) swallows
  ``KeyboardInterrupt``/bugs silently.
- NNS105: a ``threading.Thread`` without an explicit ``daemon=`` choice
  inherits it implicitly — shutdown behavior should be a decision, not an
  accident.
- NNS106: metric names must follow ``nns_<subsystem>_...`` so dashboards
  can group by prefix.
- NNS107: sync-forcing calls (``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()``, ``torch.cuda.synchronize()``, ``int(t[...])`` /
  ``float(t[...])``) inside per-frame hot paths (``chain`` /
  ``chain_list`` / ``_chain_locked`` / ``device_stage``) silently
  collapse the dispatch window (``pipeline/dispatch.py``) back to
  synchronous dispatch — materialize at the fence or sink instead.
- NNS108: materializing a buffer's tensors directly
  (``np.asarray(buf.tensors[i])``, ``buf.tensors[i].cpu()`` /
  ``.numpy()`` / ``.tolist()`` / ``.to("cpu")``) bypasses the one
  sanctioned ``to_host()`` site (``tensors/buffer.py``): a buffer caches
  its host view there, so a direct fetch copies the same bytes again AND
  dodges the transfer counters (``transfer_snapshot()``,
  ``nns_transfer_*``) the bench relies on.
- NNS109: a class that declares ``REORDER_SAFE = True`` while its
  per-frame ``chain``/``chain_list`` mutates ``self`` state: the ingest
  lane planner (``pipeline/lanes.py``) replicates such elements across
  parallel worker lanes and processes frames out of order — per-frame
  mutable attributes make each lane's clone diverge from the serial
  element, so the "byte-identical to lanes=1" contract silently breaks.
- NNS110: a blocking sleep or unbounded wait (``.wait()``/``.get()``/
  ``.acquire()``/``.join()`` with no timeout) inside a scheduler or
  dispatch hot path (admission, EDF drain, feedback-controller step —
  see ``_SCHED_HOT_FUNCS``): the SLO scheduler's whole deadline math
  assumes these paths are event-driven and O(work); one
  ``time.sleep``-style pacing loop or forever-wait turns every
  admission decision stale and stalls EOS/teardown behind it.
- NNS111: a broad ``except Exception``/``BaseException`` inside an
  element chain or worker loop (``chain`` / ``chain_list`` /
  ``run_loop`` / ``_worker`` / ``_drain`` / ``_drain_sched`` /
  ``_drain_loop`` — see ``_WORKER_FUNCS``) whose handler neither
  re-raises nor posts to the pipeline bus
  (``post_error``/``post_message``/``post_warning``): these are the
  exception boundaries the supervision layer (``pipeline/supervise.py``)
  and the bus ``wait()`` contract rely on — a handler that only logs
  (or does nothing) converts a dead frame into a silent hang, because
  downstream never sees an error message and EOS never arrives.
- NNS112: socket/channel IO without an explicit timeout inside a
  transport hot path (connect, framed send/recv, result routing,
  broker publish — see ``_TRANSPORT_HOT_FUNCS``): the resilience layer
  (``query/resilience.py``) can only retry, hedge, or trip a breaker
  when the underlying call BOUNDS its wait — an untimed ``connect()``
  or ``recv()`` turns a dead peer into an indefinite hang that no
  deadline or supervisor ever sees. A call is fine when the enclosing
  function passes ``timeout=`` at the call, calls ``settimeout(...)``
  on the socket, or sets ``SO_SNDTIMEO``/``SO_RCVTIMEO`` (the
  send-side discipline used by ``query/mqtt.py``).
- NNS113: a direct upload — ``.to(<device>)``, ``.cuda()`` or
  ``torch.as_tensor(..., device=)`` — outside the HBM budget
  accountant's tracked entry points (``TensorBuffer.to_device`` /
  ``upload_many``, the backend ``open()`` weight load and
  ``install_weights()`` swap — see ``_MEM_SANCTIONED_FUNCS``): bytes
  it moves land in device memory
  that ``nns_mem_used_bytes`` never sees, so the pressure ladder and
  residency eviction math (``tensors/memory.py``) run against an
  undercount exactly when HBM is the scarce resource.
- NNS114: an unbounded container fed from an obs hot-path recording
  function (``span``/``mark``/``observe``/``record*``/``note*``/
  ``add`` — see ``_OBS_RECORD_FUNCS``) in the ``obs`` package: a
  ``deque()`` built without ``maxlen``, or ``self.x.append(...)``
  where ``__init__`` bound ``self.x`` to a bare ``[]``/``list()``/
  unbounded ``deque()``. The always-on telemetry layer (flight
  recorder, timeline rings, quantile estimators) records on EVERY
  frame for the life of the process — one unbounded append there is a
  slow memory leak in the exact component that must never cost
  anything. Bounded-by-construction exceptions take a pragma.
- NNS115: a checkpointable class whose save/load key sets drift. For a
  class defining a ``snapshot()``/``restore()`` or
  ``checkpoint_state()``/``restore_state()`` pair (the serving-
  continuity protocol, ``pipeline/continuity.py``), the string-literal
  keys the save method writes must equal the keys the load method
  reads: a key saved but never restored is dead state that silently
  stops round-tripping, a key restored but never saved reads as absent
  on every real checkpoint. Classes whose schema is dynamic (no
  literal keys on one side, e.g. ``TensorRepo``) are skipped.
- NNS117: a mesh placement constructed outside the ``parallel``
  package: a ``Placement`` (the port's ``NamedSharding``), a
  ``ShardedTensor`` or a ``shard_tensor`` call anywhere else scatters
  device-placement decisions across the codebase. The ``parallel``
  package is the audited home for every placement: that is what makes
  the matched-sharding hand-off contract and the per-shard HBM
  accounting enforceable. Callers pass a mesh-spec string (``mesh=dp4``)
  or a plan object around and place through ``parallel.serve``
  (``place_batch``, ``place_params``, ``place_tree``) instead.
- NNS116: a wire-header ``struct.Struct`` whose field count disagrees
  with a pack/unpack site. For every ``NAME = struct.Struct("<fmt>")``
  binding in a file, each ``NAME.pack(...)`` must pass exactly as many
  values as the format has fields, and each tuple-unpacking
  ``a, b, ... = NAME.unpack[_from](...)`` must bind exactly that many
  names. The query protocol's framed headers (``_HDR``, ``_EXT_HDR``,
  ``_EXT2_HDR``, ...) are evolved by editing the format string and its
  pack/unpack sites in separate places — a count mismatch raises only
  at runtime, on the first real frame, usually on the peer.
- NNS118: a direct subscript of a paged KV arena (a name whose final
  component is ``arena``/``_arena``/``*_arena``, its ``.values`` /
  ``.scale`` leaves included) outside ``serving/kvpool.py``: the block
  pool is the one audited home for arena reads and in-place writes —
  refcounts, the trash block and the storage a captured CUDA graph
  replays against all live there, and a raw ``arena[...]`` elsewhere
  silently breaks them (a freed block's bytes read as stale history, a
  rebound leaf leaves the graph writing to freed memory). The model
  side never sees the arena whole; it receives block tables and per-layer
  views.
- NNS119: a hard-coded ``host:port`` string literal outside
  ``query/discovery.py``, config modules, and tests. A replicated fleet
  (serving/fleet.py) moves endpoints at every deploy — replicas bind
  ephemeral ports and re-advertise through the broker — so a baked-in
  endpoint silently pins code to one replica and bypasses discovery,
  the breaker, and the balancer. Endpoints belong in element properties
  (``servers=``/``operation=``), CLI flags, or discovery ads; the
  discovery module itself and configuration defaults are the audited
  homes for literal endpoints.

Findings are suppressed per-line with::

    # nns-lint: disable=NNS101 -- <why this line is an exception>

A pragma with no justification is itself a finding (NNS199).
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from nnstreamer_tpu_torch.analysis.diagnostics import (
    ERROR,
    Diagnostic,
    Location,
    sort_diagnostics,
)

_PRAGMA_RE = re.compile(
    r"#\s*nns-lint:\s*disable=([A-Z0-9,]+)(?:\s+--\s*(\S.*))?")

#: metric-registry constructor methods whose first argument is the name
_METRIC_METHODS = {"counter", "gauge", "histogram"}
_METRIC_NAME_RE = re.compile(r"^nns_[a-z0-9]+(_[a-z0-9]+)+$")

#: socket methods that block on the network
_SOCKET_BLOCKING = {"recv", "recvfrom", "recv_into", "accept", "connect",
                    "sendall", "sendto"}

#: NNS119: a full-string ``host:port`` endpoint literal. The host part
#: must contain a letter or a dot so times ("12:30") and ratios never
#: match; the port is 2-5 digits so drive letters ("C:1") stay out
_HOSTPORT_RE = re.compile(
    r"^[A-Za-z0-9_.\-]*[A-Za-z.][A-Za-z0-9_.\-]*:\d{2,5}$")

#: sync-forcing callables by dotted name (NNS107): each one blocks the
#: caller until outstanding device work retires (or copies D2H, which
#: implies the same)
_SYNC_CALLS = {"torch.cuda.synchronize", "cuda.synchronize"}
#: tensor methods that copy device values to the host (an implied sync)
_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
#: per-frame hot-path function names where a hidden sync defeats the
#: inflight dispatch window (pipeline/dispatch.py)
_HOT_FUNCS = {"chain", "chain_list", "_chain_locked", "device_stage"}

#: scheduler/dispatch hot-path function names (NNS110): the admission,
#: EDF-drain and feedback-control paths the SLO scheduler's deadline
#: math assumes are event-driven — a sleep or forever-wait here makes
#: every admission decision stale and wedges EOS behind it
_SCHED_HOT_FUNCS = {"admit", "admit_request", "decide", "note_shed",
                    "observe_service", "observe_completion", "maybe_step",
                    "record_completion", "_apply_knobs",
                    "_chain_scheduled", "_shed_one_locked", "_flush_edf",
                    "_drain_sched", "_drain", "dispatch", "fence"}
#: attribute calls that block forever unless given a timeout
_UNBOUNDED_WAIT_ATTRS = {"wait", "wait_for", "acquire", "join", "get"}

#: element-chain / worker-loop function names (NNS111): the exception
#: boundaries that must either re-raise (so _chain_entry's policy
#: dispatch sees the failure) or post to the pipeline bus (so wait()
#: unblocks) — swallowing here turns one dead frame into a silent hang
_WORKER_FUNCS = {"chain", "chain_list", "run_loop", "_worker",
                 "_drain", "_drain_sched", "_drain_loop"}
#: bus-posting method names that count as surfacing the failure
_BUS_POST_ATTRS = {"post_error", "post_message", "post_warning"}

#: transport hot-path function names (NNS112): connection setup, framed
#: send/recv, result routing and broker publish — the paths where an
#: untimed socket wait hangs forever instead of feeding the resilience
#: layer's retry/hedge/breaker machinery
_TRANSPORT_HOT_FUNCS = {"connect", "_connect_one", "send_msg", "recv_msg",
                        "_send_buf", "_recv_result", "_r_recv", "_r_hello",
                        "send_result", "send_expired", "send_stream",
                        "recv_stream", "publish", "_recover"}

#: direct-materialization callables (NNS108): fetch device bytes while
#: bypassing the cached, counted to_host() path
_MATERIALIZE_CALLS = {"np.asarray", "numpy.asarray", "np.array",
                      "numpy.array"}
#: tensor methods that fetch a tensor to the host (NNS108 when the
#: receiver reads a buffer's ``.tensors``)
_MATERIALIZE_METHODS = {"cpu", "numpy", "tolist"}
#: functions that ARE the sanctioned materialization site — anything
#: inside them is exempt from NNS108
_SANCTIONED_FUNCS = {"to_host"}

#: the HBM budget accountant's tracked entry points (NNS113): the only
#: functions allowed to upload to the device directly, because they are
#: where the moved bytes register against tensors/memory.py — to_device/
#: upload_many (frame transfers; ``as_torch`` is the port's per-tensor
#: body of to_device, which counts each copy with note_h2d), the backend
#: open() weight load and install_weights() swap (residency-unit
#: registration; ``_install_weights`` is its body)
_MEM_SANCTIONED_FUNCS = {"to_device", "upload_many", "open",
                         "install_weights", "_install_weights",
                         "_register_resident", "as_torch"}

#: torch factories whose ``device=`` places the new tensor (NNS113)
_DEVICE_FACTORIES = {"torch.as_tensor", "torch.tensor"}

#: mesh/placement-construction callables (NNS117), matched on the last
#: dotted component: allowed only inside the ``parallel`` package — the
#: audited home of every placement decision
_SHARDING_CTORS = {"Placement", "ShardedTensor", "shard_tensor"}

#: obs hot-path recording function names (NNS114): the per-frame /
#: per-event entry points of the always-on telemetry layer — anything
#: they grow must be bounded
_OBS_RECORD_FUNCS = {"span", "mark", "observe", "add", "inc",
                     "async_begin", "async_end"}
#: recording-function name prefixes (record_completion, note_retry,
#: observe_invoke, _observe_locked, _complete, ...)
_OBS_RECORD_PREFIXES = ("record", "_record", "note", "_note",
                        "observe", "_observe", "_complete")


#: checkpoint save/load method-name pairs (NNS115): the serving-
#: continuity protocol's state round-trip — reporting-only snapshots
#: (no matching load method) are not checked
_CKPT_PAIRS = (("snapshot", "restore"),
               ("checkpoint_state", "restore_state"))


def _is_obs_record_func(name: str) -> bool:
    return name in _OBS_RECORD_FUNCS or \
        name.startswith(_OBS_RECORD_PREFIXES)


def _struct_field_count(fmt: str) -> Optional[int]:
    """Exact field count of a struct format string, or None when the
    format itself is invalid (that's the runtime's error to raise, not
    a lint finding). Computed by the struct module itself — pad bytes,
    repeat counts, and the s/p single-field rules come out right by
    construction."""
    import struct as _struct

    try:
        st = _struct.Struct(fmt)
        return len(st.unpack(bytes(st.size)))
    except _struct.error:
        return None


def _parse_pragmas(text: str) -> Tuple[Dict[int, Set[str]], List[int]]:
    """Per-line suppressed codes, plus lines with a reasonless pragma."""
    suppressed: Dict[int, Set[str]] = {}
    missing_reason: List[int] = []
    for lineno, line in enumerate(text.splitlines(), start=1):
        m = _PRAGMA_RE.search(line)
        if not m:
            continue
        codes = {c.strip() for c in m.group(1).split(",") if c.strip()}
        suppressed[lineno] = codes
        if not m.group(2):
            missing_reason.append(lineno)
    return suppressed, missing_reason


def _dotted(node: ast.AST) -> str:
    """'time.time' for Attribute/Name chains, '' for anything dynamic."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class _FileLinter(ast.NodeVisitor):
    def __init__(self, path: Path, tree: ast.Module, text: str,
                 rel: str):
        self.path = path
        self.rel = rel
        self.tree = tree
        self.text = text
        self.diags: List[Diagnostic] = []
        self._lock_depth = 0
        self._func_stack: List[str] = []
        #: the actual FunctionDef nodes of the stack (NNS112 walks the
        #: enclosing function body for timeout discipline)
        self._func_nodes: List[ast.AST] = []
        self._timeout_discipline: Dict[int, bool] = {}  # id(fnode) → bool
        self._wall_lines: Set[int] = set()
        self._collect_wall_bindings(tree)
        #: NNS116: NAME → field count for every ``NAME = struct.Struct(
        #: "<literal>")`` binding in this file
        self._struct_fields: Dict[str, int] = {}
        self._collect_struct_bindings(tree)
        #: NNS114 applies only inside the obs package
        self._in_obs = "obs" in Path(rel).parts
        #: NNS117 exempts the parallel package — the one audited home
        #: where shardings may be constructed
        self._in_parallel = "parallel" in Path(rel).parts
        #: NNS118 exempts the block pool itself — the one audited home
        #: for direct KV-arena indexing
        self._in_kvpool = Path(rel).name == "kvpool.py"
        #: NNS119 exempts the discovery module (the audited home for
        #: endpoint strings), config modules, and test code
        parts = Path(rel).parts
        fname = Path(rel).name
        self._nns119_exempt = (
            fname == "discovery.py"
            or fname in ("config.py", "settings.py", "conftest.py")
            or "tests" in parts
            or fname.startswith("test_"))

    # -- helpers -------------------------------------------------------------
    def emit(self, code: str, node: ast.AST, message: str,
             hint: Optional[str] = None) -> None:
        loc = Location(self.rel, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0) + 1)
        self.diags.append(Diagnostic(code, ERROR, loc, message, hint))

    def _collect_wall_bindings(self, tree: ast.Module) -> None:
        """Lines where time.time() is bound to a wall*-prefixed name —
        the in-code way to mark deliberate wall-clock reads."""
        for node in ast.walk(tree):
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                targets = [node.target]
            for t in targets:
                name = t.attr if isinstance(t, ast.Attribute) else \
                    t.id if isinstance(t, ast.Name) else ""
                if name.startswith("wall"):
                    for sub in ast.walk(node):
                        if hasattr(sub, "lineno"):
                            self._wall_lines.add(sub.lineno)

    def _collect_struct_bindings(self, tree: ast.Module) -> None:
        """``NAME = struct.Struct("<literal fmt>")`` bindings anywhere in
        the file (module or class level) — the wire headers NNS116
        checks pack/unpack sites against. A name bound twice with
        different formats is ambiguous and dropped."""
        ambiguous: Set[str] = set()
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assign):
                continue
            value = node.value
            if not (isinstance(value, ast.Call)
                    and _dotted(value.func) in ("struct.Struct", "Struct")
                    and value.args
                    and isinstance(value.args[0], ast.Constant)
                    and isinstance(value.args[0].value, str)):
                continue
            count = _struct_field_count(value.args[0].value)
            if count is None:
                continue
            for t in node.targets:
                if not isinstance(t, ast.Name):
                    continue
                prior = self._struct_fields.get(t.id)
                if prior is not None and prior != count:
                    ambiguous.add(t.id)
                self._struct_fields[t.id] = count
        for name in ambiguous:
            self._struct_fields.pop(name, None)

    # -- visitors ------------------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        is_lock = any("lock" in _dotted(item.context_expr.func
                                        if isinstance(item.context_expr,
                                                      ast.Call)
                                        else item.context_expr).lower()
                      for item in node.items)
        if is_lock:
            self._lock_depth += 1
            self.generic_visit(node)
            self._lock_depth -= 1
        else:
            self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._func_stack.append(node.name)
        self._func_nodes.append(node)
        self.generic_visit(node)
        self._func_nodes.pop()
        self._func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func)
        self._rule_nns101(node, dotted)
        if self._lock_depth:
            self._rule_nns102(node, dotted)
        self._rule_nns103(node, dotted)
        self._rule_nns105(node, dotted)
        self._rule_nns106(node, dotted)
        self._rule_nns107(node, dotted)
        self._rule_nns108(node, dotted)
        self._rule_nns110(node, dotted)
        self._rule_nns112(node, dotted)
        self._rule_nns113(node, dotted)
        self._rule_nns114_deque(node, dotted)
        self._rule_nns117(node, dotted)
        self._rule_nns116_pack(node)
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        self._rule_nns116_unpack(node)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        self._rule_nns118(node)
        self.generic_visit(node)

    def visit_Constant(self, node: ast.Constant) -> None:
        self._rule_nns119(node)
        self.generic_visit(node)

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        self._rule_nns104(node)
        self._rule_nns111(node)
        self.generic_visit(node)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._rule_nns109(node)
        self._rule_nns114_append(node)
        self._rule_nns115(node)
        self.generic_visit(node)

    # -- rules ---------------------------------------------------------------
    def _rule_nns101(self, node: ast.Call, dotted: str) -> None:
        if dotted != "time.time":
            return
        if node.lineno in self._wall_lines:
            return
        self.emit(
            "NNS101", node,
            "time.time() is wall-clock and jumps under NTP steps — use "
            "time.monotonic() for durations and deadlines",
            hint="if this really is an export timestamp, bind it to a "
                 "wall*-prefixed name or add a justified pragma")

    def _rule_nns102(self, node: ast.Call, dotted: str) -> None:
        blocking: Optional[str] = None
        if dotted == "time.sleep":
            blocking = "time.sleep"
        elif isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr == "join" and self._looks_like_thread_join(node):
                blocking = "thread join"
            elif attr in _SOCKET_BLOCKING:
                blocking = f"socket .{attr}()"
        if blocking:
            self.emit(
                "NNS102", node,
                f"{blocking} while holding a lock — every other waiter "
                f"stalls behind this call",
                hint="copy state under the lock, block outside it")

    @staticmethod
    def _looks_like_thread_join(node: ast.Call) -> bool:
        """Disambiguate Thread.join from str.join: a thread join takes
        no args, a timeout kwarg, or a single numeric positional."""
        if any(kw.arg == "timeout" for kw in node.keywords):
            return True
        if not node.args and not node.keywords:
            return True
        if len(node.args) == 1 and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, (int, float)) \
                and not isinstance(node.args[0].value, bool):
            return True
        return False

    def _rule_nns103(self, node: ast.Call, dotted: str) -> None:
        if dotted != "print":
            return
        if self.path.name == "cli.py" or "main" in self._func_stack:
            return
        self.emit(
            "NNS103", node,
            "print() in library code bypasses the logging pipeline",
            hint="use nnstreamer_tpu_torch.utils.log (or move this into a CLI "
                 "main())")

    def _rule_nns104(self, node: ast.ExceptHandler) -> None:
        if node.type is None:
            self.emit(
                "NNS104", node,
                "bare 'except:' also catches KeyboardInterrupt/SystemExit",
                hint="name the exception type (Exception at the broadest)")
            return
        names = [_dotted(node.type)]
        if isinstance(node.type, ast.Tuple):
            names = [_dotted(e) for e in node.type.elts]
        broad = any(n in ("Exception", "BaseException") for n in names)
        body_is_pass = all(isinstance(s, ast.Pass) for s in node.body)
        if broad and body_is_pass:
            self.emit(
                "NNS104", node,
                "'except Exception: pass' silently swallows every bug",
                hint="log the exception, narrow the type, or justify "
                     "with a pragma")

    def _rule_nns111(self, node: ast.ExceptHandler) -> None:
        if not any(f in _WORKER_FUNCS for f in self._func_stack):
            return
        if node.type is None:
            return  # bare except: is NNS104's finding already
        names = [_dotted(node.type)]
        if isinstance(node.type, ast.Tuple):
            names = [_dotted(e) for e in node.type.elts]
        if not any(n in ("Exception", "BaseException") for n in names):
            return
        if all(isinstance(s, ast.Pass) for s in node.body):
            return  # broad+pass is NNS104's finding already
        for sub in ast.walk(ast.Module(body=node.body, type_ignores=[])):
            if isinstance(sub, ast.Raise):
                return
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr in _BUS_POST_ATTRS:
                return
        self.emit(
            "NNS111", node,
            "broad except in an element chain/worker loop that neither "
            "re-raises nor posts to the pipeline bus — the dead frame "
            "becomes a silent hang (no error message, no EOS)",
            hint="re-raise (let _chain_entry's error-policy handle it), "
                 "call post_error/post_warning, or justify with a pragma")

    def _rule_nns105(self, node: ast.Call, dotted: str) -> None:
        if dotted not in ("threading.Thread", "Thread"):
            return
        if any(kw.arg == "daemon" for kw in node.keywords):
            return
        self.emit(
            "NNS105", node,
            "Thread without an explicit daemon= choice — shutdown "
            "behavior becomes an accident of the spawning thread",
            hint="pass daemon=True (reaped at exit) or daemon=False "
                 "(must be joined), whichever you actually mean")

    def _rule_nns106(self, node: ast.Call, dotted: str) -> None:
        if not isinstance(node.func, ast.Attribute) or \
                node.func.attr not in _METRIC_METHODS:
            return
        if not node.args:
            return
        first = node.args[0]
        if not (isinstance(first, ast.Constant)
                and isinstance(first.value, str)):
            return
        name = first.value
        if not _METRIC_NAME_RE.match(name):
            self.emit(
                "NNS106", first,
                f"metric name {name!r} violates the nns_<subsystem>_... "
                f"convention",
                hint="lowercase, nns_ prefix, >=2 more _-separated parts")

    def _rule_nns107(self, node: ast.Call, dotted: str) -> None:
        if not any(f in _HOT_FUNCS for f in self._func_stack):
            return
        what: Optional[str] = None
        if dotted in _SYNC_CALLS:
            what = f"{dotted}()"
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr in _SYNC_METHODS and not node.args:
            what = f".{node.func.attr}()"
        elif dotted in ("float", "int") and len(node.args) == 1 and \
                isinstance(node.args[0], ast.Subscript):
            # float(out[0]) / int(scores[i]) on a device tensor blocks on
            # the whole dispatch to fetch one scalar
            what = f"{dotted}(t[...])"
        if what is None:
            return
        self.emit(
            "NNS107", node,
            f"{what} in a per-frame hot path forces a device sync — the "
            f"inflight dispatch window silently collapses to synchronous "
            f"dispatch",
            hint="materialize at the fence/sink (to_host, "
                 "materialize-host queue) or justify host-only use with "
                 "a pragma")

    def _rule_nns108(self, node: ast.Call, dotted: str) -> None:
        if any(f in _SANCTIONED_FUNCS for f in self._func_stack):
            return
        what: Optional[str] = None
        if dotted in _MATERIALIZE_CALLS and node.args and \
                self._touches_buffer_tensors(node.args[0]):
            # np.asarray(buf.tensors[i]) — fetching a buffer's payload
            # around the wrapper; plain np.asarray(x) on a loose array
            # is NNS107's business, not this rule's
            what = f"{dotted}(...tensors...)"
        elif isinstance(node.func, ast.Attribute) and \
                self._touches_buffer_tensors(node.func.value) and \
                (node.func.attr in _MATERIALIZE_METHODS
                 or (node.func.attr == "to" and self._is_cpu_target(node))):
            what = f"...tensors....{node.func.attr}(...)"
        if what is None:
            return
        self.emit(
            "NNS108", node,
            f"{what} materializes buffer tensors around the sanctioned "
            f"to_host() site — a buffer's cached host view is "
            f"bypassed (double copy) and the nns_transfer_* counters "
            f"miss the fetch",
            hint="call buf.to_host() (cached, counted) or justify a "
                 "host-only payload with a pragma")

    def _rule_nns110(self, node: ast.Call, dotted: str) -> None:
        if not any(f in _SCHED_HOT_FUNCS for f in self._func_stack):
            return
        what: Optional[str] = None
        if dotted == "time.sleep":
            what = "time.sleep()"
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr in _UNBOUNDED_WAIT_ATTRS and \
                not self._is_bounded_wait(node):
            what = f".{node.func.attr}() without a timeout"
        if what is None:
            return
        self.emit(
            "NNS110", node,
            f"{what} in a scheduler/dispatch hot path — deadline "
            f"admission assumes these paths are event-driven; a sleep or "
            f"forever-wait makes every admission decision stale and "
            f"stalls EOS/teardown behind it",
            hint="bound the wait (timeout=...), restructure around a "
                 "wake token/condition with a deadline, or justify with "
                 "a pragma")

    @staticmethod
    def _is_bounded_wait(node: ast.Call) -> bool:
        """A wait call is bounded when it passes any timeout: a
        ``timeout=`` kwarg, or a positional argument (``ev.wait(0.5)``,
        ``cv.wait_for(pred, 0.5)`` — and ``d.get(key[, default])`` /
        ``sem.acquire(False)`` stop being forever-blocking calls at
        all, so any-positional is the conservative no-finding side)."""
        if any(kw.arg == "timeout" for kw in node.keywords):
            return True
        if node.func.attr == "wait_for":
            return len(node.args) > 1
        return bool(node.args)

    def _rule_nns112(self, node: ast.Call, dotted: str) -> None:
        if not any(f in _TRANSPORT_HOT_FUNCS for f in self._func_stack):
            return
        what: Optional[str] = None
        if dotted.endswith("create_connection") and \
                not any(kw.arg == "timeout" for kw in node.keywords) and \
                len(node.args) < 2:
            # create_connection(addr[, timeout]) — positional 2nd arg IS
            # the timeout, so only the one-arg untimed form is a finding
            what = "create_connection() without a timeout"
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr in _SOCKET_BLOCKING and \
                not any(kw.arg == "timeout" for kw in node.keywords) and \
                not self._enclosing_has_timeout_discipline():
            what = f"socket .{node.func.attr}() with no timeout " \
                   f"discipline in scope"
        if what is None:
            return
        self.emit(
            "NNS112", node,
            f"{what} in a transport hot path — a dead peer becomes an "
            f"indefinite hang the retry/hedge/breaker machinery never "
            f"observes",
            hint="pass timeout=, call settimeout(...) in this function, "
                 "set SO_SNDTIMEO/SO_RCVTIMEO, or justify with a pragma")

    def _rule_nns113(self, node: ast.Call, dotted: str) -> None:
        what = self._upload_call(node, dotted)
        if what is None:
            return
        if any(f in _MEM_SANCTIONED_FUNCS for f in self._func_stack):
            return
        self.emit(
            "NNS113", node,
            f"direct upload {what} outside the HBM budget accountant's "
            "tracked entry points — the moved bytes never register "
            "against nns_mem_used_bytes, so the pressure ladder and "
            "residency eviction math run on an undercount",
            hint="route the upload through TensorBuffer.to_device/"
                 "upload_many, register the bytes with tensors/memory.py "
                 "(residency unit or note_h2d), or justify with a pragma")

    def _rule_nns117(self, node: ast.Call, dotted: str) -> None:
        if self._in_parallel or not dotted or \
                dotted.rsplit(".", 1)[-1] not in _SHARDING_CTORS:
            return
        self.emit(
            "NNS117", node,
            f"{dotted}(...) constructs a mesh placement outside the "
            f"parallel package — placement decisions "
            f"scattered across the codebase break the matched-sharding "
            f"hand-off contract and the per-shard HBM accounting the "
            f"parallel package makes auditable",
            hint="name a mesh spec (mesh=dp4) and place through "
                 "parallel.serve (place_batch/place_params/place_tree) — "
                 "or justify with a pragma")

    @staticmethod
    def _is_device_expr(arg: ast.AST) -> bool:
        """A device-looking argument of ``.to(...)``: a ``"cuda..."`` /
        ``"cpu"`` literal, ``torch.device(...)``, a device getter, or a
        name or attribute spelled ``device``/``dev``/``*_device``."""
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value.split(":", 1)[0] in ("cuda", "cpu", "meta")
        if isinstance(arg, ast.Call):
            last = _dotted(arg.func).rsplit(".", 1)[-1]
            return last in ("device", "get_device", "resolve_device",
                            "current_device")
        last = _dotted(arg).rsplit(".", 1)[-1].lower()
        return last in ("device", "dev", "_device", "_dev") or \
            last.endswith("_device")

    def _is_cpu_target(self, node: ast.Call) -> bool:
        """``.to("cpu")`` / ``.to(device="cpu")``: a host fetch."""
        args = list(node.args) + [kw.value for kw in node.keywords
                                  if kw.arg == "device"]
        return any(isinstance(a, ast.Constant) and a.value == "cpu"
                   for a in args)

    def _upload_call(self, node: ast.Call, dotted: str) -> Optional[str]:
        """The NNS113 upload spelled by this call, or None."""
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr == "cuda" and not dotted.startswith("torch."):
                return ".cuda()"
            if attr == "to" and not self._is_cpu_target(node) and any(
                    self._is_device_expr(a) for a in
                    list(node.args) + [kw.value for kw in node.keywords
                                       if kw.arg == "device"]):
                return ".to(<device>)"
        if dotted in _DEVICE_FACTORIES and \
                any(kw.arg == "device" for kw in node.keywords):
            return f"{dotted}(..., device=)"
        return None

    def _rule_nns118(self, node: ast.Subscript) -> None:
        if self._in_kvpool:
            return
        dotted = _dotted(node.value)
        for leaf in (".values", ".scale"):
            if dotted.endswith(leaf):
                dotted = dotted[:-len(leaf)]  # x.arena.values[...]
        if not dotted:
            return
        last = dotted.rsplit(".", 1)[-1]
        if not (last in ("arena", "_arena") or last.endswith("_arena")):
            return
        self.emit(
            "NNS118", node,
            f"direct subscript of KV arena {dotted!r} outside "
            f"serving/kvpool.py — block refcounts, the trash block and "
            f"the storage a captured graph replays against live in the "
            f"pool; a raw arena index elsewhere can read a freed block's "
            f"stale bytes or rebind a leaf the graph still writes",
            hint="go through the pool (BlockPool's scatter/copy helpers) "
                 "or the models/transformer.py paged paths, which take "
                 "block tables — or justify with a pragma")

    def _rule_nns119(self, node: ast.Constant) -> None:
        if self._nns119_exempt:
            return
        if not isinstance(node.value, str):
            return
        if not _HOSTPORT_RE.match(node.value):
            return
        self.emit(
            "NNS119", node,
            f"hard-coded endpoint literal {node.value!r} — fleet "
            f"replicas bind ephemeral ports and move at every deploy, "
            f"so a baked-in host:port pins this code to one replica and "
            f"bypasses discovery, the circuit breaker, and the "
            f"shortest-slack balancer",
            hint="take the endpoint from an element property (servers=/"
                 "operation=), a CLI flag, or a discovery ad "
                 "(query/discovery.py) — or justify with a pragma")

    def _rule_nns114_deque(self, node: ast.Call, dotted: str) -> None:
        if not self._in_obs:
            return
        if not any(_is_obs_record_func(f) for f in self._func_stack):
            return
        if dotted not in ("deque", "collections.deque"):
            return
        # deque(iterable, maxlen) — the 2nd positional IS the bound
        if len(node.args) >= 2 or \
                any(kw.arg == "maxlen" for kw in node.keywords):
            return
        self.emit(
            "NNS114", node,
            "deque() without maxlen built in an obs hot-path recording "
            "function — always-on telemetry records on every frame for "
            "the process lifetime, so an unbounded container here is a "
            "slow leak",
            hint="pass maxlen=<ring capacity>, or justify a "
                 "bounded-by-construction container with a pragma")

    def _rule_nns114_append(self, node: ast.ClassDef) -> None:
        """Flag ``self.x.append/extend(...)`` inside a recording method
        when the class's ``__init__`` bound ``self.x`` to an unbounded
        list or deque."""
        if not self._in_obs:
            return
        unbounded = self._unbounded_init_attrs(node)
        if not unbounded:
            return
        growers = {"append", "appendleft", "extend", "extendleft",
                   "insert"}
        for stmt in node.body:
            if not isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if not _is_obs_record_func(stmt.name):
                continue
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute) and \
                        sub.func.attr in growers and \
                        isinstance(sub.func.value, ast.Attribute) and \
                        isinstance(sub.func.value.value, ast.Name) and \
                        sub.func.value.value.id == "self" and \
                        sub.func.value.attr in unbounded:
                    attr = sub.func.value.attr
                    self.emit(
                        "NNS114", sub,
                        f"{node.name}.{stmt.name}() grows self.{attr}, "
                        f"which __init__ binds unbounded — an obs "
                        f"recording path runs on every frame for the "
                        f"process lifetime, so this container is a slow "
                        f"leak",
                        hint=f"bind self.{attr} to deque(maxlen=...) (or "
                             f"prune at a cap), or justify a bounded-by-"
                             f"construction container with a pragma")

    def _rule_nns116_pack(self, node: ast.Call) -> None:
        """``NAME.pack(...)`` / ``NAME.pack_into(buf, off, ...)`` whose
        value count disagrees with NAME's format field count."""
        if not self._struct_fields:
            return
        func = node.func
        if not (isinstance(func, ast.Attribute)
                and func.attr in ("pack", "pack_into")
                and isinstance(func.value, ast.Name)):
            return
        expected = self._struct_fields.get(func.value.id)
        if expected is None:
            return
        if any(isinstance(a, ast.Starred) for a in node.args) \
                or node.keywords:
            return  # dynamic arity: no evidence of a mismatch
        args = node.args[2:] if func.attr == "pack_into" else node.args
        if len(args) == expected:
            return
        self.emit(
            "NNS116", node,
            f"{func.value.id}.{func.attr}() passes {len(args)} value(s) "
            f"but the format declares {expected} field(s) — this wire "
            f"header raises struct.error on the first real frame",
            hint="the format string and its pack/unpack sites evolved "
                 "apart; update whichever side is stale (every site "
                 "must agree with the struct.Struct field count)")

    def _rule_nns116_unpack(self, node: ast.Assign) -> None:
        """``a, b, ... = NAME.unpack[_from](...)`` whose tuple arity
        disagrees with NAME's format field count. A non-tuple target
        (``vals = ...``) or a starred element is dynamic — skipped."""
        if not self._struct_fields:
            return
        value = node.value
        if not (isinstance(value, ast.Call)
                and isinstance(value.func, ast.Attribute)
                and value.func.attr in ("unpack", "unpack_from")
                and isinstance(value.func.value, ast.Name)):
            return
        expected = self._struct_fields.get(value.func.value.id)
        if expected is None or len(node.targets) != 1:
            return
        target = node.targets[0]
        if not isinstance(target, ast.Tuple) or \
                any(isinstance(e, ast.Starred) for e in target.elts):
            return
        if len(target.elts) == expected:
            return
        self.emit(
            "NNS116", node,
            f"unpacking {value.func.value.id}.{value.func.attr}() into "
            f"{len(target.elts)} name(s) but the format declares "
            f"{expected} field(s) — this wire header raises ValueError "
            f"on the first real frame",
            hint="the format string and its pack/unpack sites evolved "
                 "apart; update whichever side is stale (every site "
                 "must agree with the struct.Struct field count)")

    def _rule_nns115(self, node: ast.ClassDef) -> None:
        """Key drift between a checkpoint save/load pair: the literal
        keys the save method writes vs the keys the load method reads.
        Either side having NO literal keys means a dynamic schema —
        no evidence of drift, so no finding."""
        methods = {stmt.name: stmt for stmt in node.body
                   if isinstance(stmt, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))}
        for save_name, load_name in _CKPT_PAIRS:
            save = methods.get(save_name)
            load = methods.get(load_name)
            if save is None or load is None:
                continue
            written = self._ckpt_keys_written(save)
            read = self._ckpt_keys_read(load)
            if not written or not read:
                continue
            drift = []
            missing = sorted(written - read)
            extra = sorted(read - written)
            if missing:
                drift.append("saved but never restored: "
                             + ", ".join(repr(k) for k in missing))
            if extra:
                drift.append("restored but never saved: "
                             + ", ".join(repr(k) for k in extra))
            if not drift:
                continue
            self.emit(
                "NNS115", save,
                f"{node.name}.{save_name}()/{load_name}() checkpoint "
                f"key sets drift — " + "; ".join(drift),
                hint="make the save-side literal keys and the load-side "
                     "reads symmetric (a saved key the load never reads "
                     "is dead state; a read key the save never writes is "
                     "always absent), or justify an intentional "
                     "asymmetry with a pragma")

    @staticmethod
    def _ckpt_keys_written(func: ast.AST) -> Set[str]:
        """String-literal keys the save method writes: dict-literal
        keys, ``d["k"] = ...`` subscript stores, and ``dict(k=...)``
        keywords."""
        out: Set[str] = set()
        for sub in ast.walk(func):
            if isinstance(sub, ast.Dict):
                for k in sub.keys:
                    if isinstance(k, ast.Constant) and \
                            isinstance(k.value, str):
                        out.add(k.value)
            elif isinstance(sub, ast.Assign):
                for t in sub.targets:
                    if isinstance(t, ast.Subscript) and \
                            isinstance(t.slice, ast.Constant) and \
                            isinstance(t.slice.value, str):
                        out.add(t.slice.value)
            elif isinstance(sub, ast.Call) and \
                    _dotted(sub.func) == "dict":
                for kw in sub.keywords:
                    if kw.arg:
                        out.add(kw.arg)
        return out

    @staticmethod
    def _ckpt_keys_read(func: ast.AST) -> Set[str]:
        """String-literal keys the load method reads: ``state["k"]``
        subscript loads and ``.get("k")`` / ``.pop("k")`` calls."""
        out: Set[str] = set()
        stored: Set[int] = set()
        for sub in ast.walk(func):
            if isinstance(sub, ast.Assign):
                for t in sub.targets:
                    if isinstance(t, ast.Subscript):
                        stored.add(id(t))
        for sub in ast.walk(func):
            if isinstance(sub, ast.Subscript) and id(sub) not in stored \
                    and isinstance(sub.slice, ast.Constant) and \
                    isinstance(sub.slice.value, str):
                out.add(sub.slice.value)
            elif isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr in ("get", "pop") and sub.args and \
                    isinstance(sub.args[0], ast.Constant) and \
                    isinstance(sub.args[0].value, str):
                out.add(sub.args[0].value)
        return out

    @staticmethod
    def _unbounded_init_attrs(node: ast.ClassDef) -> Set[str]:
        """Attrs that ``__init__`` binds to ``[]``, ``list()``, or a
        ``deque`` without maxlen."""
        out: Set[str] = set()
        for stmt in node.body:
            if not (isinstance(stmt, ast.FunctionDef)
                    and stmt.name == "__init__"):
                continue
            for sub in ast.walk(stmt):
                if not isinstance(sub, (ast.Assign, ast.AnnAssign)):
                    continue
                targets = sub.targets if isinstance(sub, ast.Assign) \
                    else [sub.target]
                value = sub.value
                if value is None:
                    continue
                is_unbounded = False
                if isinstance(value, ast.List) and not value.elts:
                    is_unbounded = True
                elif isinstance(value, ast.Call):
                    ctor = _dotted(value.func)
                    if ctor in ("list",) and not value.args:
                        is_unbounded = True
                    elif ctor in ("deque", "collections.deque") and \
                            len(value.args) < 2 and \
                            not any(kw.arg == "maxlen"
                                    for kw in value.keywords):
                        is_unbounded = True
                if not is_unbounded:
                    continue
                for t in targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        out.add(t.attr)
        return out

    def _enclosing_has_timeout_discipline(self) -> bool:
        """True when the innermost enclosing function visibly bounds its
        socket IO: a ``settimeout(<non-None constant>)`` / ``settimeout(
        <expr>)`` call, or a ``setsockopt`` naming SO_SNDTIMEO /
        SO_RCVTIMEO. Cached per function node — transport hot paths get
        visited once per call expression."""
        if not self._func_nodes:
            return False
        fnode = self._func_nodes[-1]
        cached = self._timeout_discipline.get(id(fnode))
        if cached is not None:
            return cached
        found = False
        for sub in ast.walk(fnode):
            if not isinstance(sub, ast.Call):
                continue
            if isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr == "settimeout" and sub.args and \
                    not (isinstance(sub.args[0], ast.Constant)
                         and sub.args[0].value is None):
                found = True
                break
            if isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr == "setsockopt":
                names = {_dotted(a) for a in sub.args}
                if any(n.endswith(("SO_SNDTIMEO", "SO_RCVTIMEO"))
                       for n in names):
                    found = True
                    break
        self._timeout_discipline[id(fnode)] = found
        return found

    def _rule_nns109(self, node: ast.ClassDef) -> None:
        declares = False
        for stmt in node.body:
            targets: List[ast.AST] = []
            if isinstance(stmt, ast.Assign):
                targets = stmt.targets
            elif isinstance(stmt, ast.AnnAssign):
                targets = [stmt.target]
            else:
                continue
            value = stmt.value
            if any(isinstance(t, ast.Name) and t.id == "REORDER_SAFE"
                   for t in targets) and \
                    isinstance(value, ast.Constant) and value.value is True:
                declares = True
                break
        if not declares:
            return
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and stmt.name in ("chain", "chain_list"):
                for mut, what in self._self_mutations(stmt):
                    self.emit(
                        "NNS109", mut,
                        f"{node.name} declares REORDER_SAFE but its "
                        f"per-frame {stmt.name}() mutates {what} — lane "
                        f"clones processing frames out of order will "
                        f"diverge from the serial element",
                        hint="drop the REORDER_SAFE flag, move the state "
                             "out of the per-frame path, or justify a "
                             "frame-order-independent mutation with a "
                             "pragma")

    @staticmethod
    def _self_mutations(func: ast.AST):
        """(node, description) for each per-frame ``self`` state mutation
        in a chain body: attribute (re)binds (``self.x = ...``,
        ``self.x += ...``), subscript stores (``self.d[k] = ...``), and
        in-place container calls (``self.acc.append(...)``)."""
        mutators = {"append", "extend", "add", "update", "pop", "clear",
                    "insert", "setdefault", "appendleft", "popleft",
                    "remove", "discard"}

        def _is_self_attr(n: ast.AST) -> bool:
            return (isinstance(n, ast.Attribute)
                    and isinstance(n.value, ast.Name)
                    and n.value.id == "self")

        for sub in ast.walk(func):
            targets: List[ast.AST] = []
            if isinstance(sub, ast.Assign):
                targets = sub.targets
            elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
                targets = [sub.target]
            elif isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr in mutators and \
                    _is_self_attr(sub.func.value):
                yield sub, (f"self.{sub.func.value.attr}"
                            f".{sub.func.attr}(...)")
                continue
            for t in targets:
                if _is_self_attr(t):
                    yield sub, f"self.{t.attr}"
                elif isinstance(t, ast.Subscript) and \
                        _is_self_attr(t.value):
                    yield sub, f"self.{t.value.attr}[...]"

    @staticmethod
    def _touches_buffer_tensors(arg: ast.AST) -> bool:
        """True when the argument expression reads a ``.tensors``
        attribute somewhere (``buf.tensors[0]``, ``info.tensors``...)."""
        return any(isinstance(sub, ast.Attribute) and sub.attr == "tensors"
                   for sub in ast.walk(arg))


def lint_source(text: str, rel: str,
                path: Optional[Path] = None) -> List[Diagnostic]:
    """Lint one Python source string. ``rel`` is the reported source
    label; ``path`` (if given) only feeds the cli.py filename check."""
    path = path or Path(rel)
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [Diagnostic("NNS104", ERROR,
                           Location(rel, e.lineno or 1,
                                    (e.offset or 1)),
                           f"file does not parse: {e.msg}")]
    linter = _FileLinter(path, tree, text, rel)
    linter.visit(tree)
    suppressed, missing_reason = _parse_pragmas(text)
    diags = [d for d in linter.diags
             if d.code not in suppressed.get(d.loc.line, set())]
    for lineno in missing_reason:
        diags.append(Diagnostic(
            "NNS199", ERROR, Location(rel, lineno, 1),
            "nns-lint pragma without a justification",
            hint="append ' -- <reason>' explaining why this line is an "
                 "exception"))
    return diags


def lint_file(path: Path, root: Optional[Path] = None) -> List[Diagnostic]:
    rel = str(path.relative_to(root)) if root else str(path)
    return lint_source(path.read_text(encoding="utf-8"), rel, path)


def lint_tree(root: Path) -> List[Diagnostic]:
    """Lint every ``.py`` file under ``root`` (skipping caches)."""
    diags: List[Diagnostic] = []
    base = root if root.is_dir() else root.parent
    files = [root] if root.is_file() else sorted(root.rglob("*.py"))
    for path in files:
        if "__pycache__" in path.parts:
            continue
        diags.extend(lint_file(path, base.parent))
    return sort_diagnostics(diags)
