"""Whole-program concurrency analysis — the ``NNS2xx`` half of
``nns-lint --concurrency``.

The streaming graph is aggressively threaded (ingest lanes, the EDF
scheduler, the dispatch window, transport workers, the flight recorder)
and now guards its shared state with 35+ locks across 15 modules. Every
concurrency bug so far was found by luck or by a chaos smoke after the
fact; these rules make the lock discipline *checkable*:

- NNS201: **guarded-attribute inference.** For each class, infer which
  attributes the code itself treats as lock-guarded — attributes
  mutated inside ``with self._lock:`` blocks — then flag mutations (and,
  with strong evidence, reads) of a guarded attribute outside the lock.
  A method whose name ends in ``_locked`` is assumed to be called with
  the lock held (the codebase's own convention).
- NNS202: **static lock-ordering graph.** Every nested ``with``
  acquisition (and every call made under a lock to a same-file function
  that acquires locks, propagated to a fixpoint) contributes an edge
  ``outer → inner`` to one project-wide digraph. A cycle in that graph
  is a potential deadlock: two threads taking the same locks in
  opposite orders. The graph is also exported (:func:`static_lock_graph`)
  so the runtime witness (``obs/lockgraph.py``) can cross-check the
  orders it actually observes against the orders the code promises.
- NNS203: **check-then-act races.** ``if k in self.d: ... self.d[k]``
  with no lock held, on an attribute the class mutates under a lock
  elsewhere — the membership test and the mutation are two separate
  critical sections, so another thread can interleave between them.
- NNS204: **foreign calls under lock.** Invoking a callback / hook /
  fn-gauge, or posting to the pipeline bus, while holding a subsystem
  lock: the callee is outside this subsystem's control and may call
  back into it (or block), which is the classic reentrancy-deadlock
  shape. Copy what the callee needs under the lock, call it outside.

Findings are suppressed per line with the same pragma as the NNS1xx
rules (``# nns-lint: disable=NNS202 -- <why>``). NNS199 (reasonless
pragma) stays the AST lint's finding so running both passes never
duplicates it.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

from nnstreamer_tpu_torch.analysis.astlint import _parse_pragmas
from nnstreamer_tpu_torch.analysis.diagnostics import (
    ERROR,
    Diagnostic,
    Location,
    sort_diagnostics,
)

#: constructors whose result IS a lock (kind recorded for RLock
#: reentrancy and for the runtime witness's node metadata)
_LOCK_CTORS = {"threading.Lock": "lock", "threading.RLock": "rlock",
               "threading.Condition": "condition",
               "Lock": "lock", "RLock": "rlock", "Condition": "condition"}
#: constructors whose result is thread-safe by construction — attributes
#: bound to these are exempt from NNS201 (their methods synchronize
#: internally, so "mutations" of them need no class lock)
_SYNC_SAFE_CTORS = {"threading.Event", "threading.Semaphore",
                    "threading.BoundedSemaphore",
                    "threading.Barrier", "threading.local",
                    "queue.Queue", "queue.PriorityQueue",
                    "queue.LifoQueue", "queue.SimpleQueue",
                    "Event", "Semaphore", "local"}
#: registry constructor methods — metric objects carry their own lock
_METRIC_CTOR_ATTRS = {"counter", "gauge", "histogram"}

#: in-place container mutators (same family NNS109 tracks)
_MUTATORS = {"append", "appendleft", "extend", "extendleft", "insert",
             "add", "update", "setdefault", "pop", "popleft", "popitem",
             "remove", "discard", "clear", "sort", "reverse",
             "move_to_end"}
#: dict/container mutators relevant to the check-then-act window
_CTA_MUTATORS = {"pop", "popitem", "update", "setdefault", "clear",
                 "append", "add", "remove", "discard", "insert",
                 "move_to_end"}

#: callback-shaped names: invoking one of these while holding a lock is
#: handing control to code outside the subsystem (NNS204)
_CB_NAME_RE = re.compile(
    r"(?:^|_)(?:cb|cbs|callback|callbacks|hook|hooks|fn|fns|listener|"
    r"listeners|notifier|subscriber|subscribers)$|^on_[a-z0-9_]+$")
#: pipeline-bus entry points — posting re-enters the bus's own lock and
#: wakes arbitrary waiters, so it must happen outside subsystem locks
_BUS_POST_ATTRS = {"post_error", "post_message", "post_warning"}

#: methods whose accesses never count for NNS201: construction/teardown
#: runs before (or after) the object is shared, repr/str are debug
#: surfaces, and lifecycle transitions (start/stop) are phase-separated
#: from steady-state — e.g. a drain loop that owns its state unlocked
#: while running, with stop() joining the thread before touching it
#: (the serving engine), must not have stop()'s defensive locking read
#: as "this attribute is lock-guarded". NNS202/NNS204 still see these
#: methods — a lock-order cycle in stop() is a real deadlock.
_EXEMPT_METHODS = {"__init__", "__new__", "__del__", "__repr__",
                   "__str__", "__enter__", "__exit__",
                   "start", "stop", "close", "shutdown"}

#: the assumed-guard token for ``*_locked`` helper methods: satisfies
#: "some lock is held" for any of the class's locks
_ASSUMED = ("assumed",)

LockId = Tuple[str, ...]


def _dotted(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_self_attr(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self")


def lock_display(lock: LockId) -> str:
    """Stable human/JSON name for a lock node."""
    if lock[0] == "attr":
        return f"{lock[1]}:{lock[2]}.{lock[3]}"
    if lock[0] == "mod":
        return f"{lock[1]}:{lock[2]}"
    if lock[0] == "local":
        return f"{lock[1]}:{lock[2]}:{lock[3]}"
    return "<assumed>"


class _Access:
    """One touch of ``self.<attr>``: where, how, and under what locks."""

    __slots__ = ("kind", "method", "node", "held", "in_nested")

    def __init__(self, kind: str, method: str, node: ast.AST,
                 held: frozenset, in_nested: bool):
        self.kind = kind              # "read" | "write"
        self.method = method
        self.node = node
        self.held = held
        self.in_nested = in_nested


class _ClassFacts:
    def __init__(self, rel: str, node: ast.ClassDef):
        self.rel = rel
        self.node = node
        self.name = node.name
        self.lock_attrs: Dict[str, str] = {}       # attr -> kind
        self.sync_safe_attrs: Set[str] = set()
        self.accesses: Dict[str, List[_Access]] = {}
        self.methods: Dict[str, ast.AST] = {}


class _FuncFacts:
    def __init__(self, key: Tuple, node: ast.AST):
        self.key = key                # ("meth", class, name) | ("func", name)
        self.node = node
        self.acquires: Set[LockId] = set()
        #: calls to same-file callables: (callee key, held set, node)
        self.calls: List[Tuple[Tuple, frozenset, ast.AST]] = []


def _modkey(rel: str) -> str:
    """Dotted module name for a repo-relative path — the cross-file
    identity of module-level locks (``from mod import THE_LOCK`` must
    resolve to the same graph node as the defining module's uses)."""
    key = rel[:-3] if rel.endswith(".py") else rel
    key = key.replace("/", ".").replace("\\", ".")
    return key[:-9] if key.endswith(".__init__") else key


class _FileModel:
    """Per-file facts feeding the whole-program passes."""

    def __init__(self, rel: str, tree: ast.Module, text: str):
        self.rel = rel
        self.modkey = _modkey(rel)
        self.tree = tree
        self.text = text
        self.classes: Dict[str, _ClassFacts] = {}
        self.module_locks: Dict[str, str] = {}     # name -> kind
        self.imports: Dict[str, str] = {}          # bound name -> module
        #: ``from mod import name [as alias]``: alias -> (module, name)
        self.from_imports: Dict[str, Tuple[str, str]] = {}
        self.funcs: Dict[Tuple, _FuncFacts] = {}
        #: lock creation sites: "rel:line" -> LockId (for the runtime
        #: witness's site → symbolic-name mapping)
        self.lock_sites: Dict[str, LockId] = {}
        #: acquisition-order edges: (outer, inner) -> "rel:line"
        self.edges: Dict[Tuple[LockId, LockId], str] = {}
        #: NNS203 candidates: (test node, mutation node, class, attr)
        self.check_then_act: List[Tuple[ast.AST, ast.AST, str, str]] = []
        #: NNS204 candidates: (call node, description, lock)
        self.foreign_calls: List[Tuple[ast.AST, str, LockId]] = []


def _lock_ctor_kind(value: ast.AST) -> Optional[str]:
    if isinstance(value, ast.Call):
        return _LOCK_CTORS.get(_dotted(value.func))
    return None


def _sync_safe_ctor(value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    d = _dotted(value.func)
    if d in _SYNC_SAFE_CTORS:
        return True
    return (isinstance(value.func, ast.Attribute)
            and value.func.attr in _METRIC_CTOR_ATTRS)


def _collect_class_decls(cf: _ClassFacts) -> None:
    """First pass over a class: which attrs are locks, which are
    thread-safe by construction."""
    for sub in ast.walk(cf.node):
        if not isinstance(sub, ast.Assign):
            continue
        kind = _lock_ctor_kind(sub.value)
        safe = _sync_safe_ctor(sub.value)
        if kind is None and not safe:
            continue
        for t in sub.targets:
            if _is_self_attr(t):
                if kind is not None:
                    cf.lock_attrs[t.attr] = kind
                else:
                    cf.sync_safe_attrs.add(t.attr)


class _FuncWalker:
    """Walks one function body tracking the held-lock context, recording
    attribute accesses, acquisition edges, same-file calls, NNS203/204
    candidates."""

    def __init__(self, model: _FileModel, cf: Optional[_ClassFacts],
                 method: str, ff: _FuncFacts, assumed_locked: bool):
        self.model = model
        self.cf = cf
        self.method = method
        self.ff = ff
        self.held: List[LockId] = [_ASSUMED] if assumed_locked else []
        self.nesting = 0              # inside a nested def/lambda
        #: local aliases: name -> LockId (wlock = self._wlocks[...])
        self.aliases: Dict[str, LockId] = {}

    # -- lock identification -------------------------------------------------
    def _lock_of(self, expr: ast.AST) -> Optional[LockId]:
        if isinstance(expr, ast.Call):
            expr = expr.func            # with self._lock.something(): — no
        if _is_self_attr(expr) and self.cf is not None:
            attr = expr.attr
            if attr in self.cf.lock_attrs or "lock" in attr.lower():
                self.cf.lock_attrs.setdefault(attr, "lock")
                return ("attr", self.model.rel, self.cf.name, attr)
        if isinstance(expr, ast.Name):
            name = expr.id
            if name in self.aliases:
                return self.aliases[name]
            if name in self.model.module_locks:
                return ("mod", self.model.modkey, name)
            if name in self.model.from_imports and "lock" in name.lower():
                mod, orig = self.model.from_imports[name]
                return ("mod", mod, orig)
            if "lock" in name.lower():
                return ("local", self.model.rel, self.method, name)
        if isinstance(expr, ast.Attribute):
            d = _dotted(expr)
            if d and "lock" in expr.attr.lower():
                base = d.split(".", 1)[0]
                if base in self.model.imports:
                    # mod.THE_LOCK through a plain `import mod`
                    return ("mod", self.model.imports[base], expr.attr)
                # CLS._SERVERS_LOCK and friends: class-level named
                # locks, keyed by bare name (matches the creation site)
                return ("mod", self.model.modkey, expr.attr)
        return None

    def _alias_target(self, value: ast.AST) -> Optional[LockId]:
        """``wlock = self._wlocks.setdefault(conn, Lock())`` /
        ``wlock = self._wlocks[sock]`` — a per-key lock drawn from a
        self container; keyed as ``Class.<attr>[]``."""
        if self.cf is None:
            return None
        for sub in ast.walk(value):
            if _is_self_attr(sub) and "lock" in sub.attr.lower():
                return ("attr", self.model.rel, self.cf.name,
                        sub.attr + "[]")
        return None

    # -- recording -----------------------------------------------------------
    def _held_set(self) -> frozenset:
        return frozenset(self.held)

    def _record_access(self, attr: str, kind: str, node: ast.AST) -> None:
        cf = self.cf
        if cf is None:
            return
        if attr in cf.lock_attrs or attr in cf.sync_safe_attrs:
            return
        cf.accesses.setdefault(attr, []).append(_Access(
            kind, self.method, node, self._held_set(),
            self.nesting > 0))

    def _record_acquire(self, lock: LockId, node: ast.AST) -> None:
        self.ff.acquires.add(lock)
        site = f"{self.model.rel}:{getattr(node, 'lineno', 1)}"
        for outer in self.held:
            if outer == _ASSUMED:
                continue
            # outer == lock IS recorded: a non-reentrant self-nest is
            # the most immediate deadlock there is (NNS202 exempts
            # RLock self-loops by kind)
            self.model.edges.setdefault((outer, lock), site)

    # -- traversal -----------------------------------------------------------
    def walk_body(self, body: Iterable[ast.AST]) -> None:
        for stmt in body:
            self.visit(stmt)

    def visit(self, node: ast.AST) -> None:
        meth = getattr(self, f"_visit_{type(node).__name__}", None)
        if meth is not None:
            meth(node)
            return
        for child in ast.iter_child_nodes(node):
            self.visit(child)

    def _visit_With(self, node: ast.With) -> None:
        acquired: List[LockId] = []
        for item in node.items:
            self.visit(item.context_expr)
            lock = self._lock_of(item.context_expr)
            if lock is not None:
                self._record_acquire(lock, item.context_expr)
                self.held.append(lock)
                acquired.append(lock)
        self.walk_body(node.body)
        for _ in acquired:
            self.held.pop()

    _visit_AsyncWith = _visit_With  # type: ignore[assignment]

    def _visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # a nested def runs later, on whatever thread calls it — its
        # body is NOT under the enclosing with; record accesses with an
        # empty held set and the in_nested marker
        saved_held, saved_nesting = self.held, self.nesting
        self.held, self.nesting = [], saved_nesting + 1
        self.walk_body(node.body)
        self.held, self.nesting = saved_held, saved_nesting

    _visit_AsyncFunctionDef = _visit_FunctionDef  # type: ignore[assignment]

    def _visit_Lambda(self, node: ast.Lambda) -> None:
        saved_held, saved_nesting = self.held, self.nesting
        self.held, self.nesting = [], saved_nesting + 1
        self.visit(node.body)
        self.held, self.nesting = saved_held, saved_nesting

    def _visit_Assign(self, node: ast.Assign) -> None:
        self.visit(node.value)
        for t in node.targets:
            self._visit_store_target(t)
        # local lock aliases for later `with wlock:` blocks
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            alias = self._alias_target(node.value)
            if alias is not None:
                self.aliases[node.targets[0].id] = alias

    def _visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.visit(node.value)
        self._visit_store_target(node.target, aug=True)

    def _visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self.visit(node.value)
            self._visit_store_target(node.target)

    def _visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            if _is_self_attr(t):
                self._record_access(t.attr, "write", t)
            elif isinstance(t, ast.Subscript) and _is_self_attr(t.value):
                self._record_access(t.value.attr, "write", t)
                self.visit(t.slice)

    def _visit_store_target(self, t: ast.AST, aug: bool = False) -> None:
        if _is_self_attr(t):
            self._record_access(t.attr, "write", t)
        elif isinstance(t, ast.Subscript):
            if _is_self_attr(t.value):
                self._record_access(t.value.attr, "write", t)
            else:
                self.visit(t.value)
            self.visit(t.slice)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._visit_store_target(e)

    def _visit_Attribute(self, node: ast.Attribute) -> None:
        if _is_self_attr(node) and isinstance(node.ctx, ast.Load):
            self._record_access(node.attr, "read", node)
        else:
            self.visit(node.value)

    def _visit_Call(self, node: ast.Call) -> None:
        func = node.func
        # self.X.append(...) — in-place mutation of self.X
        if isinstance(func, ast.Attribute) and \
                func.attr in _MUTATORS and _is_self_attr(func.value):
            self._record_access(func.value.attr, "write", node)
        else:
            self.visit(func)
        for a in node.args:
            self.visit(a)
        for kw in node.keywords:
            self.visit(kw.value)
        self._note_call(node)
        self._check_foreign_call(node)

    def _note_call(self, node: ast.Call) -> None:
        """Same-file callee resolution for the interprocedural
        lock-acquisition closure (NNS202)."""
        func = node.func
        callee: Optional[Tuple] = None
        if _is_self_attr(func) and self.cf is not None:
            callee = ("meth", self.cf.name, func.attr)
        elif isinstance(func, ast.Name):
            callee = ("func", func.id)
        if callee is not None:
            self.ff.calls.append((callee, self._held_set(), node))

    def _check_foreign_call(self, node: ast.Call) -> None:
        held = [h for h in self.held if h != _ASSUMED]
        if not held:
            return
        func = node.func
        what: Optional[str] = None
        if isinstance(func, ast.Name) and _CB_NAME_RE.search(func.id):
            what = f"{func.id}(...)"
        elif isinstance(func, ast.Attribute):
            if func.attr in _BUS_POST_ATTRS:
                what = f".{func.attr}(...) (pipeline bus)"
            elif _is_self_attr(func) and _CB_NAME_RE.search(func.attr):
                what = f"self.{func.attr}(...)"
            elif _is_self_attr(func.value) and \
                    _CB_NAME_RE.search(func.value.attr) and \
                    func.attr not in _MUTATORS and \
                    func.attr not in ("copy", "index", "count", "get",
                                      "keys", "values", "items"):
                # maintaining the callback registry (append/remove/copy)
                # under the lock is correct practice — only *invoking* a
                # member hands control outside the subsystem
                what = f"self.{func.value.attr}.{func.attr}(...)"
        if what is not None:
            self.model.foreign_calls.append((node, what, held[-1]))

    def _visit_If(self, node: ast.If) -> None:
        self._check_then_act(node)
        self.visit(node.test)
        self.walk_body(node.body)
        self.walk_body(node.orelse)

    def _check_then_act(self, node: ast.If) -> None:
        """``if k in self.d:`` (no lock) followed in either branch by an
        unguarded mutation of ``self.d`` — recorded as a candidate; the
        whole-program pass keeps it only when the class mutates the attr
        under a lock elsewhere."""
        if self.cf is None or self.held:
            return
        test = node.test
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            test = test.operand
        if not (isinstance(test, ast.Compare) and len(test.ops) == 1
                and isinstance(test.ops[0], (ast.In, ast.NotIn))
                and _is_self_attr(test.comparators[0])):
            return
        attr = test.comparators[0].attr
        if attr in self.cf.lock_attrs or attr in self.cf.sync_safe_attrs:
            return
        for stmt in (*node.body, *node.orelse):
            mut = self._find_unguarded_mutation(stmt, attr)
            if mut is not None:
                self.model.check_then_act.append(
                    (node, mut, self.cf.name, attr))
                return

    def _find_unguarded_mutation(self, stmt: ast.AST,
                                 attr: str) -> Optional[ast.AST]:
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.With):
                return None     # branch re-locks before mutating: fine
            if isinstance(sub, ast.Assign):
                for t in sub.targets:
                    if isinstance(t, ast.Subscript) and \
                            _is_self_attr(t.value) and \
                            t.value.attr == attr:
                        return sub
            elif isinstance(sub, ast.Delete):
                for t in sub.targets:
                    if isinstance(t, ast.Subscript) and \
                            _is_self_attr(t.value) and \
                            t.value.attr == attr:
                        return sub
            elif isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr in _CTA_MUTATORS and \
                    _is_self_attr(sub.func.value) and \
                    sub.func.value.attr == attr:
                return sub
        return None


def _analyze_file(rel: str, text: str) -> Optional[_FileModel]:
    try:
        tree = ast.parse(text)
    except SyntaxError:
        return None         # the AST lint already reports unparseable files
    model = _FileModel(rel, tree, text)

    # imports (cross-file identity of module locks) + module-level
    # locks and their creation sites
    for stmt in tree.body:
        if isinstance(stmt, ast.Import):
            for alias in stmt.names:
                bound = alias.asname or alias.name.split(".")[0]
                model.imports[bound] = alias.name if alias.asname \
                    else alias.name.split(".")[0]
        elif isinstance(stmt, ast.ImportFrom):
            parts = model.modkey.split(".")
            if stmt.level > 0:
                base = parts[:len(parts) - stmt.level]
                mod = ".".join(base + ([stmt.module] if stmt.module
                                       else []))
            else:
                mod = stmt.module or ""
            for alias in stmt.names:
                model.from_imports[alias.asname or alias.name] = \
                    (mod, alias.name)
        elif isinstance(stmt, ast.Assign):
            kind = _lock_ctor_kind(stmt.value)
            if kind is not None:
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        model.module_locks[t.id] = kind
                        model.lock_sites[f"{rel}:{stmt.value.lineno}"] = \
                            ("mod", model.modkey, t.id)

    # classes: decls first (lock attrs usable from any method)
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            cf = _ClassFacts(rel, node)
            _collect_class_decls(cf)
            model.classes[node.name] = cf
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign):
                    kind = _lock_ctor_kind(sub.value)
                    if kind is None:
                        continue
                    for t in sub.targets:
                        if _is_self_attr(t):
                            model.lock_sites[
                                f"{rel}:{sub.value.lineno}"] = \
                                ("attr", rel, node.name, t.attr)
                        elif isinstance(t, ast.Name):
                            # class-level lock (shared across instances)
                            model.lock_sites[
                                f"{rel}:{sub.value.lineno}"] = \
                                ("mod", model.modkey, t.id)
                            model.module_locks.setdefault(t.id, kind)

    # walk every function with held-lock context
    def walk_func(fnode: ast.AST, cf: Optional[_ClassFacts],
                  key: Tuple) -> None:
        ff = _FuncFacts(key, fnode)
        model.funcs[key] = ff
        assumed = cf is not None and fnode.name.endswith("_locked")
        w = _FuncWalker(model, cf, fnode.name, ff, assumed)
        w.walk_body(fnode.body)

    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            walk_func(stmt, None, ("func", stmt.name))
    for cname, cf in model.classes.items():
        for stmt in cf.node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cf.methods[stmt.name] = stmt
                walk_func(stmt, cf, ("meth", cname, stmt.name))
    return model


# -- whole-program passes ----------------------------------------------------

def _propagate_acquires(model: _FileModel) -> Dict[Tuple, Set[LockId]]:
    """May-acquire closure per function over same-file calls (fixpoint),
    then fold call-under-lock edges into the model's edge set."""
    may: Dict[Tuple, Set[LockId]] = {
        k: set(f.acquires) for k, f in model.funcs.items()}
    changed = True
    while changed:
        changed = False
        for key, ff in model.funcs.items():
            for callee, _held, _node in ff.calls:
                target = may.get(callee)
                if target and not target <= may[key]:
                    may[key] |= target
                    changed = True
    for ff in model.funcs.values():
        for callee, held, node in ff.calls:
            target = may.get(callee)
            if not target or not held:
                continue
            site = f"{model.rel}:{getattr(node, 'lineno', 1)}"
            for outer in held:
                if outer == _ASSUMED:
                    continue
                for inner in target:
                    if inner != outer:
                        model.edges.setdefault((outer, inner), site)
    return may


def _held_on_entry(model: _FileModel, cname: str) -> Set[str]:
    """Methods that run with the class lock already held: the
    ``*_locked`` naming convention, plus any method whose EVERY
    same-file call site holds a lock (or sits inside another
    held-on-entry method) — private helpers factored out of critical
    sections. One externally-reachable or unlocked call site
    disqualifies; call sites in ``__init__``-style methods are neutral
    (construction is single-threaded)."""
    call_sites: Dict[str, List[Tuple[Tuple, frozenset]]] = {}
    for key, ff in model.funcs.items():
        for callee, held, _node in ff.calls:
            if callee[0] == "meth" and callee[1] == cname:
                call_sites.setdefault(callee[2], []).append((key, held))
    assumed = {name for name in model.classes[cname].methods
               if name.endswith("_locked")}
    changed = True
    while changed:
        changed = False
        for meth, sites in call_sites.items():
            if meth in assumed or meth in _EXEMPT_METHODS:
                continue
            countable = [
                (k, h) for (k, h) in sites
                if not (k[0] == "meth" and k[1] == cname
                        and k[2] in _EXEMPT_METHODS)]
            if countable and all(
                    h or (k[0] == "meth" and k[1] == cname
                          and k[2] in assumed)
                    for k, h in countable):
                assumed.add(meth)
                changed = True
    return assumed


def _nns201(model: _FileModel, diags: List[Diagnostic]) -> None:
    for cf in model.classes.values():
        if not cf.lock_attrs:
            continue
        assumed = _held_on_entry(model, cf.name)
        for attr, accesses in cf.accesses.items():
            flaggable = [a for a in accesses
                         if a.method not in _EXEMPT_METHODS]
            locked = [a for a in flaggable
                      if a.held or a.method in assumed]
            unlocked = [a for a in flaggable
                        if not a.held and a.method not in assumed]
            locked_writes = [a for a in locked if a.kind == "write"]
            if not locked_writes or not unlocked:
                continue
            # dominant guard: the lock named in most locked accesses
            # (reported so the fix is obvious)
            counts: Dict[LockId, int] = {}
            for a in locked:
                for lk in a.held:
                    if lk != _ASSUMED:
                        counts[lk] = counts.get(lk, 0) + 1
            guard = max(counts, key=counts.get) if counts else None
            guard_name = lock_display(guard) if guard else "its lock"
            for a in unlocked:
                if a.kind == "write":
                    diags.append(Diagnostic(
                        "NNS201", ERROR,
                        Location(model.rel, a.node.lineno,
                                 a.node.col_offset + 1),
                        f"{cf.name}.{a.method}() mutates self.{attr} "
                        f"outside the lock — the class guards this "
                        f"attribute with {guard_name} everywhere else, "
                        f"so this write races every locked reader/"
                        f"writer",
                        hint="take the lock around the mutation, or "
                             "justify a single-threaded phase with a "
                             "pragma"))
            # reads: flagged only on strong evidence that the class
            # treats reads as needing the lock too — every OTHER access
            # is locked (reads included) and there are enough of them
            # to call it a discipline rather than a coincidence
            unlocked_reads = [a for a in unlocked if a.kind == "read"]
            locked_reads = [a for a in locked if a.kind == "read"]
            if unlocked_reads and not [a for a in unlocked
                                       if a.kind == "write"] and \
                    locked_reads and len(locked) >= 3 and \
                    len(unlocked_reads) <= 2:
                for a in unlocked_reads:
                    diags.append(Diagnostic(
                        "NNS201", ERROR,
                        Location(model.rel, a.node.lineno,
                                 a.node.col_offset + 1),
                        f"{cf.name}.{a.method}() reads self.{attr} "
                        f"outside the lock — every other access in "
                        f"this class (reads included) holds "
                        f"{guard_name}, so this read can observe a "
                        f"torn/stale value",
                        hint="copy the value under the lock, or "
                             "justify a racy read (e.g. a monotonic "
                             "flag) with a pragma"))


def _nns203(model: _FileModel, diags: List[Diagnostic]) -> None:
    for test, mut, cname, attr in model.check_then_act:
        cf = model.classes[cname]
        accesses = cf.accesses.get(attr, ())
        if not any(a.kind == "write" and a.held for a in accesses):
            continue    # no evidence the attr is shared lock-guarded state
        diags.append(Diagnostic(
            "NNS203", ERROR,
            Location(model.rel, test.lineno, test.col_offset + 1),
            f"check-then-act race on self.{attr}: the membership test "
            f"(line {test.lineno}) and the mutation (line "
            f"{mut.lineno}) are separate critical sections — "
            f"{cname} mutates self.{attr} under a lock elsewhere, so "
            f"another thread can interleave between test and act",
            hint="hold the lock across the test AND the mutation, or "
                 "use an atomic form (setdefault/pop(k, None)), or "
                 "justify single-threaded use with a pragma"))


def _nns204(model: _FileModel, diags: List[Diagnostic]) -> None:
    for node, what, lock in model.foreign_calls:
        diags.append(Diagnostic(
            "NNS204", ERROR,
            Location(model.rel, node.lineno, node.col_offset + 1),
            f"foreign call {what} while holding "
            f"{lock_display(lock)} — the callee is outside this "
            f"subsystem's control and may block or re-enter the lock "
            f"(reentrancy-deadlock shape)",
            hint="copy what the callee needs under the lock, invoke it "
                 "after release, or justify a known-leaf callee with a "
                 "pragma"))


def _find_cycles(edges: Dict[Tuple[LockId, LockId], str],
                 lock_kinds: Dict[LockId, str]
                 ) -> List[Tuple[List[LockId], List[str]]]:
    """Strongly connected components of the acquisition-order digraph;
    each SCC with >1 lock (or a non-reentrant self-loop) is a potential
    deadlock. Returns (cycle locks, example edge sites)."""
    adj: Dict[LockId, Set[LockId]] = {}
    for (a, b) in edges:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set())

    index: Dict[LockId, int] = {}
    low: Dict[LockId, int] = {}
    on_stack: Set[LockId] = set()
    stack: List[LockId] = []
    sccs: List[List[LockId]] = []
    counter = [0]

    def strongconnect(v: LockId) -> None:
        # iterative Tarjan — analysis inputs are user code, recursion
        # depth must not depend on their lock count
        work = [(v, iter(sorted(adj[v])))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(adj[w]))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                sccs.append(scc)

    for v in sorted(adj):
        if v not in index:
            strongconnect(v)

    out: List[Tuple[List[LockId], List[str]]] = []
    for scc in sccs:
        members = set(scc)
        if len(scc) > 1:
            sites = sorted({site for (a, b), site in edges.items()
                            if a in members and b in members})
            out.append((sorted(scc), sites))
    # non-reentrant self-loops (with self._lock: ... with self._lock:)
    for (a, b), site in sorted(edges.items(), key=lambda kv: kv[1]):
        if a == b and lock_kinds.get(a, "lock") != "rlock":
            out.append(([a], [site]))
    return out


def _site_loc(site: str) -> Location:
    rel, _, line = site.rpartition(":")
    return Location(rel, int(line) if line.isdigit() else 1, 1)


def _nns202(models: List[_FileModel], diags: List[Diagnostic]) -> None:
    edges: Dict[Tuple[LockId, LockId], str] = {}
    kinds: Dict[LockId, str] = {}
    for m in models:
        for key, site in m.edges.items():
            edges.setdefault(key, site)
        for site, lock in m.lock_sites.items():
            if lock[0] == "mod":
                kinds[lock] = m.module_locks.get(lock[2], "lock")
        for cf in m.classes.values():
            for attr, kind in cf.lock_attrs.items():
                kinds[("attr", m.rel, cf.name, attr)] = kind
    for cycle, sites in _find_cycles(edges, kinds):
        names = " -> ".join(lock_display(c) for c in cycle)
        if len(cycle) == 1:
            msg = (f"non-reentrant lock {lock_display(cycle[0])} "
                   f"acquired while already held — this path "
                   f"self-deadlocks the moment it runs")
        else:
            msg = (f"lock-order cycle: {names} — two threads taking "
                   f"these locks in opposite orders deadlock; "
                   f"acquisition sites: {', '.join(sites[:4])}")
        diags.append(Diagnostic(
            "NNS202", ERROR, _site_loc(sites[0]), msg,
            hint="pick ONE global order for these locks and make every "
                 "path acquire in that order (or collapse them into "
                 "one lock); justify a phase-separated exception with "
                 "a pragma"))


# -- public API --------------------------------------------------------------

def _iter_sources(root: Path) -> List[Tuple[str, str, Path]]:
    base = root if root.is_dir() else root.parent
    files = [root] if root.is_file() else sorted(root.rglob("*.py"))
    out = []
    for path in files:
        if "__pycache__" in path.parts:
            continue
        rel = str(path.relative_to(base.parent))
        out.append((rel, path.read_text(encoding="utf-8"), path))
    return out


def lint_concurrency_sources(sources: Dict[str, str]) -> List[Diagnostic]:
    """Run the NNS2xx pass over in-memory sources (``rel -> text``).
    The whole-program passes (NNS202's graph, NNS201's class facts) see
    exactly the given set of files — the test-fixture entry point."""
    models: List[_FileModel] = []
    for rel, text in sorted(sources.items()):
        m = _analyze_file(rel, text)
        if m is not None:
            models.append(m)
    diags: List[Diagnostic] = []
    for m in models:
        _propagate_acquires(m)
    for m in models:
        _nns201(m, diags)
        _nns203(m, diags)
        _nns204(m, diags)
    _nns202(models, diags)
    # per-file pragma suppression (reasonless pragmas stay NNS199,
    # emitted by the AST lint so the two passes never double-report)
    suppressed: Dict[str, Dict[int, Set[str]]] = {}
    for rel, text in sources.items():
        suppressed[rel], _ = _parse_pragmas(text)
    out = [d for d in diags
           if d.code not in suppressed.get(d.loc.source, {})
           .get(d.loc.line, set())]
    return sort_diagnostics(out)


def lint_concurrency_source(text: str, rel: str = "x.py"
                            ) -> List[Diagnostic]:
    """Single-source convenience wrapper (fixtures, docs examples)."""
    return lint_concurrency_sources({rel: text})


def lint_concurrency(root: Path) -> List[Diagnostic]:
    """Run the whole-program concurrency pass over every ``.py`` file
    under ``root`` (a package dir or a single file)."""
    return lint_concurrency_sources(
        {rel: text for rel, text, _ in _iter_sources(root)})


def static_lock_graph(root: Path) -> dict:
    """The NNS202 acquisition-order graph as JSON-able data: nodes,
    edges (with the acquisition site), and the lock creation-site map
    the runtime witness (``obs/lockgraph.py``) uses to translate its
    observed ``file:line`` lock identities into these symbolic names."""
    models: List[_FileModel] = []
    for rel, text, _ in _iter_sources(root):
        m = _analyze_file(rel, text)
        if m is not None:
            models.append(m)
    for m in models:
        _propagate_acquires(m)
    nodes: Set[str] = set()
    edges: List[dict] = []
    sites: Dict[str, str] = {}
    seen: Set[Tuple[str, str]] = set()
    for m in models:
        for (a, b), site in sorted(m.edges.items(), key=lambda kv: kv[1]):
            da, db = lock_display(a), lock_display(b)
            nodes.add(da)
            nodes.add(db)
            if (da, db) not in seen:
                seen.add((da, db))
                edges.append({"from": da, "to": db, "site": site})
        for site, lock in m.lock_sites.items():
            sites[site] = lock_display(lock)
            nodes.add(lock_display(lock))
    return {"version": 1, "nodes": sorted(nodes),
            "edges": sorted(edges, key=lambda e: (e["from"], e["to"])),
            "sites": sites}
