"""Static pipeline verifier — graph checks without running a buffer.

The port of the JAX package's verifier: the same checks and codes, read
off the port's registry and caps (``analysis/catalog.py``). A property
the JAX package has and the port does not yet is an NNS002 error whose
message names its ROADMAP.md item.

Given an ``nns-launch`` description this builds the link graph from
``pipeline.parse.parse_description`` (pure syntax, no element
construction), consults the static element catalog, and reports
``NNS0xx`` diagnostics: unknown factories/properties (NNS001/002),
duplicate names (NNS003), bad references and pad exhaustion (NNS004),
empty caps intersections (NNS005, computed with ``pipeline/caps.py`` —
the same intersection engine runtime negotiation uses), dangling pads
(NNS006), cycles (NNS007), mux/merge sync-policy conflicts (NNS008), tee
fan-out without queues (NNS009), unmonitorable leaky queues (NNS010),
unknown filter/decoder/converter subplugins (NNS011), and syntax errors
(NNS012).

The same checks that make sense on an already-instantiated graph are
exposed as :func:`verify_pipeline` (behind ``Pipeline.verify()``), so
pipelines built in code get the pre-flight too.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from nnstreamer_tpu_torch.analysis.catalog import (
    PASSTHROUGH,
    ElementSpec,
    spec_for,
    static_src_caps,
)
from nnstreamer_tpu_torch.analysis.diagnostics import (
    ERROR,
    WARNING,
    Diagnostic,
    Location,
    sort_diagnostics,
)
from nnstreamer_tpu_torch.pipeline.caps import Caps
from nnstreamer_tpu_torch.registry import (
    CONVERTER,
    DECODER,
    FILTER,
    registered_names,
)

def _unported(klass: type) -> Dict[str, str]:
    """The JAX package's properties an element class does not have yet,
    each with the ROADMAP.md item that brings it."""
    out: Dict[str, str] = {}
    for k in reversed(klass.__mro__):
        out.update(getattr(k, "UNPORTED_PROPERTIES", {}))
    return out


#: sync policies accepted by elements/collect.py (kept in sync by tests)
_SYNC_POLICIES = ("nosync", "slowest", "basepad", "refresh")


@dataclasses.dataclass
class _Node:
    """One concrete element occurrence in the description."""

    id: int
    factory: str
    spec: Optional[ElementSpec]
    props: Dict[str, str]               # normalized key -> last value
    prop_positions: List[Tuple[str, str, int]]
    pos: int                            # column of the factory token
    name: Optional[str]                 # explicit name= only
    caps_str: Optional[str] = None      # capsfilter caps token
    out_links: List[int] = dataclasses.field(default_factory=list)
    in_links: List[int] = dataclasses.field(default_factory=list)
    src_used: int = 0
    sink_used: int = 0
    sink_grown: int = 0                 # highest implied sink index + 1

    @property
    def label(self) -> str:
        return self.name or self.factory


def _line_col(text: str, pos: int) -> Tuple[int, int]:
    """0-based absolute offset → 1-based (line, column)."""
    pos = max(0, min(pos, len(text)))
    line = text.count("\n", 0, pos) + 1
    col = pos - (text.rfind("\n", 0, pos) + 1) + 1
    return line, col


class _Verifier:
    def __init__(self, description: str, source: str):
        self.description = description
        self.source = source
        self.diags: List[Diagnostic] = []

    # -- diagnostics ---------------------------------------------------------
    def _loc(self, pos: int) -> Location:
        line, col = _line_col(self.description, pos)
        return Location(self.source, line, col)

    def emit(self, code: str, severity: str, pos: int, message: str,
             hint: Optional[str] = None) -> None:
        self.diags.append(Diagnostic(code, severity, self._loc(pos),
                                     message, hint))

    # -- main ----------------------------------------------------------------
    def run(self) -> List[Diagnostic]:
        from nnstreamer_tpu_torch.pipeline.parse import ParseError, \
            parse_description

        try:
            chains = parse_description(self.description)
        except ParseError as e:
            self.emit("NNS012", ERROR, e.pos or 0, str(e))
            return self.diags
        nodes = self._build_nodes(chains)
        self._check_props(nodes)
        self._check_links(chains, nodes)
        self._check_graph(nodes)
        self._propagate_caps(nodes)
        return sort_diagnostics(self.diags)

    # -- node construction ---------------------------------------------------
    def _build_nodes(self, chains) -> Dict[int, _Node]:
        nodes: Dict[int, _Node] = {}
        self.by_name: Dict[str, _Node] = {}
        self.node_of = {}  # id(LaunchNode) -> _Node for el/caps ast nodes
        for chain in chains:
            for ast in chain:
                if ast.kind in ("ref", "refpad"):
                    continue
                if "=" in (ast.factory or "") and ast.kind == "element":
                    self.emit("NNS012", ERROR, ast.pos,
                              f"property token {ast.factory!r} has no "
                              f"element to apply to")
                    continue
                spec = spec_for(ast.factory)
                if spec is None:
                    self.emit("NNS001", ERROR, ast.pos,
                              f"no such element factory {ast.factory!r}",
                              hint=self._suggest_factory(ast.factory))
                props: Dict[str, str] = {}
                for k, v, _ in ast.props:
                    props[k.replace("-", "_")] = v
                node = _Node(id=len(nodes), factory=ast.factory, spec=spec,
                             props=props, prop_positions=list(ast.props),
                             pos=ast.pos, name=ast.name, caps_str=ast.caps)
                nodes[node.id] = node
                self.node_of[id(ast)] = node
                if node.name is not None:
                    if node.name in self.by_name:
                        self.emit("NNS003", ERROR, ast.pos,
                                  f"duplicate element name {node.name!r}")
                    else:
                        self.by_name[node.name] = node
        return nodes

    @staticmethod
    def _suggest_factory(factory: str) -> Optional[str]:
        import difflib

        from nnstreamer_tpu_torch.registry import ELEMENT

        close = difflib.get_close_matches(
            factory, registered_names(ELEMENT), n=1)
        return f"did you mean {close[0]!r}?" if close else None

    # -- property checks -----------------------------------------------------
    def _check_props(self, nodes: Dict[int, _Node]) -> None:
        filter_names = set(registered_names(FILTER)) | {"auto"}
        decoder_names = set(registered_names(DECODER))
        converter_names = set(registered_names(CONVERTER))
        for node in nodes.values():
            spec = node.spec
            if spec is not None:
                for k, _v, pos in node.prop_positions:
                    key = k.replace("-", "_")
                    if key in spec.properties:
                        continue
                    item = _unported(spec.klass).get(key)
                    if item is not None:
                        # the JAX package's property: NNS002 all the same,
                        # since the port raises at construction
                        self.emit(
                            "NNS002", ERROR, pos,
                            f"{node.factory} property {k!r} is not ported "
                            f"to nnstreamer_tpu_torch yet (ROADMAP.md, "
                            f"{item})")
                        continue
                    self.emit(
                        "NNS002", ERROR, pos,
                        f"{node.factory} has no property {k!r}",
                        hint=f"known properties: "
                             f"{', '.join(sorted(spec.properties))}")
            p = node.props
            if node.factory == "tensor_filter":
                fw = p.get("framework", "auto")
                if fw not in filter_names:
                    self.emit(
                        "NNS011", ERROR, node.pos,
                        f"tensor_filter {node.label!r}: unknown framework "
                        f"{fw!r}",
                        hint=f"registered frameworks: "
                             f"{', '.join(sorted(filter_names))} (external "
                             f"subplugins load from NNSTREAMER_TPU_FILTER_"
                             f"PATH)")
            if node.factory == "tensor_decoder":
                mode = p.get("mode")
                if mode is not None and mode not in decoder_names:
                    self.emit(
                        "NNS011", ERROR, node.pos,
                        f"tensor_decoder {node.label!r}: unknown decoder "
                        f"mode {mode!r}",
                        hint=f"registered decoders: "
                             f"{', '.join(sorted(decoder_names))}")
            if node.factory == "tensor_converter":
                mode = p.get("mode")
                if mode:
                    sub = mode.split(":", 1)[1] if ":" in mode else mode
                    if sub not in converter_names:
                        self.emit(
                            "NNS011", ERROR, node.pos,
                            f"tensor_converter {node.label!r}: unknown "
                            f"converter subplugin {sub!r}",
                            hint=f"registered converters: "
                                 f"{', '.join(sorted(converter_names))}")
            if node.factory in ("tensor_mux", "tensor_merge"):
                self._check_sync(node)
            if node.factory == "queue":
                leaky = p.get("leaky", "no")
                if leaky not in ("no", "downstream"):
                    self.emit("NNS008", ERROR, node.pos,
                              f"queue {node.label!r}: unknown leaky mode "
                              f"{leaky!r} (use 'no' or 'downstream')")
                elif leaky == "downstream" and node.name is None:
                    self.emit(
                        "NNS010", WARNING, node.pos,
                        "leaky queue has no explicit name — its "
                        "nns_queue_drops_total metric gets an unstable "
                        "auto-generated label, so drops are effectively "
                        "unmonitored",
                        hint="add name=... and watch nns_queue_drops_total")

    def _check_sync(self, node: _Node) -> None:
        mode = node.props.get("sync_mode", "slowest")
        option = node.props.get("sync_option", "")
        if mode not in _SYNC_POLICIES:
            self.emit("NNS008", ERROR, node.pos,
                      f"{node.factory} {node.label!r}: unknown sync_mode "
                      f"{mode!r}",
                      hint=f"valid policies: {', '.join(_SYNC_POLICIES)}")
            return
        if mode == "basepad" and option:
            parts = str(option).split(":")
            ok = parts[0].isdigit() and (
                len(parts) == 1 or _is_number(parts[1]))
            if not ok:
                self.emit("NNS008", ERROR, node.pos,
                          f"{node.factory} {node.label!r}: basepad "
                          f"sync_option {option!r} is not "
                          f"'<pad>[:<duration>]'")
        elif mode != "basepad" and option:
            self.emit("NNS008", WARNING, node.pos,
                      f"{node.factory} {node.label!r}: sync_option "
                      f"{option!r} is ignored by sync_mode={mode}",
                      hint="only basepad consumes sync_option")

    # -- link resolution -----------------------------------------------------
    def _check_links(self, chains, nodes: Dict[int, _Node]) -> None:
        self.links: List[Tuple[int, int]] = []

        def resolve(ast) -> Optional[_Node]:
            if ast.kind in ("ref", "refpad"):
                node = self.by_name.get(ast.ref)
                if node is None:
                    self.emit("NNS004", ERROR, ast.pos,
                              f"unknown element reference {ast.ref!r}")
                return node
            return self.node_of.get(id(ast))

        def take_src(node: _Node, ast) -> bool:
            spec = node.spec
            if spec is None:
                return True
            pad = ast.pad if ast.kind == "refpad" else None
            if pad is not None and not pad.startswith("src"):
                self.emit("NNS004", ERROR, ast.pos,
                          f"{node.label!r}: {pad!r} is not a src pad")
                return False
            if spec.n_src is None:
                return True
            if node.src_used < spec.n_src or spec.requests_src:
                node.src_used += 1
                return True
            self.emit("NNS004", ERROR, ast.pos,
                      f"{node.label!r} ({node.factory}): no free src pad")
            return False

        def take_sink(node: _Node, ast) -> bool:
            spec = node.spec
            if spec is None:
                return True
            pad = ast.pad if ast.kind == "refpad" else None
            if pad is not None:
                if not pad.startswith("sink"):
                    self.emit("NNS004", ERROR, ast.pos,
                              f"{node.label!r}: {pad!r} is not a sink pad")
                    return False
                suffix = pad[len("sink_"):] if pad.startswith("sink_") \
                    else ""
                if suffix.isdigit() and spec.requests_sink:
                    # implied lower-index pads must also end up linked
                    node.sink_grown = max(node.sink_grown,
                                          int(suffix) + 1)
            if spec.n_sink is None:
                return True
            if node.sink_used < max(spec.n_sink, node.sink_grown) \
                    or spec.requests_sink:
                node.sink_used += 1
                return True
            self.emit("NNS004", ERROR, ast.pos,
                      f"{node.label!r} ({node.factory}): no free sink pad")
            return False

        for chain in chains:
            for a, b in zip(chain, chain[1:]):
                na, nb = resolve(a), resolve(b)
                if na is None or nb is None:
                    continue
                ok_src = take_src(na, a)
                ok_sink = take_sink(nb, b)
                if ok_src and ok_sink:
                    na.out_links.append(nb.id)
                    nb.in_links.append(na.id)
                    self.links.append((na.id, nb.id))

    # -- whole-graph checks --------------------------------------------------
    def _check_graph(self, nodes: Dict[int, _Node]) -> None:
        has_source = False
        for node in nodes.values():
            spec = node.spec
            if spec is None:
                continue
            if spec.is_source:
                has_source = True
            # inputs that can never receive data: a non-source element
            # with sink pads but nothing linked into it (NNS006 error:
            # runtime would silently never flow, or a sync policy would
            # wait forever)
            if (not node.in_links and not spec.is_source
                    and (spec.n_sink or 0) > 0):
                self.emit(
                    "NNS006", ERROR, node.pos,
                    f"{node.label!r} ({node.factory}): sink pad is never "
                    f"linked — no data will ever reach it")
            # implied request-sink pads (mux m.sink_2 referenced, but
            # fewer links made) — the same condition parse_launch rejects
            if node.sink_grown > len(node.in_links):
                self.emit(
                    "NNS006", ERROR, node.pos,
                    f"{node.label!r} ({node.factory}): sink pads up to "
                    f"index {node.sink_grown - 1} are implied but only "
                    f"{len(node.in_links)} link(s) were made — a sync "
                    f"policy would wait on the missing inputs forever")
            # outputs nobody consumes (runtime drops them; usually a
            # missing sink or a forgotten branch)
            if (spec.n_src or 0) > 0 and not node.out_links \
                    and not spec.is_sink:
                self.emit(
                    "NNS006", WARNING, node.pos,
                    f"{node.label!r} ({node.factory}): src pad is "
                    f"unlinked — its output is dropped",
                    hint="terminate the chain with a sink element")
            if node.factory == "tee" and len(node.out_links) >= 2:
                for dst in node.out_links:
                    if nodes[dst].factory != "queue":
                        self.emit(
                            "NNS009", WARNING, node.pos,
                            f"tee {node.label!r}: branch into "
                            f"{nodes[dst].label!r} has no queue — all "
                            f"branches run serially on one thread, and a "
                            f"blocking branch starves the others",
                            hint="start each tee branch with queue")
        if nodes and not has_source:
            self.emit("NNS006", WARNING,
                      min(n.pos for n in nodes.values()),
                      "pipeline has no source element — nothing will "
                      "ever flow")
        self._check_cycles(nodes)

    def _check_cycles(self, nodes: Dict[int, _Node]) -> None:
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {i: WHITE for i in nodes}
        self.has_cycle = False

        def dfs(u: int, path: List[int]) -> None:
            color[u] = GRAY
            path.append(u)
            for v in nodes[u].out_links:
                if color[v] == GRAY:
                    cyc = path[path.index(v):] + [v]
                    names = " -> ".join(nodes[i].label for i in cyc)
                    self.emit("NNS007", ERROR, nodes[v].pos,
                              f"cycle in pipeline graph: {names}",
                              hint="recurrence belongs in tensor_reposrc/"
                                   "tensor_reposink slots, not pad links")
                    self.has_cycle = True
                elif color[v] == WHITE:
                    dfs(v, path)
            path.pop()
            color[u] = BLACK

        for i in nodes:
            if color[i] == WHITE:
                dfs(i, [])

    # -- caps/dtype/shape propagation ----------------------------------------
    def _propagate_caps(self, nodes: Dict[int, _Node]) -> None:
        if getattr(self, "has_cycle", False):
            return  # no topological order to walk
        order = self._topo(nodes)
        out_caps: Dict[int, Optional[Caps]] = {}
        for nid in order:
            node = nodes[nid]
            in_caps = None
            for src in node.in_links:
                c = out_caps.get(src)
                if c is not None:
                    in_caps = c
                    self._check_media(nodes[src], node, c)
            out_caps[nid] = self._derive_out(node, in_caps)

    def _topo(self, nodes: Dict[int, _Node]) -> List[int]:
        indeg = {i: len(n.in_links) for i, n in nodes.items()}
        ready = [i for i, d in indeg.items() if d == 0]
        order: List[int] = []
        while ready:
            u = ready.pop()
            order.append(u)
            for v in nodes[u].out_links:
                indeg[v] -= 1
                if indeg[v] == 0:
                    ready.append(v)
        return order

    def _check_media(self, src: _Node, dst: _Node, caps: Caps) -> None:
        spec = dst.spec
        if spec is None or spec.media_in is None:
            return
        if caps.name not in spec.media_in:
            hint = None
            if caps.name in ("video/x-raw", "audio/x-raw",
                            "application/octet-stream") and \
                    "other/tensors" in spec.media_in:
                hint = (f"insert tensor_converter between "
                        f"{src.label!r} and {dst.label!r}")
            self.emit(
                "NNS005", ERROR, dst.pos,
                f"link {src.label!r} -> {dst.label!r}: caps "
                f"{caps.name!r} do not intersect with accepted types "
                f"{{{', '.join(sorted(spec.media_in))}}}", hint=hint)

    def _derive_out(self, node: _Node,
                    in_caps: Optional[Caps]) -> Optional[Caps]:
        f = node.factory
        spec = node.spec
        if spec is None:
            return None
        if spec.is_source:
            return static_src_caps(spec, node.props)
        if f in PASSTHROUGH:
            return in_caps
        if f == "capsfilter":
            want = self._capsfilter_caps(node)
            if want is None:
                return in_caps
            if in_caps is None:
                return want
            merged = in_caps.intersect(want)
            if merged is None:
                self.emit(
                    "NNS005", ERROR, node.pos,
                    f"capsfilter {node.label!r}: upstream caps "
                    f"{in_caps!r} do not intersect filter {want!r}")
                return None
            return merged
        if f == "tensor_converter" and in_caps is not None:
            return self._converter_out(node, in_caps)
        return None  # format settles at runtime; propagation stops here

    def _capsfilter_caps(self, node: _Node) -> Optional[Caps]:
        from nnstreamer_tpu_torch.pipeline.parse import parse_caps_string

        raw = node.caps_str or node.props.get("caps")
        if not raw:
            return None
        try:
            return parse_caps_string(raw)
        except ValueError as e:
            self.emit("NNS012", ERROR, node.pos,
                      f"capsfilter {node.label!r}: bad caps string: {e}")
            return None

    def _converter_out(self, node: _Node,
                       in_caps: Caps) -> Optional[Caps]:
        """Derive converter output caps by asking the REAL negotiation
        code (``TensorConverter._derive_config``) — a throwaway instance
        holds no runtime state, and reusing it means the verifier can
        never drift from what negotiation will actually do."""
        try:
            inst = node.spec.klass()
            for k, v in node.props.items():
                if k != "name":
                    inst.set_property(k, v)
            cfg = inst._derive_config(in_caps)
        except Exception as e:  # noqa: BLE001 — any failure here IS the
            # negotiation failure runtime would hit on the first buffer
            self.emit(
                "NNS005", ERROR, node.pos,
                f"tensor_converter {node.label!r} cannot negotiate "
                f"upstream caps {in_caps!r}: {e}")
            return None
        return cfg.to_caps() if cfg is not None else None


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def verify_description(description: str,
                       source: str = "<description>") -> List[Diagnostic]:
    """Statically verify an nns-launch description. Returns diagnostics
    (possibly empty); never raises on a malformed description — syntax
    errors come back as NNS012."""
    return _Verifier(description, source).run()


def verify_pipeline(pipe) -> List[Diagnostic]:
    """Pre-flight an already-constructed :class:`Pipeline` (one built in
    code, too): dangling pads, cycles, sync-policy conflicts, tee fan-out
    without queues. Exposed as ``Pipeline.verify()``."""
    from nnstreamer_tpu_torch.pipeline.pipeline import Queue, SourceElement

    diags: List[Diagnostic] = []
    src = f"<pipeline:{pipe.name}>"

    def emit(code, severity, message, hint=None):
        diags.append(Diagnostic(code, severity, Location(src), message,
                                hint))

    has_source = False
    for el in pipe.elements:
        if isinstance(el, SourceElement):
            has_source = True
        for p in el.sinkpads:
            if p.peer is None:
                emit("NNS006", ERROR,
                     f"{el.name!r} ({el.ELEMENT_NAME}): sink pad "
                     f"{p.name!r} is never linked — no data will ever "
                     f"reach it")
        if not isinstance(el, SourceElement) or el.srcpads:
            unlinked = [p.name for p in el.srcpads if p.peer is None]
            if unlinked and len(unlinked) == len(el.srcpads) \
                    and el.srcpads:
                emit("NNS006", WARNING,
                     f"{el.name!r} ({el.ELEMENT_NAME}): src pad(s) "
                     f"{unlinked} unlinked — output is dropped")
        if el.ELEMENT_NAME in ("tensor_mux", "tensor_merge"):
            mode = el.get_property("sync_mode")
            if mode not in _SYNC_POLICIES:
                emit("NNS008", ERROR,
                     f"{el.name!r}: unknown sync_mode {mode!r}",
                     hint=f"valid policies: {', '.join(_SYNC_POLICIES)}")
        if el.ELEMENT_NAME == "tee" and len(el.srcpads) >= 2:
            for p in el.srcpads:
                peer = p.peer.element if p.peer is not None else None
                if peer is not None and not isinstance(peer, Queue):
                    emit("NNS009", WARNING,
                         f"tee {el.name!r}: branch into {peer.name!r} "
                         f"has no queue — branches run serially",
                         hint="start each tee branch with a queue")
    if pipe.elements and not has_source:
        emit("NNS006", WARNING,
             "pipeline has no source element — nothing will ever flow")

    # cycle check over pad links
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {id(el): WHITE for el in pipe.elements}

    def dfs(el, path):
        color[id(el)] = GRAY
        path.append(el)
        for p in el.srcpads:
            if p.peer is None:
                continue
            nxt = p.peer.element
            if color.get(id(nxt)) == GRAY:
                names = " -> ".join(e.name for e in path) + f" -> {nxt.name}"
                emit("NNS007", ERROR,
                     f"cycle in pipeline graph: {names}")
            elif color.get(id(nxt)) == WHITE:
                dfs(nxt, path)
        path.pop()
        color[id(el)] = BLACK

    for el in pipe.elements:
        if color[id(el)] == WHITE:
            dfs(el, [])
    return sort_diagnostics(diags)
