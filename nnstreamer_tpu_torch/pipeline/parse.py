"""gst-launch-style pipeline-description parser.

The reference's CLI *is* ``gst-launch-1.0`` with pipeline descriptions
(``Documentation/gst-launch-script-example.md``); the same grammar is used
programmatically via ``gst_parse_launch``. We implement the useful core of
that grammar over our element registry so reference pipelines translate
almost verbatim::

    parse_launch(
      "videotestsrc num-buffers=30 ! tensor_converter ! "
      "tensor_filter framework=torch model=mnv2 ! "
      "tensor_decoder mode=image_labeling option1=labels.txt ! "
      "tensor_sink name=out"
    )

Supported grammar (tools/development/parser is the reference's bison
grammar for the same language):

- ``element prop=value ...``  — properties; values may be quoted.
- ``a ! b ! c``               — linking.
- ``name=foo`` then ``foo.``  — named-element branch points (tee/demux):
  ``t. ! queue ! sink`` continues from element ``foo``'s next free src pad.
- ``foo.src_1`` / ``foo.sink_0`` — named-PAD references select an exact
  pad; request pads (src_N/sink_N) are created in order on demand.
- caps filter strings (``other/tensors,num_tensors=1,...``) between ``!``
  become :class:`CapsFilter` elements.

Parsing is split into two layers so the same grammar serves two
consumers (the reference keeps the same split: the bison grammar builds
a ``graph_t`` which ``gst_parse_launch`` then instantiates):

- :func:`parse_description` — pure syntax: tokenize (tracking source
  columns) and build chains of :class:`LaunchNode`. No registry access,
  no element construction.
- :func:`parse_launch` — instantiate the description against the element
  registry and resolve links into a live :class:`Pipeline`.

Errors raise :class:`ParseError` (a ``ValueError``) carrying the source
column (``pos``, 0-based) and token index, so linter diagnostics and
runtime parse errors cite the same location.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from nnstreamer_tpu_torch.pipeline.caps import Caps
from nnstreamer_tpu_torch.pipeline.element import Element, Pad
from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline
from nnstreamer_tpu_torch.registry import ELEMENT, get_subplugin, subplugin


class ParseError(ValueError):
    """Pipeline-description error with a source position.

    ``pos`` is the 0-based column of the offending token in the
    description string (None when unknown); ``token_index`` its index in
    the token stream. The rendered message carries the 1-based column so
    CLI output and analyzer diagnostics cite the same location.
    """

    def __init__(self, message: str, pos: Optional[int] = None,
                 token_index: Optional[int] = None):
        if pos is not None:
            message = f"{message} (at column {pos + 1})"
        super().__init__(message)
        self.pos = pos
        self.token_index = token_index


class PropertyParseError(ParseError, KeyError):
    """Unknown-property error: positional like every ParseError, but still
    a ``KeyError`` because that is ``Element.set_property``'s contract
    (callers distinguish bad-property from bad-structure by type)."""


@dataclasses.dataclass(frozen=True)
class Token:
    """One lexed token: text (quotes/escapes resolved) + source column."""

    text: str
    pos: int     # 0-based column of the token's first character
    index: int   # position in the token stream


@dataclasses.dataclass
class LaunchNode:
    """One node of a parsed (but not instantiated) description chain."""

    kind: str                      # "element" | "ref" | "refpad" | "caps"
    factory: Optional[str] = None  # element factory name ("caps": capsfilter)
    props: List[Tuple[str, str, int]] = dataclasses.field(
        default_factory=list)  # (key, value, source column)
    ref: Optional[str] = None      # referenced element name (ref/refpad)
    pad: Optional[str] = None      # referenced pad name (refpad)
    caps: Optional[str] = None     # raw caps string (kind == "caps")
    pos: int = 0                   # source column of the node's first token

    @property
    def name(self) -> Optional[str]:
        """The explicit ``name=`` property, if one was given."""
        for k, v, _ in self.props:
            if k == "name":
                return v
        return None


def tokenize_launch(description: str) -> List[Token]:
    """Lex a description into position-carrying tokens.

    Same token stream a posix shlex with ``punctuation_chars='!'`` would
    produce (whitespace-split words, quotes stripped, backslash escapes,
    ``!`` always its own token) — but every token remembers the column it
    started at, which is what gives parse errors and static-analyzer
    diagnostics a precise location.
    """
    tokens: List[Token] = []
    i, n = 0, len(description)
    while i < n:
        ch = description[i]
        if ch.isspace():
            i += 1
            continue
        if ch == "!":
            tokens.append(Token("!", i, len(tokens)))
            i += 1
            continue
        start = i
        parts: List[str] = []
        while i < n and not description[i].isspace() and description[i] != "!":
            c = description[i]
            if c in ('"', "'"):
                end = description.find(c, i + 1)
                if end < 0:
                    raise ParseError(f"unterminated {c} quote", pos=i,
                                     token_index=len(tokens))
                parts.append(description[i + 1:end])
                i = end + 1
            elif c == "\\" and i + 1 < n:
                parts.append(description[i + 1])
                i += 2
            else:
                parts.append(c)
                i += 1
        tokens.append(Token("".join(parts), start, len(tokens)))
    return tokens


@subplugin(ELEMENT, "capsfilter")
class CapsFilter(Element):
    """Constrains stream caps (gst capsfilter): intersects incoming caps with
    its ``caps`` property and forwards; buffers pass through untouched."""

    ELEMENT_NAME = "capsfilter"
    PROPERTIES = {**Element.PROPERTIES, "caps": None}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.add_src_pad("src")

    def transform_caps(self, pad, caps):
        want = self.get_property("caps")
        if want is None:
            return caps
        merged = caps.intersect(want)
        if merged is None:
            raise ValueError(
                f"{self.name}: caps {caps!r} do not satisfy filter {want!r}"
            )
        return merged.fixate()


def _split_caps_fields(text: str) -> List[str]:
    """Split a caps string on commas, respecting double-quoted values so
    multi-tensor fields like dimensions="3:224:224:1,3:300:300:1" stay
    whole."""
    parts, cur, in_q = [], [], False
    for ch in text:
        if ch == '"':
            in_q = not in_q
            cur.append(ch)
        elif ch == "," and not in_q:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def parse_caps_string(text: str) -> Caps:
    """Parse ``media/type,k=v,k2=v2`` into Caps (values kept as str/int).

    Multi-tensor values may contain commas, quoted or bare: a comma-part
    with no ``=`` continues the previous field's value, so both
    ``dimensions="2:2,3:3"`` and ``dimensions=2:2,3:3`` parse (the launch
    lexer strips quotes before this function sees the string)."""
    raw_parts = _split_caps_fields(text)
    # merge '='-less parts into the previous field's value
    parts: List[str] = [raw_parts[0]]
    for item in raw_parts[1:]:
        if "=" in item or len(parts) == 1:
            parts.append(item)
        else:
            parts[-1] += "," + item
    name = parts[0].strip()
    fields = {}
    for item in parts[1:]:
        if not item.strip():
            continue
        if "=" not in item:
            raise ValueError(f"bad caps field {item!r} in {text!r}")
        k, v = item.split("=", 1)
        v = v.strip().strip('"')
        # strip gst type annotations like (int)640 / (string)RGB
        if v.startswith("(") and ")" in v:
            v = v[v.index(")") + 1:]
        try:
            v2: object = int(v)
        except ValueError:
            v2 = v
        fields[k.strip()] = v2
    return Caps(name, fields)


def _is_caps_token(tok: str) -> bool:
    head = tok.split(",", 1)[0]
    return "/" in head and "=" not in head


def parse_description(description: str) -> List[List[LaunchNode]]:
    """Pure-syntax pass: description → chains of :class:`LaunchNode`.

    No registry lookups and no element construction happen here — factory
    names, properties, and references are recorded verbatim with their
    source columns. ``parse_launch`` instantiates the result; the static
    analyzer verifies it without instantiating anything.
    """
    tokens = tokenize_launch(description)
    chains: List[List[LaunchNode]] = [[]]
    current: Optional[LaunchNode] = None
    linked = False  # was the previous token a "!"?

    def close():
        nonlocal current
        if current is not None:
            chains[-1].append(current)
            current = None

    for tok in tokens:
        t = tok.text
        if t == "!":
            close()
            linked = True
            continue
        if "=" in t and current is not None and not _is_caps_token(t):
            k, v = t.split("=", 1)
            current.props.append((k, v, tok.pos))
            continue
        # a new node begins; if no "!" came before it, start a new chain
        close()
        if not linked and chains[-1]:
            chains.append([])
        linked = False
        if t.endswith(".") and len(t) > 1 and "=" not in t:
            chains[-1].append(LaunchNode("ref", ref=t[:-1], pos=tok.pos))
        elif ("." in t and "=" not in t and not _is_caps_token(t)
                and not t.startswith(".")):
            # gst-launch named-pad reference: ``name.pad`` selects that
            # exact pad (``s.src_1 ! ...`` / ``... ! m.sink_0``)
            name, pad = t.split(".", 1)
            chains[-1].append(LaunchNode("refpad", ref=name, pad=pad,
                                         pos=tok.pos))
        elif _is_caps_token(t):
            current = LaunchNode("caps", factory="capsfilter", caps=t,
                                 pos=tok.pos)
        else:
            current = LaunchNode("element", factory=t, pos=tok.pos)
    close()
    return chains


def _make_element(factory_name: str, pos: Optional[int] = None) -> Element:
    from nnstreamer_tpu_torch.config import get_conf

    conf = get_conf()
    # element-restriction allowlist (reference meson.build:531-540:
    # [element-restriction] enable_element_restriction + allowed_elements;
    # the short `enable`/`restricted_elements` spellings are also accepted)
    allowed = conf.allowed_elements()
    if allowed is not None and factory_name not in allowed:
        # fail closed at parse: a restricted deployment never instantiates
        # an unlisted element (reference enable-element-restriction)
        raise ParseError(
            f"element {factory_name!r} is not in the configured "
            f"element-restriction allowlist", pos=pos)
    factory = get_subplugin(ELEMENT, factory_name)
    if factory is None:
        raise ParseError(f"no such element factory {factory_name!r}",
                         pos=pos)
    return factory()


def _build_element(node: LaunchNode) -> Element:
    """Instantiate one LaunchNode and apply its properties."""
    if node.kind == "caps":
        el: Element = CapsFilter()
        el.set_property("caps", parse_caps_string(node.caps))
    else:
        if "=" in (node.factory or ""):
            raise ParseError(
                f"property token {node.factory!r} has no element to "
                f"apply to", pos=node.pos)
        el = _make_element(node.factory, pos=node.pos)
    for k, v, pos in node.props:
        try:
            if k == "name":
                el.name = v  # set before Pipeline.add registers it
            elif k == "caps" and isinstance(el, CapsFilter):
                el.set_property("caps", parse_caps_string(v))
            else:
                el.set_property(k, v)
        except KeyError as e:
            # carry the property token's position, preserving KeyError-ness
            raise PropertyParseError(e.args[0] if e.args else str(e),
                                     pos=pos) from e
    return el


def parse_launch(description: str, pipeline: Optional[Pipeline] = None,
                 lanes: Optional[int] = None,
                 slo_budget_ms: Optional[float] = None,
                 error_policy: Optional[str] = None,
                 watchdog_s: Optional[float] = None) -> Pipeline:
    """Build a Pipeline from a gst-launch-style description.

    Two-pass like gst_parse_launch: first build all elements and record the
    link structure (so ``... ! mux.`` may reference an element defined later
    in the description), then resolve links.

    The keyword arguments are the JAX package's: ``lanes`` sets the
    pipeline's ingest lane count (``pipeline/lanes.py``),
    ``slo_budget_ms`` its SLO budget (``serving/scheduler.py``: deadline
    admission, EDF ordering and feedback-tuned batch forming on the
    admission-point queues; 0 leaves the scheduler off), ``error_policy``
    its default error policy (``pipeline/supervise.py``) and
    ``watchdog_s`` arms the stall watchdog; None leaves the pipeline's own
    value.
    """
    pipe = pipeline or Pipeline()
    if lanes is not None:
        pipe.lanes = max(1, int(lanes))
    if slo_budget_ms is not None:
        pipe.slo_budget_ms = max(0.0, float(slo_budget_ms))
    if error_policy is not None:
        pipe.error_policy = error_policy
    if watchdog_s is not None:
        pipe.watchdog_s = max(0.0, float(watchdog_s))

    # -- pass 1: nodes & chains (syntax via parse_description) ---------------
    # node: ("el", Element) | ("ref", name) | ("refpad", name, pad)
    chains: List[List[tuple]] = []
    for ast_chain in parse_description(description):
        chain: List[tuple] = []
        for node in ast_chain:
            if node.kind == "ref":
                chain.append(("ref", node.ref, node.pos))
            elif node.kind == "refpad":
                chain.append(("refpad", node.ref, node.pos, node.pad))
            else:
                el = _build_element(node)
                pipe.add(el)
                chain.append(("el", el, node.pos))
        chains.append(chain)

    # -- pass 2: resolve links ----------------------------------------------
    def resolve(node) -> Element:
        kind, val, pos = node[0], node[1], node[2]
        if kind == "el":
            return val
        if val not in pipe.by_name:
            raise ParseError(f"unknown element reference {val!r}", pos=pos)
        return pipe.by_name[val]

    implied_sinks: List = []

    def named_pad(el: Element, pname: str, direction: str, pos: int):
        pads = el.srcpads if direction == "src" else el.sinkpads
        for p in pads:
            if p.name == pname:
                return p
        m = None
        if pname.startswith(f"{direction}_"):
            suffix = pname[len(direction) + 1:]
            m = int(suffix) if suffix.isdigit() else None
        if m is None:
            raise ParseError(
                f"element {el.name!r} has no {direction} pad {pname!r} "
                f"(has: {[p.name for p in pads]})", pos=pos)
        # request-pad convention (src_N/sink_N): pads are POSITIONAL in
        # the elements that use them (split segment i → i-th pad, mux
        # pad index → tensor slot), so create every index up to the one
        # requested — a description may reference them in any order.
        # Implied-but-unlinked SINK pads are validated after all links
        # resolve (an input a sync policy would wait on forever must be
        # a parse error, not a hang); unlinked src pads just drop.
        try:
            while len(pads) <= m:
                if direction == "sink":
                    implied_sinks.append(el.request_sink_pad())
                else:
                    el.request_src_pad()
        except NotImplementedError as e:
            raise ParseError(
                f"element {el.name!r} has no {direction} pad {pname!r} "
                f"and cannot grow one ({e})", pos=pos) from e
        return pads[m]

    for chain in chains:
        for a, b in zip(chain, chain[1:]):
            ea, eb = resolve(a), resolve(b)
            a_pad = a[3] if a[0] == "refpad" else None
            b_pad = b[3] if b[0] == "refpad" else None
            if a_pad is None and b_pad is None:
                ea.link(eb)
                continue
            if a_pad is not None:
                src = named_pad(ea, a_pad, "src", a[2])
            else:
                src = next((p for p in ea.srcpads if p.peer is None), None)
                if src is None:
                    try:
                        # tee/split/demux grow src pads on demand
                        src = ea.request_src_pad()
                    except NotImplementedError:
                        raise ParseError(
                            f"{ea.name}: no free src pad",
                            pos=a[2]) from None
            if b_pad is not None:
                sink = named_pad(eb, b_pad, "sink", b[2])
            else:
                sink = next((p for p in eb.sinkpads if p.peer is None),
                            None)
                if sink is None:
                    sink = eb.request_sink_pad()
            src.link(sink)
    for pad in implied_sinks:
        if pad.peer is None:
            raise ParseError(
                f"sink pad {pad.element.name}.{pad.name} was implied by a "
                f"higher-numbered reference but never linked — a sync "
                f"policy would wait on it forever")
    return pipe
