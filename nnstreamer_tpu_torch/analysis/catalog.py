"""Static element catalog — per-factory metadata for the verifier.

The verifier needs to answer, per factory name and WITHOUT constructing
any pipeline runtime state: which properties exist, how many pads there
are and whether more can be requested, whether the element is a source or
a sink, which media types its sink side accepts, and — where statically
derivable — what caps its src side produces. This module derives that
once per element class:

- properties come from the class ``PROPERTIES`` dict merged across the
  MRO (exactly how ``Element.__init__`` builds its property table);
- pad topology comes from instantiating the class once behind a guard —
  element constructors only allocate pads and plain host objects (threads
  and backends appear at ``start()``), so this stays purely structural;
  a constructor that needs more context degrades to "unknown pads";
- request-pad capability is read off the class: an element that overrides
  ``request_src_pad``/``request_sink_pad`` can grow pads on demand;
- accepted input media types and static source caps are small hand-kept
  tables for the built-in factories (a subplugin absent from the tables
  simply opts out of media-type checking — never a false positive).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, FrozenSet, Optional

from nnstreamer_tpu_torch.pipeline.caps import Caps
from nnstreamer_tpu_torch.pipeline.element import Element
from nnstreamer_tpu_torch.registry import ELEMENT, get_subplugin

#: media-type names used by the built-in elements (tensors/types.py)
TENSORS = "other/tensors"
TENSOR = "other/tensor"
_TENSOR_IN: FrozenSet[str] = frozenset({TENSORS, TENSOR})

#: factories whose sink side only accepts the listed media types.
#: Factories not listed accept anything (their checks are skipped).
MEDIA_IN: Dict[str, FrozenSet[str]] = {
    "tensor_converter": frozenset({"video/x-raw", "audio/x-raw",
                                   "application/octet-stream",
                                   "text/x-raw"}),
    "tensor_filter": _TENSOR_IN,
    "tensor_decoder": _TENSOR_IN,
    "tensor_transform": _TENSOR_IN,
    "tensor_mux": _TENSOR_IN,
    "tensor_merge": _TENSOR_IN,
    "tensor_demux": _TENSOR_IN,
    "tensor_split": _TENSOR_IN,
    "tensor_crop": _TENSOR_IN,
    "tensor_aggregator": _TENSOR_IN,
    "tensor_rate": _TENSOR_IN,
    "tensor_if": _TENSOR_IN,
    "tensor_sparse_enc": _TENSOR_IN,
    "tensor_sparse_dec": _TENSOR_IN,
    "tensor_quant_enc": _TENSOR_IN,
    "tensor_quant_dec": _TENSOR_IN,
    "tensor_reposink": _TENSOR_IN,
    "tensor_query_client": _TENSOR_IN,
    "tensor_query_serversink": _TENSOR_IN,
}

#: elements that forward caps unchanged — propagation flows through them
PASSTHROUGH: FrozenSet[str] = frozenset({"queue", "tee"})


@dataclasses.dataclass(frozen=True)
class ElementSpec:
    """Statically-derived facts about one element factory."""

    factory: str
    klass: type
    properties: FrozenSet[str]        # underscore-normalized names
    n_sink: Optional[int]             # None = unknown (ctor not probeable)
    n_src: Optional[int]
    requests_sink: bool
    requests_src: bool
    is_source: bool                   # runs a streaming thread
    media_in: Optional[FrozenSet[str]]  # None = accepts anything

    @property
    def is_sink(self) -> bool:
        """No outputs at all: a terminal element."""
        return self.n_src == 0 and not self.requests_src


_spec_cache: Dict[str, Optional[ElementSpec]] = {}


def spec_for(factory: str) -> Optional[ElementSpec]:
    """Spec for a factory name, or None when the factory is unknown."""
    if factory in _spec_cache:
        return _spec_cache[factory]
    cls = get_subplugin(ELEMENT, factory)
    spec = _derive(factory, cls) if isinstance(cls, type) else None
    _spec_cache[factory] = spec
    return spec


def _derive(factory: str, cls: type) -> ElementSpec:
    props: Dict[str, Any] = {}
    for klass in reversed(cls.__mro__):
        props.update(getattr(klass, "PROPERTIES", {}))

    n_sink: Optional[int] = None
    n_src: Optional[int] = None
    try:
        inst = cls()
        n_sink, n_src = len(inst.sinkpads), len(inst.srcpads)
    except Exception:  # nns-lint: disable=NNS104 -- ctor probe: any failure just means pad counts stay unknown
        pass

    from nnstreamer_tpu_torch.pipeline.pipeline import SourceElement

    return ElementSpec(
        factory=factory,
        klass=cls,
        properties=frozenset(k.replace("-", "_") for k in props),
        n_sink=n_sink,
        n_src=n_src,
        requests_sink=(cls.request_sink_pad is not Element.request_sink_pad),
        requests_src=(cls.request_src_pad is not Element.request_src_pad),
        is_source=issubclass(cls, SourceElement),
        media_in=MEDIA_IN.get(factory),
    )


def _prop(props: Dict[str, str], spec: ElementSpec, key: str) -> Any:
    """Property value for caps derivation: explicit value, else default."""
    if key in props:
        return props[key]
    defaults: Dict[str, Any] = {}
    for klass in reversed(spec.klass.__mro__):
        defaults.update(getattr(klass, "PROPERTIES", {}))
    return defaults.get(key)


def static_src_caps(spec: ElementSpec,
                    props: Dict[str, str]) -> Optional[Caps]:
    """Source-element output caps derivable from properties alone, or
    None when the format only settles at runtime (appsrc without caps,
    repo/query sources, ...). Mirrors each source's ``negotiate()``."""
    f = spec.factory
    if f == "videotestsrc":
        try:
            return Caps("video/x-raw", {
                "format": str(_prop(props, spec, "format")),
                "width": int(_prop(props, spec, "width")),
                "height": int(_prop(props, spec, "height")),
                "framerate": str(_prop(props, spec, "framerate")),
            })
        except (TypeError, ValueError):
            return None
    if f == "audiotestsrc":
        try:
            return Caps("audio/x-raw", {
                "format": str(_prop(props, spec, "format")),
                "rate": int(_prop(props, spec, "rate")),
                "channels": int(_prop(props, spec, "channels")),
            })
        except (TypeError, ValueError):
            return None
    if f == "filesrc":
        return Caps("application/octet-stream", {})
    if f in ("multifilesrc", "appsrc"):
        caps = props.get("caps")
        if caps:
            from nnstreamer_tpu_torch.pipeline.parse import parse_caps_string

            try:
                return parse_caps_string(caps)
            except ValueError:
                return None
        return (Caps("application/octet-stream", {})
                if f == "multifilesrc" else None)
    if f == "tensor_src_iio":
        return Caps(TENSORS, {})
    return None
