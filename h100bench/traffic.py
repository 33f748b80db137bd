"""The one generator every traffic mix goes through: a mix's parameters
(``traffic/<mix>.json``) → the launch string around a configuration's
model segment, the branches it feeds, and the stream of frames.

A mix's keys:

- ``arrivals``: ``"closed"`` (one pushing thread a source, the next
  frame as soon as ``appsrc`` accepts the last; give it ``block=true``)
  or ``"poisson"`` (an open loop at ``rate_fps`` a source; give it
  ``block=false``, so a frame the pipeline cannot take counts as
  failed);
- ``launch``: the launch string, with ``{caps}`` where the
  configuration's input caps go and ``{model}`` where its model segment
  goes. Each source is an ``appsrc`` named ``src<suffix>`` and feeds the
  ``tensor_sink`` named ``sink<suffix>``: one branch each;
- ``batch``: frames a model window (the configuration's segment is
  built for it; the aggregator that makes it is in ``launch``);
- ``inflight``: the filter's dispatch window;
- ``pool_frames``: distinct seeded frames, sent in turn;
- ``warmup_windows``: windows pushed into each source and awaited
  before the window (the eager first window and the capture);
- ``preroll_s``: seconds the stream runs at its load before the window
  opens, so the window starts in the steady state.

Poisson arrivals give every seed the same set of gaps — the quantiles
of an exponential, scaled so that ``rate_fps × (preroll_s + seconds)``
of them fill the span — in an order drawn from the seed and the
source, so two seeds offer the same frames over the same time.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

_SOURCE = re.compile(r"^src(\w*)$")


def describe(mix: Dict, program, cfg: Dict, model: str) -> str:
    """The mix's ``launch`` with the configuration's caps and its model
    segment (``model`` registered, at the mix's batch and dispatch
    window) filled in."""
    segment = program.segment(cfg, model, int(mix["batch"]),
                              int(mix["inflight"]))
    return mix["launch"].format(caps=program.caps(cfg),
                                model=segment.strip())


def branches(pipe) -> List[Tuple[str, object, object]]:
    """``(suffix, appsrc, tensor_sink)`` of each source ``src<suffix>``
    of the pipeline and the sink ``sink<suffix>`` it feeds."""
    out = []
    for el in pipe.elements:
        m = _SOURCE.match(el.name or "")
        if m:
            out.append((m.group(1), el, pipe.get("sink" + m.group(1))))
    if not out:
        raise ValueError("the launch string names no appsrc src<suffix>")
    return out


def offsets(mix: Dict, seed: int, seconds: float, source: int = 0
            ) -> Optional[np.ndarray]:
    """Due times of a Poisson mix's frames into its ``source``-th source,
    in seconds from the start of the preroll (the first at 0); None for
    a closed loop."""
    if mix["arrivals"] == "closed":
        return None
    if mix["arrivals"] != "poisson":
        raise ValueError(f"unknown arrivals {mix['arrivals']!r}")
    rate = float(mix["rate_fps"])
    span = float(mix["preroll_s"]) + float(seconds)
    n = max(int(round(rate * span)), 1)
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q)
    gaps *= span / gaps.sum()
    rng = np.random.default_rng([int(seed) % (1 << 63), int(source)])
    return np.concatenate([[0.0], np.cumsum(rng.permutation(gaps))[:-1]])
