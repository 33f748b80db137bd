"""What a ``torch.profiler`` slice of the window says, reduced once for
every metric reader: the device's busy time (the union of its
intervals), device time by kernel name, the host's CUDA launch calls in
order, and the idle gaps between device work named by the host call that
overlapped them most. The union and the launch-call count are
``chip_smoke.py::device_profile``'s arithmetic, copied."""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

#: the runtime calls that put work on the card (a kernel, a copy, a graph)
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                     "cudaMemsetAsync")
#: entries of each list in a result's ``breakdown``
TOP = 10
#: characters kept of a kernel's (templated) name
NAME_CHARS = 120


def union(spans: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """Total length of the union of ``(start, end)`` spans, and the union
    as disjoint sorted spans."""
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return sum(b - a for a, b in merged), merged


@dataclass
class Slice:
    """One profiled slice of a window. Times in microseconds."""
    wall_us: float
    busy_us: float = 0.0
    #: kernel (device op) name → (total device µs, count)
    device_ops: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    #: (start µs, name) of each host launch call, in time order
    host_calls: List[Tuple[float, str]] = field(default_factory=list)
    #: host call name → idle µs it overlapped most
    idle_by_host: Dict[str, float] = field(default_factory=dict)
    #: frames that reached the sink inside the slice
    frames: int = 0

    def op_time(self, fragment: str) -> Optional[Tuple[float, int]]:
        """Total device µs and count of the ops whose name holds
        ``fragment``; None when no such op ran."""
        us = n = 0
        for name, (t, c) in self.device_ops.items():
            if fragment in name:
                us += t
                n += c
        return (us, n) if n else None

    def breakdown(self) -> Dict[str, list]:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1][0])
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n[:NAME_CHARS], t / 1e6]
                               for n, (t, _) in ops[:TOP]],
                "idle_gaps": [[n, t / 1e6] for n, t in gaps[:TOP]]}


def kineto_events(prof, t0_ns: int, t1_ns: int
                  ) -> Iterator[Tuple[str, float, float, bool]]:
    """A stopped ``torch.profiler.profile``'s raw events that began in
    ``[t0_ns, t1_ns)`` of the wall clock, cut to it, as ``(name, start µs,
    end µs, ran on the device)``; read without building the profiler's
    Python event tree (which takes minutes at some hundred thousand
    events)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        a = ev.start_ns()
        if t0_ns <= a < t1_ns:
            yield (ev.name(), a / 1e3, min(ev.end_ns(), t1_ns) / 1e3,
                   ev.device_type() == cuda)


def reduce(events: Iterable[Tuple[str, float, float, bool]],
           wall_us: float) -> Slice:
    """Reduce a slice's events (:func:`kineto_events`) over its
    ``wall_us``."""
    out = Slice(wall_us=wall_us)
    spans: List[Tuple[float, float]] = []
    host: List[Tuple[float, float, str]] = []
    for name, a, b, on_device in events:
        if on_device:
            spans.append((a, b))
            t, c = out.device_ops.get(name, (0.0, 0))
            out.device_ops[name] = (t + (b - a), c + 1)
        elif name.startswith("cu"):
            host.append((a, b, name))
            if name in HOST_LAUNCH_CALLS:
                out.host_calls.append((a, name))
    out.host_calls.sort()
    out.busy_us, merged = union(spans)
    host.sort()
    starts = [h[0] for h in host]
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        best, name = 0.0, "host: no CUDA call"
        # host calls that began before the gap's end and may overlap it
        for a, b, n in host[max(0, bisect.bisect_left(starts, end) - 64):
                            bisect.bisect_right(starts, nxt)]:
            over = min(b, nxt) - max(a, end)
            if over > best:
                best, name = over, f"host: {n}"
        out.idle_by_host[name] = out.idle_by_host.get(name, 0.0) + (nxt - end)
    return out
