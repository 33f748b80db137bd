"""Launch counts of the package's kernel wrappers, shared by all of them.

A wrapper adds one to its name's count where it launches its kernel and
nowhere else: the plain version on a CPU tensor does not count. A run
sets every count to 0 with :func:`reset_launches`, drives its path, and
reads ``LAUNCHES`` to show which kernels that path went through.

``LAUNCHES`` counts kernels that ran on the card. A wrapper called while
its stream captures a CUDA graph (``pipeline/fuse.py``) runs nothing then:
its launch goes to the tally that the capturing thread opened with
:func:`capture_tally`, and the graph's owner adds that tally to
``LAUNCHES`` on every replay (:func:`add_replay`). A capture without an
open tally is not counted.

Each wrapper is also a ``torch.library.custom_op`` (``nnstpu::<name>``,
registered when its module is imported): an exported program
(``filters/artifact.py``) calls the op, whose CUDA implementation is the
wrapper's launch and counts here as a direct call does, in a replay too.

:class:`GraphProgram` is the static-buffer program the LM path builds on
that: a body over buffers that stay where they are, captured once as a
CUDA graph (with its tally) and replayed; on the CPU the body runs.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, Optional

import torch

LAUNCHES: Dict[str, int] = {
    "normalize_chain": 0,
    "flash_attention": 0,
    "quantize_int8": 0,
}
_lock = threading.Lock()
_local = threading.local()


def _stream_capturing() -> bool:
    """Whether the calling thread's current CUDA stream is capturing."""
    return torch.cuda.is_current_stream_capturing()


#: the predicate :func:`count_launch` asks (the tests replace it)
capturing = _stream_capturing


def tracing() -> bool:
    """Whether ``torch.export`` or ``torch.compile`` traces the caller. A
    wrapper then calls its ``torch.ops.nnstpu`` op, which the traced
    graph holds in place of the kernel's ``ctypes`` call; outside a trace
    it keeps its direct call (the dispatcher costs every eager call)."""
    return torch.compiler.is_exporting() or torch.compiler.is_compiling()


def count_launch(name: str) -> None:
    if capturing():
        tally = getattr(_local, "tally", None)
        if tally is not None:
            tally[name] = tally.get(name, 0) + 1
        return
    with _lock:
        LAUNCHES[name] += 1


@contextlib.contextmanager
def capture_tally() -> Iterator[Dict[str, int]]:
    """Collect the launches this thread's wrappers capture inside the
    block: the kernel launches one replay of the captured graph runs."""
    tally: Dict[str, int] = {}
    outer = getattr(_local, "tally", None)
    _local.tally = tally
    try:
        yield tally
    finally:
        _local.tally = outer


def add_replay(tally: Dict[str, int]) -> None:
    """Count one replay of a graph whose capture tallied ``tally``."""
    if not tally:
        return
    with _lock:
        for name, n in tally.items():
            LAUNCHES[name] += n


def reset_launches() -> None:
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


class GraphProgram:
    """A body over static device buffers, run as one CUDA graph.

    A subclass allocates its buffers and defines :meth:`body`, which
    reads them, computes, and writes its results back into them: a
    graph replay reads and writes the same storage. :meth:`capture`
    records the body once (on a side stream, in ``thread_local`` mode, so
    the process's other threads keep using the card meanwhile); every
    :meth:`run` after it is one replay that adds the capture's tally to
    ``LAUNCHES``. Without a capture (the CPU) a run executes the body."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        #: kernel-wrapper launches one replay runs
        self.tally: Dict[str, int] = {}
        self.capture_s = 0.0

    def body(self) -> None:
        raise NotImplementedError

    def capture(self, stream: "torch.cuda.Stream", warm: bool) -> None:
        """Capture the body on ``stream``. ``warm`` first runs it eagerly
        there (cuBLAS's set-up for the stream, outside the capture): it
        changes the buffers and whatever the body writes, so only a caller
        for which that is harmless may ask for it."""
        t0 = time.monotonic()
        cur = torch.cuda.current_stream(stream.device)
        stream.wait_stream(cur)
        if warm:
            with torch.cuda.stream(stream):
                self.body()
            cur.wait_stream(stream)
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with capture_tally() as tally, torch.cuda.graph(
                graph, stream=stream, capture_error_mode="thread_local"):
            self.body()
        self.graph, self.tally = graph, dict(tally)
        self.capture_s = time.monotonic() - t0

    def run(self) -> None:
        if self.graph is None:
            self.body()
            return
        self.graph.replay()
        add_replay(self.tally)

    def release(self) -> None:
        """Drop the graph once the card is done with it (its private pool
        returns to the allocator)."""
        if self.graph is None:
            return
        with contextlib.suppress(RuntimeError):  # a failed card: drop anyway
            torch.cuda.synchronize(self.device)
        self.graph.reset()
        self.graph = None
