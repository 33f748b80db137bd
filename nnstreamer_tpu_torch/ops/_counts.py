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
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator

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
