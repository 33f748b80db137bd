"""Launch counts of the package's kernel wrappers, shared by all of them.

A wrapper adds one to its name's count where it launches its kernel and
nowhere else: the plain version on a CPU tensor does not count. A run
sets every count to 0 with :func:`reset_launches`, drives its path, and
reads ``LAUNCHES`` to show which kernels that path went through.
"""

from __future__ import annotations

import threading
from typing import Dict

LAUNCHES: Dict[str, int] = {
    "normalize_chain": 0,
    "flash_attention": 0,
    "quantize_int8": 0,
}
_lock = threading.Lock()


def count_launch(name: str) -> None:
    with _lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
