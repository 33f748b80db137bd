"""Logging façade (reference ``nnstreamer_log.h:29-77`` ml_log* macros).

One namespaced logger per element under the ``nnstreamer_tpu_torch``
package logger. Configuration is lazy and idempotent: the first
:func:`get_logger` call attaches one handler to the package logger (level
from ``NNSTREAMER_TPU_LOGLEVEL``, default WARNING) with
``propagate=False``, so the host application's root logging config is
never touched. Call :func:`configure` to re-apply after changing the env
var or to set an explicit level programmatically.
"""

from __future__ import annotations

import logging
import os
import threading

_ROOT = "nnstreamer_tpu_torch"
_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"

_configured = False
_config_lock = threading.Lock()


def configure(level=None, force: bool = False) -> logging.Logger:
    """Configure the package logger once (idempotent). ``level`` overrides
    ``NNSTREAMER_TPU_LOGLEVEL``; ``force=True`` re-reads the environment
    and re-applies the level even if already configured."""
    global _configured
    logger = logging.getLogger(_ROOT)
    with _config_lock:
        if _configured and not force and level is None:
            return logger
        if level is None:
            level = os.environ.get("NNSTREAMER_TPU_LOGLEVEL", "WARNING")
        if isinstance(level, str):
            level = level.upper()
        logger.setLevel(level)
        if not any(getattr(h, "_nnstpu", False) for h in logger.handlers):
            handler = logging.StreamHandler()
            handler.setFormatter(logging.Formatter(_FORMAT))
            handler._nnstpu = True  # ours: the idempotency marker
            logger.addHandler(handler)
        logger.propagate = False
        _configured = True
    return logger


def get_logger(name: str = "") -> logging.Logger:
    configure()
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)
