"""Platform selection helpers for scripts, examples and tools.

Port of ``nnstreamer_tpu/utils/platform.py``. A host may expose a card
that fails to initialise, or a CUDA stack that wedges while it starts
(blocks instead of raising). So before this process commits to the card,
:func:`probe_cuda_platform` starts ``torch.cuda`` in a SUBPROCESS with a
timeout. The probe child leads its own process group, and the whole
group is killed on timeout, so a wedged CUDA stack (or a helper process
it forked holding our pipe) cannot hang the probe itself. Verdicts are
cached in a temp file keyed by ``CUDA_VISIBLE_DEVICES`` (TTL
``NNSTPU_PROBE_CACHE_TTL``, default 600 s; ``NNSTPU_PROBE_NOCACHE=1``
turns the cache off).

:func:`ensure_platform` differs from the JAX package's
``ensure_jax_platform`` on purpose (ROADMAP queue C): with no healthy
card it raises unless the CPU was asked for (``set_device("cpu")`` or
``ensure_platform(cpu=True)``); the JAX package falls back to the CPU.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Optional

#: default probe budget: a card's first CUDA context can take tens of
#: seconds on a loaded host
DEFAULT_PROBE_TIMEOUT = 120.0

#: how long a cached probe verdict stays valid (seconds); override with
#: NNSTPU_PROBE_CACHE_TTL, disable caching with NNSTPU_PROBE_NOCACHE=1
DEFAULT_PROBE_CACHE_TTL = 600.0

#: the child's program: one JSON line naming the first card, or null
_PROBE = ("import json, torch; ok = torch.cuda.is_available(); "
          "print(json.dumps(torch.cuda.get_device_name(0) if ok "
          "and torch.cuda.device_count() else None))")


def _preset() -> str:
    return os.environ.get("CUDA_VISIBLE_DEVICES", "*").strip()


def _probe_cache_path(preset: str) -> str:
    tag = "".join(c if c.isalnum() else "_" for c in preset) or "default"
    return os.path.join(tempfile.gettempdir(),
                        f"nnstpu_cuda_probe_{os.getuid()}_{tag}.json")


def _probe_cache_get(preset: str) -> Optional[dict]:
    if os.environ.get("NNSTPU_PROBE_NOCACHE"):
        return None
    try:
        ttl = float(os.environ.get("NNSTPU_PROBE_CACHE_TTL",
                                   str(DEFAULT_PROBE_CACHE_TTL)))
    except ValueError:
        ttl = DEFAULT_PROBE_CACHE_TTL
    path = _probe_cache_path(preset)
    try:
        # st_mtime is wall-clock, so the freshness check must be too: the
        # cache file outlives the process. A negative age means the clock
        # was stepped back since the file was written; treat it as stale.
        wall_age = time.time() - os.stat(path).st_mtime
        if not 0 <= wall_age <= ttl:
            return None
        with open(path) as f:
            entry = json.load(f)
        return entry if isinstance(entry, dict) else None
    except (OSError, ValueError):
        return None


def _probe_cache_put(preset: str, platform: Optional[str]) -> None:
    if os.environ.get("NNSTPU_PROBE_NOCACHE"):
        return
    path = _probe_cache_path(preset)
    try:
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"platform": platform}, f)
        os.replace(tmp, path)
    except OSError:
        pass


def probe_cuda_platform(timeout_s: Optional[float] = None) -> Optional[str]:
    """Start ``torch.cuda`` in a subprocess; ``"cuda"`` when a card came
    up, None if initialisation failed, found no card or wedged past the
    timeout."""
    if timeout_s is None:
        timeout_s = float(os.environ.get("NNSTPU_PROBE_TIMEOUT",
                                         str(DEFAULT_PROBE_TIMEOUT)))
    proc = subprocess.Popen(
        [sys.executable, "-c", _PROBE],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        start_new_session=True,
    )
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            proc.kill()
        proc.wait()
        return None
    if proc.returncode != 0 or not out.strip():
        return None
    try:
        name = json.loads(out.strip().splitlines()[-1])
    except ValueError:
        return None
    return "cuda" if name else None


def ensure_platform(probe_timeout: Optional[float] = None,
                    cpu: bool = False) -> str:
    """The platform this process runs the package on: ``"cpu"`` when the
    CPU was asked for (``cpu=True`` or ``set_device("cpu")``), else
    ``"cuda"`` once a probe (or a cached verdict) found a healthy card.
    Raises ``RuntimeError`` otherwise: the port never falls back to the
    CPU on its own."""
    from nnstreamer_tpu_torch.device import get_device

    if cpu or get_device().type == "cpu":
        return "cpu"
    preset = _preset()
    cached = _probe_cache_get(preset)
    if cached is not None:
        healthy = cached.get("platform")
    else:
        healthy = probe_cuda_platform(probe_timeout)
        _probe_cache_put(preset, healthy)
    if healthy is None:
        raise RuntimeError(
            "nnstreamer_tpu_torch: no healthy CUDA device (the probe found "
            "none, failed or timed out); call "
            "nnstreamer_tpu_torch.set_device('cpu') or "
            "ensure_platform(cpu=True) to run on the CPU")
    return healthy
