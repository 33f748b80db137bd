"""Build the package's CUDA kernels at first use and load them with ctypes.

Every ``nnstreamer_tpu_torch/csrc/<name>.cu`` becomes one shared library
with a plain C interface, compiled by ``nvcc`` for ``sm_90a`` (Hopper)
into ``nnstreamer_tpu_torch/_build/``. A library is keyed by a hash of its
source, the ``.cuh`` headers beside it and the compiler flags, so an
edited source rebuilds and an unchanged one loads from the build
directory. A file lock makes concurrent first uses build once. Nothing is
downloaded: only the sources in the package are compiled.

The build directory is the compile cache of ``pipeline/continuity.py``,
and :func:`build_dir` alone decides it: a directory a caller set
(:func:`set_build_dir`; ``enable_compile_cache(dir)`` and the CLI's
``--compile-cache`` set ``<dir>/kernels``), else
``$NNSTPU_COMPILE_CACHE/kernels``, else the package's ``_build/``. So a
second process on the same cache loads every library and builds none,
whether or not it starts a pipeline. The first time a process needs a
library it counts ``nns_compile_cache_hits_total`` (found built) or
``nns_compile_cache_misses_total`` (built anew).

``build_all()`` starts one ``nvcc`` per source, all at once, and waits for
them; ``load(name)`` builds (if needed) and loads one library.
``call_on_stream`` calls a loaded entry point on a device's current stream,
and ``sm_count`` gives the card's SM count for the wrappers' launch plans.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
#: the default build directory (ignored by git)
BUILD_DIR = PKG_DIR / "_build"
#: names a compile-cache directory; the libraries go in its ``kernels/``
CACHE_ENV = "NNSTPU_COMPILE_CACHE"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: the build directory a caller set (set_build_dir), else None
_override: Optional[Path] = None
#: libraries already counted as a cache hit or miss in this process
_counted: set = set()
_cache_metrics: Optional[Dict[str, object]] = None
#: per-library build record: seconds spent compiling (0.0 when the
#: library came from the build directory) and nvcc's output (ptxas -v)
build_log: Dict[str, Dict[str, object]] = {}


def set_build_dir(path) -> Optional[Path]:
    """Build (and look for) the libraries in ``path`` from now on; None
    goes back to what :func:`build_dir` finds without one."""
    global _override
    _override = None if path is None else Path(path).resolve()
    return _override


def build_dir() -> Path:
    """Where the libraries are built: the directory a caller set, else
    ``$NNSTPU_COMPILE_CACHE/kernels``, else the package's ``_build/``."""
    if _override is not None:
        return _override
    env = os.environ.get(CACHE_ENV, "").strip()
    if env:
        return Path(env).resolve() / "kernels"
    return BUILD_DIR


def cache_metrics() -> Dict[str, object]:
    """The compile cache's hit and miss counters (one per library a
    process needed: found built, or built anew)."""
    global _cache_metrics
    if _cache_metrics is None:
        from nnstreamer_tpu_torch.obs import get_registry

        reg = get_registry()
        _cache_metrics = {
            "hits": reg.counter(
                "nns_compile_cache_hits_total",
                "Kernel libraries found built in the build directory (a "
                "warm boot: no nvcc ran)"),
            "misses": reg.counter(
                "nns_compile_cache_misses_total",
                "Kernel libraries built anew by nvcc"),
        }
    return _cache_metrics


def _count(name: str, hit: bool) -> None:
    if name in _counted:
        return
    _counted.add(name)
    cache_metrics()["hits" if hit else "misses"].inc()


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's standard install location."""
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nnstreamer_tpu_torch: nvcc not found (set CUDA_HOME or put the "
        "CUDA toolkit's bin directory on PATH) — the CUDA kernels are "
        "built from source at first use")


def sources() -> List[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for p in [SRC_DIR / f"{name}.cu"] + sorted(SRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}-{_digest(name)}.so"


def _start(name: str, nvcc: str):
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, cmd


def build_all(names: Optional[List[str]] = None) -> Dict[str, Path]:
    """Compile every kernel source not yet in the build directory, one
    ``nvcc`` process per source, all started together. Raises with the
    compiler's output when a build fails."""
    names = sources() if names is None else list(names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "build.lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            todo = [n for n in names if not library_path(n).exists()]
            for n in names:
                if n not in todo:
                    build_log.setdefault(n, {"seconds": 0.0, "output": ""})
                    _count(n, hit=True)
            if todo:
                nvcc = find_nvcc()
                t0 = time.monotonic()
                running = {n: _start(n, nvcc) for n in todo}
                failed = []
                for n, (proc, tmp, out, cmd) in running.items():
                    text, _ = proc.communicate()
                    build_log[n] = {"seconds": time.monotonic() - t0,
                                    "output": text}
                    if proc.returncode != 0:
                        failed.append(f"$ {' '.join(cmd)}\n{text}")
                        tmp.unlink(missing_ok=True)
                    else:
                        os.replace(tmp, out)
                        _count(n, hit=False)
                if failed:
                    raise RuntimeError(
                        "nnstreamer_tpu_torch: kernel build failed:\n"
                        + "\n".join(failed))
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)
    return {n: library_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def call_on_stream(fn, device: torch.device, *args) -> int:
    """``fn(*args, stream)`` with the current stream of ``device``, which
    is made the current device only when it is not already (the kernels
    launch on the calling thread's current device). The raw stream handle
    comes from the call Triton's launcher uses, without building a
    ``torch.cuda.Stream`` on every launch."""
    index = device.index
    if index == torch._C._cuda_getDevice():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(device):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
