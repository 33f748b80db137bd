"""Serving continuity — the lifetime-boundary resilience layer.

Port of ``nnstreamer_tpu/pipeline/continuity.py``. Three legs, each with
an exact kill switch:

- **Epoch-based live reconfiguration** (:func:`swap_model`).
  ``Pipeline.swap_model(filter_name, model=..., weights=...)`` promotes
  the per-filter ``reload_model`` event to a pipeline-level *versioned*
  swap: the owning dispatch window drains (the fence is the cutover
  point — every in-flight batch completes against the old epoch), the
  new backend or weights install under a bumped epoch, the owning fused
  region is touched exactly once (``report["invalidations"] == 1``), and
  the next frame serves the new model. Nothing is removed from the
  stream, so output is byte-identical up to the cutover.

  On the card a region replays CUDA graphs that read the weights at the
  addresses captured. A weights-only swap (``weights=``, a state dict)
  copies the new values into the existing parameters on the current
  stream (``TorchFilter.install_weights``) and only *rebuilds* the region
  (:meth:`FusedRegion.rebuild`): the stage keys and storage pins are
  unchanged, so the graphs replay the new weights and ``captures`` does
  not move. A swap that changes a shape or a dtype rebinds that tensor
  and the region captures once; a model swap (``model=``) reopens the
  backend and invalidates the region, which captures once.

- **Checkpoint / restore** (:func:`checkpoint` / :func:`restore`).
  Serializes the *durable serving state* a restarted process would
  otherwise re-learn from cold: ``tensor_repo`` slots (recurrent stream
  state, copied to host arrays: the pickle holds no CUDA tensor, so a
  state written on the card restores on the CPU and the other way round;
  ``restore`` puts the slots back on the package device), the SLO
  scheduler's service-rate EWMAs and AIMD knobs, the residency manager's
  LRU order, and the flight recorder's P² quantile markers and
  attribution ring. Armed by ``NNSTPU_CHECKPOINT=<dir>`` /
  ``--checkpoint-dir`` / ``Pipeline.checkpoint_dir``; unset means one env
  read in start/stop. ``"servers"`` holds each live resilient query
  server's dedup windows (packed reply bytes, no tensor). As in the JAX
  package, the hooks in ``Pipeline.start()``/``stop()`` run while the
  serversrc holds no server (restore before the sources start, the
  checkpoint after they stop), so only an explicit ``checkpoint`` of a
  running pipeline carries them (ROADMAP C.43).

- **Persistent compile cache** (:func:`enable_compile_cache`). The port
  has no XLA programs to cache; what a second boot can skip is the
  ``nvcc`` build of each kernel (``ops/_build.py``).
  ``enable_compile_cache(dir)`` points the build directory at
  ``<dir>/kernels``; ``nns_compile_cache_hits_total`` and
  ``nns_compile_cache_misses_total`` count each kernel library found
  built or built anew. A per-fused-region signature manifest
  (``programs.json``) rides in the cache dir. CUDA graphs cannot outlive
  a process: a restored process captures again (ROADMAP queue C).
  ``ops/_build.build_dir()`` alone reads ``NNSTPU_COMPILE_CACHE=<dir>``;
  when no cache is in use, an armed checkpoint dir defaults it into
  ``<dir>/compile-cache`` at ``Pipeline.start()``.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import pickle
import time
from typing import Any, Dict, Optional

from nnstreamer_tpu_torch.log import get_logger
from nnstreamer_tpu_torch.ops import _build
from nnstreamer_tpu_torch.ops._build import CACHE_ENV  # noqa: F401

log = get_logger("continuity")

CHECKPOINT_ENV = "NNSTPU_CHECKPOINT"

#: checkpoint state file name inside the checkpoint dir
STATE_FILE = "serving_state.pkl"
#: fused-region program-signature manifest inside the compile-cache dir
MANIFEST_FILE = "programs.json"
#: default compile-cache subdir when only a checkpoint dir is armed
CACHE_SUBDIR = "compile-cache"
#: the kernel libraries' subdir of a compile-cache dir
KERNELS_SUBDIR = "kernels"

#: state-file schema version — bump on any incompatible change
STATE_VERSION = 1

# --------------------------------------------------------------------------
# persistent compile cache (the kernels' build directory)
# --------------------------------------------------------------------------
def compile_cache_dir() -> Optional[str]:
    """The cache directory the kernels build in (the parent of
    ``ops/_build.build_dir()``), or None while they build in the
    package's own ``_build/``."""
    d = _build.build_dir()
    return None if d == _build.BUILD_DIR else str(d.parent)


def cache_stats() -> Dict[str, int]:
    """Kernel libraries this process found built (hits) or built anew
    (misses)."""
    m = _build.cache_metrics()
    return {"hits": int(m["hits"].value), "misses": int(m["misses"].value)}


def enable_compile_cache(directory: str) -> str:
    """Keep the kernel libraries in ``<directory>/kernels``: a later
    process on the same directory loads them instead of running
    ``nvcc``. Libraries this process already loaded stay loaded."""
    directory = os.path.abspath(directory)
    kernels = os.path.join(directory, KERNELS_SUBDIR)
    os.makedirs(kernels, exist_ok=True)
    _build.set_build_dir(kernels)
    log.info("persistent compile cache at %s", directory)
    return directory


def maybe_default_compile_cache(pipeline=None) -> Optional[str]:
    """``Pipeline.start()`` hook: the compile cache in use, else, when a
    checkpoint dir is armed, its ``compile-cache`` subdir. Neither ⇒
    None."""
    current = compile_cache_dir()
    if current is not None:
        return current
    ckpt = _effective_checkpoint_dir(pipeline)
    if not ckpt:
        return None
    target = os.path.join(ckpt, CACHE_SUBDIR)
    try:
        return enable_compile_cache(target)
    except OSError as e:  # an uncreatable cache dir must not fail start():
        # serving continues cold, which is what an unarmed cache does
        log.warning("compile cache dir %s unusable: %s", target, e)
        return None


def region_signature(region) -> Dict[str, Any]:
    """A stable, auditable signature of one fused region: the member
    lineup plus the model/option properties that decide what it
    computes."""
    members = []
    for m in getattr(region, "members", ()):
        members.append({
            "name": m.name,
            "type": getattr(m, "ELEMENT_NAME", type(m).__name__),
            "model": m._props.get("model"),
            "custom": m._props.get("custom"),
            "option": m._props.get("option"),
        })
    blob = json.dumps(members, sort_keys=True, default=str)
    return {
        "region": getattr(region, "name", "?"),
        "members": members,
        "signature": hashlib.sha256(blob.encode()).hexdigest()[:16],
    }


def write_program_manifest(pipe) -> Optional[str]:
    """Write the per-fused-region signature manifest into the armed cache
    dir. No cache dir or no regions ⇒ None."""
    directory = compile_cache_dir()
    regions = [r for r in (getattr(pipe, "_regions", None) or ())
               if not getattr(r, "_dead", False)]
    if not directory or not regions:
        return None
    os.makedirs(directory, exist_ok=True)
    wall_written = time.time()  # export timestamp, not a duration
    doc = {
        "pipeline": pipe.name,
        "written_at": wall_written,
        "programs": [region_signature(r) for r in regions],
    }
    path = os.path.join(directory, MANIFEST_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)  # atomic publish
    return path


# --------------------------------------------------------------------------
# epoch-based live reconfiguration
# --------------------------------------------------------------------------
_swap_metric = None


def _count_swap() -> None:
    global _swap_metric
    if _swap_metric is None:
        from nnstreamer_tpu_torch.obs import get_registry

        _swap_metric = get_registry().counter(
            "nns_model_swaps_total",
            "Pipeline-level live model swaps (epoch cutovers)")
    _swap_metric.inc()


def swap_model(pipe, filter_name: str, model: Optional[str] = None,
               weights: Any = None) -> Dict[str, Any]:
    """Zero-downtime versioned model swap on a running pipeline.

    Sequence: (1) drain the owning dispatch window — the fence is the
    cutover point; (2) install the new model or weights under a bumped
    epoch (under an HBM budget a weights-only swap registers the new
    epoch's residency unit and retires the old one, so ``used_bytes``
    nets out); (3) touch the owning fused region exactly once: a
    weights-only swap rebuilds it (graphs kept unless a tensor was
    rebound), a model swap invalidates it (one capture). All three run
    under the backend's dispatch lock: the streaming thread finishes the
    dispatch it is in, waits for the swap, and goes on with the new
    weights, so no frame mixes the old and the new, and none is lost.
    """
    if model is None and weights is None:
        raise ValueError("swap_model: need model=, weights=, or both")
    el = pipe.by_name.get(filter_name)
    if el is None:
        raise KeyError(f"swap_model: no element {filter_name!r} in "
                       f"{pipe.name}")
    if not hasattr(el, "fw"):
        raise TypeError(f"swap_model: {filter_name!r} is not a "
                        f"tensor_filter")
    epoch = int(getattr(el, "_swap_epoch", 0)) + 1
    region = getattr(el, "_fused_region", None)
    if region is not None and getattr(region, "_dead", False):
        region = None

    fw = el.fw
    lock = getattr(fw, "dispatch_lock", None)
    with lock if lock is not None else contextlib.nullcontext():
        # 1. fence: every outstanding dispatch against the old epoch
        #    retires before the new one installs — the cutover is between
        #    frames
        window = getattr(region if region is not None else el, "_window",
                         None)
        if window is not None:
            window.drain()

        report: Dict[str, Any] = {
            "filter": filter_name, "epoch": epoch, "model": model,
            "weights": weights is not None, "invalidations": 0,
            "residency_unit": None, "retired_unit": None, "rebound": 0,
        }

        # 2. install under the new epoch
        if model is not None:
            el.reload_model(model)
        if weights is not None:
            if fw is None:
                raise RuntimeError(f"swap_model: {filter_name!r} has no "
                                   f"open backend to install weights into")
            install = getattr(fw, "install_weights", None)
            if install is None:
                raise RuntimeError(
                    f"swap_model: backend {type(fw).__name__} does not "
                    f"support in-place weight swaps")
            res = install(weights, epoch=epoch)
            report["residency_unit"] = res.get("residency")
            report["retired_unit"] = res.get("retired")
            report["rebound"] = int(res.get("rebound", 0))

        # 3. exactly one touch of the fused region (a model reload already
        #    invalidated it)
        if region is not None:
            if model is None:
                region.rebuild()
            elif fw is None:
                region.invalidate()
            report["invalidations"] = 1

    el._swap_epoch = epoch
    _count_swap()
    from nnstreamer_tpu_torch.obs import timeline as _timeline

    tl = _timeline.ACTIVE
    if tl is not None:
        tl.mark("model_swap", None, track="continuity",
                filter=filter_name, epoch=epoch,
                consts_only=(model is None))
    log.info("%s: swapped %s to epoch %d (%s)", pipe.name, filter_name,
             epoch, "weights only" if model is None else model)
    return report


# --------------------------------------------------------------------------
# checkpoint / restore
# --------------------------------------------------------------------------
def _effective_checkpoint_dir(pipe, directory: Optional[str] = None
                              ) -> Optional[str]:
    if directory:
        return directory
    if pipe is not None and getattr(pipe, "checkpoint_dir", None):
        return pipe.checkpoint_dir
    env = os.environ.get(CHECKPOINT_ENV, "").strip()
    return env or None


def _query_servers(pipe):
    """Elements carrying a live query server (tensor_query_serversrc)."""
    out = []
    for el in getattr(pipe, "elements", ()):
        srv = getattr(el, "server", None) or getattr(el, "_server", None)
        if srv is not None and hasattr(srv, "checkpoint_state"):
            out.append((el.name, srv))
    return out


def checkpoint(pipe, directory: Optional[str] = None) -> str:
    """Serialize the pipeline's durable serving state into
    ``<dir>/serving_state.pkl`` (atomic publish) and refresh the
    program-signature manifest. Returns the state-file path."""
    directory = _effective_checkpoint_dir(pipe, directory)
    if not directory:
        raise ValueError(
            "checkpoint: no directory (pass one, set "
            "Pipeline.checkpoint_dir, or export NNSTPU_CHECKPOINT)")
    os.makedirs(directory, exist_ok=True)
    from nnstreamer_tpu_torch.elements.repo import GLOBAL_REPO
    from nnstreamer_tpu_torch.tensors import memory as _memory

    wall_saved = time.time()  # export timestamp, not a duration
    sched = getattr(pipe, "_slo_scheduler", None)
    fr = getattr(pipe, "_flight", None)
    acct = _memory.ACTIVE
    state: Dict[str, Any] = {
        "version": STATE_VERSION,
        "pipeline": pipe.name,
        "wall_saved": wall_saved,
        "repo": GLOBAL_REPO.snapshot(),
        "scheduler": sched.checkpoint_state() if sched is not None
        else None,
        "flight": fr.checkpoint_state() if fr is not None else None,
        "residency": acct.residency.checkpoint_state()
        if acct is not None else None,
        "servers": {name: srv.checkpoint_state()
                    for name, srv in _query_servers(pipe)},
        "swap_epochs": {el.name: int(el._swap_epoch)
                        for el in pipe.elements
                        if getattr(el, "_swap_epoch", 0)},
        "compile_cache_dir": compile_cache_dir(),
    }
    path = os.path.join(directory, STATE_FILE)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)  # atomic publish — a killed writer leaves the
    # previous checkpoint intact, never a torn one
    write_program_manifest(pipe)
    log.info("%s: checkpoint written to %s", pipe.name, path)
    return path


def restore(pipe, directory: Optional[str] = None) -> Dict[str, Any]:
    """Load ``<dir>/serving_state.pkl`` and re-arm the warm serving
    state: repo slots (on the package device), scheduler estimates and
    knobs, residency LRU order, flight-recorder quantiles, query-server
    dedup windows, swap epochs, and the compile cache. Returns a summary of what was applied."""
    directory = _effective_checkpoint_dir(pipe, directory)
    if not directory:
        raise ValueError(
            "restore: no directory (pass one, set "
            "Pipeline.checkpoint_dir, or export NNSTPU_CHECKPOINT)")
    path = os.path.join(directory, STATE_FILE)
    with open(path, "rb") as f:
        state = pickle.load(f)
    if state.get("version") != STATE_VERSION:
        raise ValueError(
            f"restore: state version {state.get('version')!r} != "
            f"{STATE_VERSION} (checkpoint from an incompatible build)")
    applied: Dict[str, Any] = {"path": path, "pipeline": state["pipeline"]}
    from nnstreamer_tpu_torch.elements.repo import GLOBAL_REPO
    from nnstreamer_tpu_torch.tensors import memory as _memory

    repo_state = state.get("repo")
    if repo_state:
        GLOBAL_REPO.restore(repo_state, device=_restore_device())
        applied["repo_slots"] = len(repo_state)
    sched = getattr(pipe, "_slo_scheduler", None)
    if sched is not None and state.get("scheduler"):
        sched.restore_state(state["scheduler"])
        applied["scheduler"] = True
    fr = getattr(pipe, "_flight", None)
    if fr is not None and state.get("flight"):
        fr.restore_state(state["flight"])
        applied["flight"] = True
    acct = _memory.ACTIVE
    if acct is not None and state.get("residency"):
        acct.residency.restore_state(state["residency"])
        applied["residency"] = True
    servers = dict(_query_servers(pipe))
    for name, srv_state in (state.get("servers") or {}).items():
        srv = servers.get(name)
        if srv is not None:
            srv.restore_state(srv_state)
            applied.setdefault("servers", []).append(name)
    for name, epoch in (state.get("swap_epochs") or {}).items():
        el = pipe.by_name.get(name)
        if el is not None:
            el._swap_epoch = int(epoch)
    cache = state.get("compile_cache_dir")
    if cache and os.path.isdir(cache):
        enable_compile_cache(cache)
        applied["compile_cache_dir"] = cache
    log.info("%s: restored serving state from %s (%s)", pipe.name, path,
             ", ".join(k for k in applied if k not in ("path", "pipeline")))
    return applied


def _restore_device():
    """Where restored repo slots go: the package device when it can hold
    them (a card that is present, or the CPU), else the host."""
    import torch

    from nnstreamer_tpu_torch.device import get_device

    dev = get_device()
    if dev.type == "cuda" and not torch.cuda.is_available():
        return None
    return dev


def maybe_restore_env(pipe) -> Optional[Dict[str, Any]]:
    """``Pipeline.start()`` hook: restore once from an armed checkpoint
    dir whose state file exists. Unset dir ⇒ one env read; armed dir
    with no state file (first boot) ⇒ one ``os.path.isfile``."""
    if getattr(pipe, "_continuity_restored", False):
        return None
    directory = _effective_checkpoint_dir(pipe)
    if not directory:
        return None
    path = os.path.join(directory, STATE_FILE)
    if not os.path.isfile(path):
        return None
    pipe._continuity_restored = True
    return restore(pipe, directory)


def maybe_checkpoint_on_stop(pipe) -> Optional[str]:
    """``Pipeline.stop()`` hook: write a checkpoint when armed. A
    failure to persist never turns a clean shutdown into an error — it
    logs and returns None."""
    directory = _effective_checkpoint_dir(pipe)
    if not directory:
        return None
    try:
        return checkpoint(pipe, directory)
    except Exception as e:  # noqa: BLE001 — a full disk or unpicklable
        # payload must not fail teardown; the previous checkpoint (if
        # any) is still intact thanks to the atomic publish
        log.warning("%s: checkpoint on stop failed: %s", pipe.name, e)
        return None
