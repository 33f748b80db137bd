"""Continuous-batching LM serving.

N generation streams share ONE batched, KV-cached decode loop on the card
(``serving/engine.py``); ``tensor_lm_serve`` reaches an app-constructed
engine by the name it was registered under here. The engine module is
imported lazily: it pulls in the transformer model stack, which a frame
pipeline never needs. ``serving/scheduler.py`` is the SLO scheduler of
pipelines and of the engine's request path (``SloRejected``).
``serving/fleet.py`` launches and supervises replica processes behind one
discovery operation (``FleetLauncher``, imported lazily).
"""

import threading
from typing import Dict

#: name → engine, so pipeline elements (tensor_lm_serve) can reference an
#: app-constructed engine by property — the register_torch_model pattern
_ENGINES: Dict[str, "ContinuousBatchingEngine"] = {}  # noqa: F821
_ENGINES_LOCK = threading.Lock()


def register_engine(name: str, engine) -> None:
    with _ENGINES_LOCK:
        _ENGINES[name] = engine


def get_engine(name: str):
    with _ENGINES_LOCK:
        return _ENGINES.get(name)


def unregister_engine(name: str) -> bool:
    with _ENGINES_LOCK:
        return _ENGINES.pop(name, None) is not None


def __getattr__(name: str):
    # lazy: engine.py pulls the transformer model stack
    if name in ("ContinuousBatchingEngine", "GenerationStream"):
        from nnstreamer_tpu_torch.serving import engine as _engine

        return getattr(_engine, name)
    if name in ("SloRejected", "SloScheduler"):
        from nnstreamer_tpu_torch.serving import scheduler as _scheduler

        return getattr(_scheduler, name)
    if name == "FleetLauncher":
        from nnstreamer_tpu_torch.serving.fleet import FleetLauncher

        return FleetLauncher
    raise AttributeError(name)


__all__ = ["ContinuousBatchingEngine", "GenerationStream", "SloRejected",
           "SloScheduler", "FleetLauncher", "register_engine", "get_engine",
           "unregister_engine"]
