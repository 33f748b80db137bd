"""Checkpoint / resume for stateful streams and models.

Port of ``nnstreamer_tpu/utils/checkpoint.py``:

- :func:`save_params` / :func:`load_params` — model weights as a
  ``torch.save`` of host tensors (a state dict, or any nest of tensors);
  ``load_params`` maps them onto a device, and with a template module
  loads them into it;
- :func:`save_stream_state` / :func:`restore_stream_state` — snapshot of
  the global ``tensor_repo`` (recurrent hidden state) as host arrays, so
  an RNN/LSTM pipeline resumes exactly where it stopped; a state written
  on the card restores on the CPU and the other way round;
- :class:`StepCheckpointer` — versioned step checkpoints (the JAX
  package's ``OrbaxCheckpointer``, without orbax): one ``step_<n>``
  directory a step, the oldest removed beyond ``max_to_keep``.
"""

from __future__ import annotations

import os
import pickle
import re
import shutil
from typing import Any, Dict, List, Optional

import torch


def _to_host(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def save_params(params: Any, path: str) -> None:
    """Write ``params`` (a state dict, a module's weights, or a nest of
    tensors) as host tensors with ``torch.save`` (atomic publish)."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    tmp = path + ".tmp"
    torch.save(_to_host(params), tmp)
    os.replace(tmp, path)


def load_params(params_template: Any, path: str,
                device: Optional[torch.device] = None) -> Any:
    """Read weights written by :func:`save_params` onto ``device`` (the
    CPU when None). A module template gets them loaded in place and is
    returned; otherwise the loaded nest is returned."""
    state = torch.load(path, map_location=device or "cpu",
                       weights_only=True)
    if isinstance(params_template, torch.nn.Module):
        params_template.load_state_dict(state)
        return params_template
    return state


def save_stream_state(path: str, repo=None, extra: Optional[Dict] = None
                      ) -> None:
    """Snapshot repo slots (+ anything in ``extra``) to disk. Device
    tensors come back to the host first: the pickle holds none."""
    from nnstreamer_tpu_torch.elements.repo import GLOBAL_REPO

    repo = repo if repo is not None else GLOBAL_REPO
    state = {"repo": repo.snapshot(), "extra": extra or {}}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)  # atomic publish


def restore_stream_state(path: str, repo=None,
                         device: Optional[torch.device] = None) -> Dict:
    """Put a :func:`save_stream_state` snapshot back into the repo (as
    host arrays, or as tensors on ``device``); returns its ``extra``."""
    from nnstreamer_tpu_torch.elements.repo import GLOBAL_REPO

    repo = repo if repo is not None else GLOBAL_REPO
    with open(path, "rb") as f:
        state = pickle.load(f)
    repo.restore(state["repo"], device=device)
    return state.get("extra", {})


class StepCheckpointer:
    """Versioned step checkpoints: ``<directory>/step_<n>/state.pt`` (a
    ``torch.save`` of host tensors), keeping the newest ``max_to_keep``."""

    _STEP = re.compile(r"^step_(\d+)$")

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError("StepCheckpointer: max_to_keep must be >= 1")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}")

    def steps(self) -> List[int]:
        """Saved steps, oldest first."""
        out = []
        for name in os.listdir(self.directory):
            m = self._STEP.match(name)
            if m and os.path.isfile(os.path.join(self.directory, name,
                                                 "state.pt")):
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, step: int, state: Any) -> None:
        d = self._path(step)
        os.makedirs(d, exist_ok=True)
        save_params(state, os.path.join(d, "state.pt"))
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self._path(old), ignore_errors=True)

    def restore(self, step: Optional[int] = None,
                template: Optional[Any] = None,
                device: Optional[torch.device] = None) -> Any:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(
                f"StepCheckpointer: no checkpoint in {self.directory}")
        return load_params(template, os.path.join(self._path(step),
                                                  "state.pt"), device)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None
