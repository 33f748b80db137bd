"""Checkpoint / resume for stateful streams and models.

Port of ``nnstreamer_tpu/utils/checkpoint.py``:

- :func:`save_params` / :func:`load_params` — model weights as a
  ``torch.save`` of host tensors (a state dict, or any nest of tensors);
  ``load_params`` maps them onto a device, and with a template module
  loads them into it. A ``.msgpack`` path is the JAX package's format
  (``flax.serialization``, through ``utils/flax_msgpack``): what
  ``tensor_filter model=x.msgpack custom=module:<factory>`` loads;
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


def _is_msgpack(path: str) -> bool:
    return str(path).lower().endswith(".msgpack")


def save_params(params: Any, path: str) -> None:
    """Write ``params`` (a state dict, a module's weights, or a nest of
    tensors) as host tensors with ``torch.save`` (atomic publish). To a
    ``.msgpack`` path the tree is written as ``flax.serialization.
    to_bytes`` writes it (numpy or tensor leaves), for the JAX package's
    ``load_params``; a zoo model's ``params_to_jax`` gives its tree."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    tmp = path + ".tmp"
    if _is_msgpack(path):
        from nnstreamer_tpu_torch.utils.flax_msgpack import to_bytes

        with open(tmp, "wb") as f:
            f.write(to_bytes(params))
    else:
        torch.save(_to_host(params), tmp)
    os.replace(tmp, path)


def _restore(template: Any, state: Any, path: str = "") -> Any:
    """``flax.serialization.from_state_dict``: ``state`` in the structure
    of ``template`` (dicts, lists, tuples); the file's leaves win, shapes
    included."""
    if isinstance(template, dict):
        missing = sorted(set(map(str, template)) - set(state))
        if missing:
            raise ValueError(
                "The target dict keys and state dict keys do not match, "
                f"target dict contains keys {missing} which are not present "
                f"in state dict at path {path or '/'}")
        return {k: _restore(v, state[str(k)], f"{path}/{k}")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        items = [_restore(v, state[str(i)], f"{path}/{i}")
                 for i, v in enumerate(template)]
        return type(template)(items) if isinstance(template, list) \
            else tuple(items)
    return state


def load_params(params_template: Any, path: str,
                device: Optional[torch.device] = None) -> Any:
    """Read weights written by :func:`save_params` onto ``device`` (the
    CPU when None). A module template gets them loaded in place and is
    returned; otherwise the loaded nest is returned.

    A ``.msgpack`` path reads the JAX package's file (``flax.
    serialization.from_bytes``): the tree in ``params_template``'s
    structure (or the whole tree for None), leaves as numpy arrays
    (``bfloat16`` ones as ``torch.bfloat16`` tensors), the file's shapes
    winning, as ``from_bytes`` gives them."""
    if _is_msgpack(path):
        from nnstreamer_tpu_torch.utils.flax_msgpack import from_bytes

        with open(path, "rb") as f:
            tree = from_bytes(f.read())
        return tree if params_template is None else \
            _restore(params_template, tree)
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
