"""Checkpoints of the PyTorch port (``nnstreamer_tpu_torch/utils/
checkpoint.py``): weights as a ``torch.save`` of host tensors, stream
state as host arrays, and versioned step directories
(``StepCheckpointer``, the JAX package's ``OrbaxCheckpointer`` without
orbax). The stream-state file of a repo loop equals the JAX package's
for the same slot contents (arrays bit for bit).
"""

import os
import pickle

import numpy as np
import pytest
import torch

from nnstreamer_tpu.elements.repo import TensorRepo as JaxRepo
from nnstreamer_tpu.tensors.buffer import TensorBuffer as JaxBuffer
from nnstreamer_tpu.utils import checkpoint as jcheckpoint
from nnstreamer_tpu_torch.elements.repo import TensorRepo
from nnstreamer_tpu_torch.models.mobilenet_v2 import mobilenet_v2
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer
from nnstreamer_tpu_torch.utils import checkpoint


def test_params_round_trip_into_a_module(tmp_path):
    src, _, _ = mobilenet_v2(num_classes=10, image_size=32,
                             dtype=torch.float32, seed=5)
    path = str(tmp_path / "w.pt")
    checkpoint.save_params(src, path)
    dst, _, _ = mobilenet_v2(num_classes=10, image_size=32,
                             dtype=torch.float32, seed=6)
    assert checkpoint.load_params(dst, path) is dst
    for (ka, a), (kb, b) in zip(src.state_dict().items(),
                                dst.state_dict().items()):
        assert ka == kb and torch.equal(a, b)


def test_params_of_a_nest_load_on_a_device(tmp_path):
    path = str(tmp_path / "nest.pt")
    checkpoint.save_params({"a": torch.arange(3), "b": [torch.ones(2)]},
                           path)
    got = checkpoint.load_params(None, path, device=torch.device("cpu"))
    assert torch.equal(got["a"], torch.arange(3))
    assert got["b"][0].device.type == "cpu"


def _fill(repo, buf_cls, tensors):
    repo.set("7", buf_cls([t for t in tensors]))


def test_stream_state_equals_the_jax_packages(tmp_path):
    arrays = [np.arange(6, dtype=np.float32).reshape(2, 3),
              np.array([3, 1, 4], np.int32)]
    port, ref = TensorRepo(), JaxRepo()
    _fill(port, TensorBuffer, [torch.from_numpy(a.copy()) for a in arrays])
    _fill(ref, JaxBuffer, arrays)
    pp, jp = str(tmp_path / "port.pkl"), str(tmp_path / "jax.pkl")
    checkpoint.save_stream_state(pp, repo=port, extra={"step": 3})
    jcheckpoint.save_stream_state(jp, repo=ref, extra={"step": 3})
    with open(pp, "rb") as f:
        got = pickle.load(f)
    with open(jp, "rb") as f:
        want = pickle.load(f)
    assert got["extra"] == want["extra"]
    for a, b in zip(got["repo"]["7"], want["repo"]["7"]):
        assert isinstance(a, np.ndarray)  # no tensor in the pickle
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("device", [None, "cpu"])
def test_stream_state_restores(tmp_path, device):
    repo = TensorRepo()
    _fill(repo, TensorBuffer, [torch.full((2,), 1.5)])
    path = str(tmp_path / "s.pkl")
    checkpoint.save_stream_state(path, repo=repo, extra={"k": 1})
    fresh = TensorRepo()
    dev = None if device is None else torch.device(device)
    assert checkpoint.restore_stream_state(path, repo=fresh,
                                           device=dev) == {"k": 1}
    (t,) = fresh.peek("7").tensors
    assert isinstance(t, torch.Tensor) == (device is not None)
    np.testing.assert_array_equal(np.asarray(t), np.full(2, 1.5))


def test_step_checkpointer_keeps_the_newest(tmp_path):
    ck = checkpoint.StepCheckpointer(str(tmp_path / "steps"), max_to_keep=2)
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore()
    for step in (1, 5, 9):
        ck.save(step, {"w": torch.full((2,), float(step))})
    assert ck.steps() == [5, 9] and ck.latest_step() == 9
    assert not os.path.exists(os.path.join(ck.directory, "step_1"))
    assert float(ck.restore()["w"][0]) == 9.0
    assert float(ck.restore(step=5)["w"][0]) == 5.0
    with pytest.raises(ValueError):
        checkpoint.StepCheckpointer(str(tmp_path / "x"), max_to_keep=0)
