"""The port's multi-host bootstrap (parallel/multihost.py) against the JAX
package's: the single-process cases of
tests/test_models_parallel.py::TestMultihost, case for case, and one run
of two processes joined over gloo on the CPU, whose ``dp`` train step
(one process a dp rank, the gradients averaged by one all-reduce) leaves
the parameters the one-process dp2 step leaves (rtol 1e-5, atol 1e-7).

The two-process test takes a free port from the OS, gives each child
120 s and kills both when either fails, so it never hangs the suite.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.parallel import multihost as jmultihost
from nnstreamer_tpu_torch.models import transformer as ttr
from nnstreamer_tpu_torch.parallel import make_mesh, multihost
from nnstreamer_tpu_torch.parallel.mesh import P, ShardedTensor
from nnstreamer_tpu_torch.parallel.sharded import (
    make_train_step,
    shard_params,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENV_VARS = ("NNSTPU_COORDINATOR", "NNSTPU_NUM_PROCESSES", "NNSTPU_PROCESS_ID",
            "JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT")
CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
BATCH, SEQ, LR = 4, 16, 1e-2
CHILD_TIMEOUT = 120


@pytest.fixture(autouse=True)
def host_mesh():
    tnt.set_device("cpu")
    tnt.set_host_device_count(8)
    yield
    tnt.set_host_device_count(1)
    tnt.set_device(None)


class TestMultihost:
    def test_initialize_noop_single_process(self, monkeypatch):
        for var in ENV_VARS:
            monkeypatch.delenv(var, raising=False)
        assert multihost.initialize() is False
        assert multihost.process_info() == (0, 1)
        assert jmultihost.initialize() is False
        assert jmultihost.process_info() == (0, 1)

    def test_one_process_in_the_environment_is_a_noop(self, monkeypatch):
        monkeypatch.setenv("NNSTPU_COORDINATOR", "127.0.0.1:1")
        monkeypatch.setenv("NNSTPU_NUM_PROCESSES", "1")
        monkeypatch.setenv("NNSTPU_PROCESS_ID", "0")
        assert multihost.initialize() is False
        assert multihost.process_info() == (0, 1)

    def test_global_mesh_wildcard(self):
        mesh = multihost.global_mesh([("dp", -1), ("tp", 2)])
        jmesh = jmultihost.global_mesh([("dp", -1), ("tp", 2)])
        assert mesh.shape == dict(jmesh.shape) == {"dp": 4, "tp": 2}

    @pytest.mark.parametrize("axes", [[("dp", -1), ("tp", 3)],
                                      [("dp", -1), ("tp", -1)]])
    def test_global_mesh_indivisible(self, axes):
        with pytest.raises(ValueError) as ours:
            multihost.global_mesh(axes)
        with pytest.raises(ValueError) as theirs:
            jmultihost.global_mesh(axes)
        assert str(ours.value) == str(theirs.value)

    def test_local_batch_slice(self):
        assert multihost.local_batch_slice(32) == slice(0, 32) == \
            jmultihost.local_batch_slice(32)

    def test_host_local_to_global_roundtrip(self):
        data = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
        arr = multihost.host_local_to_global(
            data, multihost.global_mesh([("dp", -1)]), P("dp"))
        assert isinstance(arr, ShardedTensor)
        assert [tuple(s.data.shape) for s in arr.addressable_shards] == \
            [(1, 3)] * 8
        np.testing.assert_array_equal(arr.gather().numpy(), data)
        jarr = jmultihost.host_local_to_global(
            data, jmultihost.global_mesh([("dp", -1)]), JP("dp"))
        assert isinstance(jarr, jax.Array)
        np.testing.assert_array_equal(np.asarray(jarr), data)


# -- two processes over gloo --------------------------------------------------
CHILD = r"""
import json, sys
import numpy as np, torch
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu_torch.models import transformer as ttr
from nnstreamer_tpu_torch.parallel import multihost
from nnstreamer_tpu_torch.parallel.sharded import make_train_step, shard_params

cfg_kw, batch, seq, lr, out = json.loads(sys.argv[1])
tnt.set_device("cpu")
joined = multihost.initialize()
rank, world = multihost.process_info()
rows = multihost.local_batch_slice(batch)
cfg = ttr.TransformerConfig(**cfg_kw, dtype=torch.float32)
mesh = multihost.global_mesh([("dp", -1)])
tokens = torch.from_numpy(np.random.default_rng(0).integers(
    0, cfg.vocab, (batch, seq)).astype(np.int32))
params = shard_params(ttr.init_params(cfg, seed=5), mesh, cfg)
params, loss = make_train_step(cfg, mesh, learning_rate=lr)(
    params, tokens[rows])
np.savez(out, **{k: v.gather().numpy() for k, v in params.items()})
print(json.dumps({"joined": joined, "rank": rank, "world": world,
                  "rows": [rows.start, rows.stop], "mesh": mesh.shape,
                  "loss": float(loss)}), flush=True)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_step_as_one_dp2_process(tmp_path):
    port = _free_port()
    procs = []
    try:
        for i in range(2):
            env = dict(os.environ, NNSTPU_COORDINATOR=f"127.0.0.1:{port}",
                       NNSTPU_NUM_PROCESSES="2", NNSTPU_PROCESS_ID=str(i),
                       NNSTPU_TORCH_DEVICE="cpu", PYTHONPATH=str(ROOT))
            arg = json.dumps([CFG, BATCH, SEQ, LR, str(tmp_path / f"p{i}.npz")])
            procs.append(subprocess.Popen(
                [sys.executable, "-c", CHILD, arg], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for i, o in enumerate(outs):
        assert o["joined"] is True
        assert (o["rank"], o["world"]) == (i, 2)
        assert o["rows"] == [i * BATCH // 2, (i + 1) * BATCH // 2]
        assert o["mesh"] == {"dp": 1}
    assert outs[0]["loss"] == outs[1]["loss"]

    cfg = ttr.TransformerConfig(**CFG, dtype=torch.float32)
    mesh = make_mesh([("dp", 2)])
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (BATCH, SEQ)).astype(np.int32))
    params = shard_params(ttr.init_params(cfg, seed=5), mesh, cfg)
    params, loss = make_train_step(cfg, mesh, learning_rate=LR)(params,
                                                                tokens)
    np.testing.assert_allclose(outs[0]["loss"], float(loss), rtol=1e-5)
    for i in range(2):
        got = np.load(tmp_path / f"p{i}.npz")
        for k, v in params.items():
            np.testing.assert_allclose(got[k], v.gather().numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
