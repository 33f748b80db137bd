"""The port's repo loop (``elements/repo.py``): ``tensor_reposrc`` →
``tensor_filter`` → ``tee`` → ``tensor_reposink``, bench.py's ``lstm``
string, held to a direct loop of the same module and to the JAX package's
loop with the same weights (atol 1e-6, float32 on the CPU); the starved
slot's ``FlowError``; ``snapshot``/``restore``; and a ``stop()`` while the
source waits on its slot. ``gpu``-marked tests at the end run the loop on
the card: the state never crosses to the host between steps, and a fused
region in the loop captures once and gives the eager steps' state.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.elements.repo import GLOBAL_REPO as JAX_REPO
from nnstreamer_tpu.filters.jax_backend import (
    register_jax_model,
    unregister_jax_model,
)
from nnstreamer_tpu.models.lstm import lstm_cell as jax_lstm_cell
from nnstreamer_tpu_torch.elements.repo import GLOBAL_REPO, TensorRepo
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.models.lstm import (
    LSTMCellModel,
    lstm_cell,
    params_from_jax,
)
from nnstreamer_tpu_torch.pipeline.element import FlowError
from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer, transfer_snapshot

HIDDEN = 8
STEPS = 12


class LSTMStep(torch.nn.Module):
    """bench.py's ``step``: the state ``[2·hidden]`` is ``[h, c]``; the
    cell feeds itself (x = h)."""

    def __init__(self, cell: LSTMCellModel):
        super().__init__()
        self.cell = cell
        self.hidden = cell.hidden

    def forward(self, state):
        s = state.reshape(1, 2 * self.hidden).float()
        h, c = s[:, :self.hidden], s[:, self.hidden:]
        _, h2, c2 = self.cell(h, h, c)
        return torch.cat([h2, c2], dim=1).reshape(2 * self.hidden)


def loop_desc(model, slot, num, extra=""):
    """bench.py's measure_lstm string; ``extra`` goes before the filter."""
    return (f"tensor_reposrc slot={slot} num-buffers={num} "
            f"initial-dim={2 * HIDDEN} initial-type=float32 "
            "initial-value=0.01 timeout=30 ! " + extra +
            f"tensor_filter framework=jax model={model} name=filter ! "
            f"tee name=t  t. ! tensor_reposink slot={slot}  "
            "t. ! tensor_sink name=sink to-host=false")


@pytest.fixture
def weights():
    apply_fn, variables, _, _ = jax_lstm_cell(input_dim=HIDDEN,
                                              hidden=HIDDEN, batch=1, seed=3)
    cell = LSTMCellModel(input_dim=HIDDEN, hidden=HIDDEN)
    cell.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                      variables)))
    return apply_fn, variables, LSTMStep(cell.eval())


@pytest.fixture
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


def _direct(step, n, device="cpu"):
    state = torch.full((2 * HIDDEN,), 0.01, device=device)
    with torch.inference_mode():
        for _ in range(n):
            state = step(state)
    return state.cpu()


def _jax_loop(apply_fn, variables, n):
    def step(p, state):
        s = state.reshape(1, 2 * HIDDEN).astype(jnp.float32)
        h, c = s[:, :HIDDEN], s[:, HIDDEN:]
        _, h2, c2 = apply_fn(p, h, h, c)
        return jnp.concatenate([h2, c2], axis=1).reshape(2 * HIDDEN)

    register_jax_model("lstm_repo_jax", step, variables)
    try:
        JAX_REPO.remove("lstm_repo")
        msg = jnt.parse_launch(loop_desc("lstm_repo_jax", "lstm_repo",
                                         n)).run(timeout=120)
        assert msg is not None and msg.kind == "eos", msg
        return np.asarray(JAX_REPO.get("lstm_repo").tensors[0])
    finally:
        unregister_jax_model("lstm_repo_jax")
        JAX_REPO.remove("lstm_repo")


def _port_loop(step, n, slot, extra="", fuse=True, name="lstm_port"):
    register_torch_model("lstm_repo_port", step)
    GLOBAL_REPO.remove(slot)
    try:
        pipe = tnt.parse_launch(loop_desc("lstm_repo_port", slot, n, extra),
                                pipeline=Pipeline(fuse=fuse, name=name))
        msg = pipe.run(timeout=120)
        assert msg is not None and msg.kind == "eos", msg
        return pipe, GLOBAL_REPO.get(slot)
    finally:
        unregister_torch_model("lstm_repo_port")


def test_lstm_loop_matches_direct_loop_and_jax(cpu_device, weights):
    apply_fn, variables, step = weights
    pipe, final = _port_loop(step, STEPS, "lstm_cpu")
    GLOBAL_REPO.remove("lstm_cpu")
    assert len(pipe.get("sink").buffers) == STEPS
    (state,) = final.tensors
    assert isinstance(state, torch.Tensor)  # the slot keeps the tensor
    np.testing.assert_allclose(state.numpy(), _direct(step, STEPS).numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(state.numpy(),
                               _jax_loop(apply_fn, variables, STEPS),
                               atol=1e-6)


def test_starved_slot_raises_flow_error(cpu_device):
    pipe = tnt.parse_launch(
        "tensor_reposrc slot=starved num-buffers=3 initial-dim=4 "
        "timeout=0.2 ! tensor_sink name=sink")
    GLOBAL_REPO.remove("starved")
    with pytest.raises(FlowError, match="starved after 1/3"):
        pipe.run(timeout=30)
    assert len(pipe.get("sink").buffers) == 1


def test_stop_mid_wait_ends_with_eos(cpu_device):
    """An endless loop whose slot never fills: stop() while the source
    waits ends its thread at once, with EOS, not an error."""
    GLOBAL_REPO.remove("idle")
    pipe = tnt.parse_launch(
        "tensor_reposrc slot=idle initial-dim=4 timeout=30 ! "
        "tensor_sink name=sink")
    pipe.start()
    deadline = time.monotonic() + 10
    while not pipe.get("sink").buffers and time.monotonic() < deadline:
        time.sleep(0.01)
    t0 = time.monotonic()
    pipe.stop()
    assert time.monotonic() - t0 < 5
    kinds = []
    while (msg := pipe.pop_message(timeout=0.5)) is not None:
        kinds.append(msg.kind)
    assert kinds == ["eos"]
    assert len(pipe.get("sink").buffers) == 1


def test_restarted_loop_runs_again_from_the_initial_frame(cpu_device,
                                                        weights):
    """``tensor_reposrc`` resets its count on a restart, as videotestsrc
    does: the restarted loop runs its num-buffers from the initial frame
    again (ROADMAP queue C.20: the JAX source keeps its count)."""
    _, _, step = weights
    register_torch_model("lstm_restart", step)
    GLOBAL_REPO.remove("lstm_restart")
    try:
        pipe = tnt.parse_launch(loop_desc("lstm_restart", "lstm_restart", 5))
        states = []
        for _ in range(2):
            msg = pipe.run(timeout=60)
            assert msg is not None and msg.kind == "eos", msg
            states.append(GLOBAL_REPO.get("lstm_restart", consume=True))
    finally:
        unregister_torch_model("lstm_restart")
    assert len(pipe.get("sink").buffers) == 10
    assert torch.equal(states[0].tensors[0], states[1].tensors[0])
    assert torch.equal(states[0].tensors[0], _direct(step, 5))


def test_snapshot_restore_round_trip():
    repo = TensorRepo()
    repo.set("a", TensorBuffer([torch.arange(4.0), np.ones(3, np.int32)]))
    repo.set("b", TensorBuffer([torch.ones(2, dtype=torch.bfloat16)]))
    snap = repo.snapshot()
    assert isinstance(snap["a"][0], np.ndarray)
    other = TensorRepo()
    other.restore(snap)
    np.testing.assert_array_equal(other.get("a").tensors[0], np.arange(4.0))
    np.testing.assert_array_equal(other.get("a").tensors[1], np.ones(3))
    assert torch.equal(other.get("b").tensors[0],
                       torch.ones(2, dtype=torch.bfloat16))
    assert other.get("c", timeout=0.01) is None
    assert other.get("a", consume=True) is not None
    assert other.peek("a") is None and other.remove("b")


def test_repo_loop_matches_with_a_fused_region(cpu_device, weights):
    """A transform before the filter makes the loop's transform ! filter a
    fused region: the first frame is a host array, every later one the
    slot's tensor, and the state is the unfused loop's."""
    _, _, step = weights
    extra = "tensor_transform mode=typecast option=float32 ! "
    pipe, fused = _port_loop(step, STEPS, "lstm_region", extra,
                             name="lstm_region_f")
    (region,) = pipe._regions
    assert not region._dead and region.eager_frames == STEPS
    _, plain = _port_loop(step, STEPS, "lstm_region", extra, fuse=False,
                          name="lstm_region_u")
    GLOBAL_REPO.remove("lstm_region")
    assert torch.equal(fused.tensors[0], plain.tensors[0])


# -- on the card ---------------------------------------------------------------
@pytest.fixture
def card_step():
    """The port's own seeded cell (the card's machine has no JAX)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the loop state lives on the card")
    tnt.set_device(None)
    cell, _, _ = lstm_cell(input_dim=HIDDEN, hidden=HIDDEN, seed=3)
    return LSTMStep(cell)


@pytest.mark.gpu
def test_lstm_loop_state_stays_on_the_card(card_step):
    step = card_step
    n = 64
    x0 = transfer_snapshot()
    pipe, final = _port_loop(step, n, "lstm_card", name="lstm_card")
    x1 = transfer_snapshot()
    GLOBAL_REPO.remove("lstm_card")
    assert not pipe._regions  # a lone filter between a source and a tee
    (state,) = final.tensors
    assert state.device.type == "cuda"
    assert x1["d2h_events"] == x0["d2h_events"]
    assert x1["h2d_events"] - x0["h2d_events"] <= 1  # the initial frame
    assert torch.equal(state.cpu(), _direct(step.cuda(), n, "cuda"))


@pytest.mark.gpu
def test_fused_loop_captures_once_on_the_card(card_step):
    step = card_step
    n = 64
    extra = "tensor_transform mode=typecast option=float32 ! "
    pipe, final = _port_loop(step, n, "lstm_card_f", extra,
                             name="lstm_card_f")
    GLOBAL_REPO.remove("lstm_card_f")
    (region,) = pipe._regions
    assert region.captures == 1 and region.eager_frames == 1
    assert region.replays == n - 1
    (state,) = final.tensors
    assert torch.equal(state.cpu(), _direct(step.cuda(), n, "cuda"))
