"""A run of the harness on the CPU at a small size, the look for a card
skipped: a sound run comes out correct, and a run with the timed path
broken underneath comes out not correct, once for each fault a cell can
have (an answer altered where it is produced; half of a window left
out). Besides: the run's module set, and the run's refusal without a
card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from h100bench import cells, run
from h100bench.conftest import PAIRS, tiny_cell

SEED = 2 ** 31 + 1234


class _Broken(torch.nn.Module):
    """The served module with ``fault`` applied to its outputs."""

    def __init__(self, inner, fault):
        super().__init__()
        self.inner = inner
        self.fault = fault

    def forward(self, x):
        return self.fault(self.inner(x))


def _alter_label(out):
    out = out.clone()
    out[0] = out[0].roll(1)
    return out


def _half_window(out):
    out = out.clone()
    half = out.shape[0] // 2
    out[half:] = out[:half]
    return out


def _shift_boxes(outs):
    enc, logits = outs
    enc = enc.clone()
    enc[..., 0] += 1.0
    return enc, logits


def _break(cell, monkeypatch, fault):
    """Serve ``cell``'s module with ``fault`` applied to its outputs."""
    build = cell.config.program.module
    monkeypatch.setattr(cell.config.program, "module",
                        lambda *a: _Broken(build(*a), fault))


def _run(cell, monkeypatch=None, fault=None, seconds=1.0):
    if fault is not None:
        _break(cell, monkeypatch, fault)
    return run.run_cell(cell, SEED, seconds, False, device="cpu")


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_a_sound_run_is_correct(name, cpu_device):
    cell = tiny_cell(*PAIRS[name])
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["info"]["frames_out"] > 0
    assert set(out["checks"]) >= set(cell.config.reference.NUMBERS)


@pytest.mark.parametrize("name,fault", [
    ("mnv2.b8_saturated", _alter_label),
    ("mnv2.b8_saturated", _half_window),
    ("mnv2.b1_saturated", _alter_label),
    ("ssd.b1_saturated", _shift_boxes),
    ("ssd.b1_rate80", _shift_boxes),
])
def test_a_broken_timed_path_is_not_correct(name, fault, cpu_device,
                                            monkeypatch):
    out = _run(tiny_cell(*PAIRS[name]), monkeypatch, fault)
    assert not out["correct"], out["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("name,fault", [
    ("mnv2.b8_saturated", _alter_label),
    ("mnv2.b8_saturated", _half_window),
    ("mnv2.b1_saturated", _alter_label),
])
def test_a_broken_timed_path_is_not_correct_on_the_card(name, fault,
                                                        monkeypatch):
    """The cell as committed (its size, batch and load), on three seeds:
    each run's compared numbers are printed beside their limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run.fix_caches()
    cell = cells.find_cell(name)
    _break(cell, monkeypatch, fault)
    for seed in (2 ** 31 + 601, 2 ** 31 + 602, 2 ** 31 + 603):
        out = run.run_cell(cell, seed, 2.0, False)
        print("fault reading " + json.dumps({
            "cell": name, "fault": fault.__name__, "seed": seed,
            "frames_out": out["info"]["frames_out"],
            "checks": out["checks"]}), flush=True)
        assert not out["correct"], out["checks"]


def test_two_branches_of_one_launch_string_are_fed_and_judged(cpu_device):
    """A mix whose launch string holds two sources, each with its sink:
    both are fed, every answer of both is judged."""
    base = cells.load_traffic("saturated_b1_flagship")["launch"]
    launch = " ".join(base.replace("name=src", f"name=src{i}").replace(
        "name=sink", f"name=sink{i}") for i in (0, 1))
    cell = tiny_cell("mobilenet_v2_224", "saturated_b1_flagship",
                     launch=launch)
    out = _run(cell)
    assert out["correct"], out["checks"]
    one = _run(tiny_cell("mobilenet_v2_224", "saturated_b1_flagship"))
    assert out["attempted"] > 0 and one["attempted"] > 0
    broken = tiny_cell("mobilenet_v2_224", "saturated_b1_flagship",
                       launch=launch.replace("name=sink1", "name=sink9"))
    with pytest.raises(KeyError):
        _run(broken)


def test_a_run_reports_each_metric_of_its_cell(cpu_device):
    cell = tiny_cell(*PAIRS["mnv2.b8_saturated"])
    cell.end_to_end = cells.find_cell("mnv2.b8_saturated").end_to_end
    out = _run(cell)
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    assert out["device"]["platform"] == "cpu"
    assert list(out)[-1] == "checks"


def test_a_traced_run_reports_the_ledgers_metrics(cpu_device):
    cell = tiny_cell(*PAIRS["mnv2.b8_saturated"])
    cell.per_layer = [m for m in cells.find_cell("mnv2.b8_saturated")
                      .per_layer if m["source"] == "program_span"]
    assert {m["name"] for m in cell.per_layer} == {"queue_wait_ms",
                                                   "d2h_ms"}
    out = run.run_cell(cell, SEED, 1.0, True, device="cpu")
    assert set(out["metrics"]) == {"queue_wait_ms", "d2h_ms"}


def test_an_open_loop_times_each_frame_from_its_due_time(cpu_device):
    out = _run(tiny_cell(*PAIRS["ssd.b1_rate80"]))
    assert out["metrics"]["latency_p95_ms"]["value"] >= \
        out["metrics"]["latency_p50_ms"]["value"] > 0
    assert 0 < out["attempted"] and \
        out["info"]["refused_by_appsrc"] <= out["failed"] <= out["attempted"]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "nnstreamer_tpu_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "nnstreamer_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert run.forbidden_modules() == ["jaxlib", "nnstreamer_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, json\n"
        "from h100bench import run\n"
        "from h100bench.conftest import PAIRS, tiny_cell\n"
        "import nnstreamer_tpu_torch as nt\n"
        "nt.set_device('cpu')\n"
        "out = run.run_cell(tiny_cell('mobilenet_v2_224', 'saturated_b8'),"
        " 5, 0.5, True, device='cpu')\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    done = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert json.loads(done.stdout.strip().splitlines()[-1]) == []


def test_without_a_card_a_run_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    done = subprocess.run(
        [sys.executable, "-m", "h100bench.run", "--workload",
         "mnv2.b8_saturated", "--seed", "3", "--seconds", "1", "--trace",
         "0"], cwd=cells.ROOT, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0
    assert done.stdout.strip() == ""
