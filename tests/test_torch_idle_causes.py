"""``tools/idle_causes.py``'s probe around a traced run of the benchmark's
batch-8 cell at a small size on the CPU, and its refusal to report where
the harness never called what it patches."""

import os
import sys

import pytest

from h100bench import idle, run
from h100bench.conftest import PAIRS, tiny_cell

sys.path.insert(0, os.path.join(os.path.dirname(run.cells.HERE), "tools"))
try:
    import idle_causes
finally:
    sys.path.pop(0)


@pytest.fixture
def cpu_device():
    import nnstreamer_tpu_torch as nt

    nt.set_device("cpu")
    yield "cpu"
    nt.set_device(None)


def test_the_probe_around_a_cpu_run(cpu_device):
    """The traced batch-8 run at a small size on the CPU, its ledger with
    thread spans: the converter's time and each pipeline thread's CPU are
    read; with no profiler on the CPU, no idle share."""
    from nnstreamer_tpu_torch.obs.timeline import THREAD_KINDS

    cell = tiny_cell(*PAIRS["mnv2.b8_saturated"])
    seed = 2 ** 31 + 77
    model = "h100bench_" + "".join(c if c.isalnum() else "_"
                                   for c in cell.name)
    say = run._say
    with idle_causes.Probe(True, f"{model}_{seed}") as probe:
        out = run.run_cell(cell, seed, 1.5, True, device="cpu")
    assert run._say is say  # the run's own functions are back
    assert out["correct"], out["checks"]
    assert {r[1] for r in probe.timeline._snapshot()} >= set(THREAD_KINDS) - {
        "gc", "wait_output"}  # the ledger recorded thread spans
    got = probe.numbers(out, 1.5, 8)
    assert len(got["thread_cpu_per_s"]) == 4, got
    assert got["hot_thread_cpu_ms_per_frame"] > 0
    assert got["convert_ms"] > 0
    assert not set(idle.CAUSES) & set(got)


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_the_probe_names_what_the_run_never_called(platform):
    probe = idle_causes.Probe(True, "nothing")
    probe.cpu["window open"] = {}
    out = {"device": {"platform": platform}, "info": {}}
    with pytest.raises(RuntimeError) as err:
        probe.numbers(out, 1.0, 8)
    missed = ["run._say('window closed')", "timeline.activate"]
    if platform == "gpu":
        missed += ["trace.kineto_events", "trace.reduce"]
    assert str(err.value) == \
        "idle_causes: the run never called " + ", ".join(missed)
