"""``nns-launch`` on the PyTorch port (``cli.py``): the JAX CLI's flags on
the CPU (``--platforms cpu``), the device it reports, the refusal to run
without CUDA when the CPU was not asked for, and a ``NotImplementedError``
naming the ROADMAP item for every flag whose feature is not ported.
"""

import json
import os
import subprocess
import sys

import pytest

from nnstreamer_tpu.cli import main as jax_main
from nnstreamer_tpu_torch import set_device
from nnstreamer_tpu_torch.cli import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DESC = ("videotestsrc num-buffers=20 width=16 height=16 ! tensor_converter ! "
        "queue name=q stamp-admission=true ! tensor_sink name=out")


@pytest.fixture(autouse=True)
def _default_device():
    set_device(None)
    yield
    set_device(None)


def test_without_cuda_the_cli_refuses(capsys):
    assert main(["-q", DESC]) == 1
    err = capsys.readouterr().err
    assert "CUDA is not available" in err and "set_device('cpu')" in err


def test_platforms_cpu_runs_and_reports_the_device(capsys):
    assert main(["--platforms", "cpu", DESC]) == 0
    out = capsys.readouterr().out
    assert "Device: cpu (asked for)" in out
    assert "Got EOS from pipeline." in out
    assert "-- flight recorder: 20 frames" in out


def test_confchk_reports_the_device(capsys):
    assert main(["--confchk"]) == 0
    out = capsys.readouterr().out
    assert "device : cuda:0 unavailable" in out
    assert "tensor_rate" in out and "queue" in out
    assert main(["--platforms", "cpu", "--confchk"]) == 0
    assert "device : cpu (asked for)" in capsys.readouterr().out


def test_slo_metrics_and_run_flags(tmp_path, capsys):
    trace = tmp_path / "trace.json"
    rc = main(["--platforms", "cpu", "--slo-budget-ms", "50",
               "--metrics-port", "0", "--lanes", "2", "--inflight", "1",
               "--error-policy", "retry", "--watchdog-s", "5",
               "--flight-dir", str(tmp_path / "flight"),
               "--trace-out", str(trace), DESC])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Serving metrics on http://0.0.0.0:" in out
    assert "-- slo scheduler: budget 50ms" in out
    assert "-- ingest lanes" in out and "2 lanes" in out
    assert "-- frame timeline:" in out
    assert json.loads(trace.read_text())["traceEvents"]


def test_slo_footer_counts_as_the_jax_cli(capsys):
    """The same string under the same budget, unloaded: both CLIs admit
    every frame and reject none (the counters are process-wide and
    labelled by the pipeline's name, so a delta is read)."""
    from nnstreamer_tpu.obs import get_registry as jget_registry
    from nnstreamer_tpu_torch.obs import get_registry

    desc = DESC.replace("num-buffers=20", "num-buffers=12").replace(
        "stamp-admission=true", "stamp-admission=true max-size-buffers=64")

    def counts(reg):
        return tuple(
            (lambda c: c.value if c is not None else 0.0)(
                reg().get(name, pipeline="pipeline"))
            for name in ("nns_sched_admitted_total",
                         "nns_sched_rejected_total"))

    got = {}
    for key, reg, run in (
            ("port", get_registry, lambda: main(
                ["--platforms", "cpu", "--slo-budget-ms", "60000", desc])),
            ("jax", jget_registry, lambda: jax_main(
                ["--slo-budget-ms", "60000", desc]))):
        before = counts(reg)
        assert run() == 0
        after = counts(reg)
        got[key] = tuple(a - b for a, b in zip(after, before))
        assert any(ln.startswith("-- slo scheduler: budget 60000ms")
                   for ln in capsys.readouterr().out.splitlines())
    assert got["port"] == got["jax"] == (12.0, 0.0)


def test_check_parses_without_running(capsys):
    """``--check`` runs the static verifier (the NNS0xx diagnostics) and
    builds nothing."""
    assert main(["--platforms", "cpu", "--check", DESC]) == 0
    assert "0 error(s), 0 warning(s)" in capsys.readouterr().out
    assert main(["--check", "videotestsrc ! no_such_element ! "
                 "tensor_sink"]) == 1
    assert "NNS001" in capsys.readouterr().out
    # mesh= (A.24) is a ported property now: no NNS002 naming it
    assert main(["--check", "videotestsrc ! tensor_converter ! "
                 "tensor_filter framework=jax model=m mesh=dp2 ! "
                 "tensor_sink"]) == 0
    out = capsys.readouterr().out
    assert "NNS002" not in out and "A.24" not in out


@pytest.mark.parametrize("desc", [
    DESC,
    "videotestsrc ! tensor_converter ! tee name=t t. ! tensor_sink "
    "t. ! tensor_sink",
    "videotestsrc ! tensor_filter framework=jax model=m ! tensor_sink",
    "videotestsrc ! tensor_converter ! tensor_filter framework=nope "
    "model=m ! tensor_sink",
    'videotestsrc ! "unterminated',
])
def test_check_prints_the_jax_clis_diagnostics(desc, capsys):
    """``--check`` exits and prints as the JAX CLI's does: the same codes
    in the same order."""
    import re

    ours = main(["--check", desc])
    our_codes = re.findall(r"NNS\d{3}", capsys.readouterr().out)
    theirs = jax_main(["--check", desc])
    their_codes = re.findall(r"NNS\d{3}", capsys.readouterr().out)
    assert (ours, our_codes) == (theirs, their_codes)


@pytest.mark.parametrize("kind,name,use", [
    ("filter", "my_scaler",
     "appsrc name=src ! tensor_filter framework=my_scaler model=x ! "
     "tensor_sink name=out"),
    ("decoder", "my_dec",
     "appsrc name=src ! tensor_decoder mode=my_dec ! tensor_sink name=out"),
    ("converter", "my_conv",
     "appsrc name=src ! tensor_converter mode=custom-code:my_conv ! "
     "tensor_sink name=out"),
])
def test_scaffold_writes_a_subplugin_the_registry_finds(kind, name, use,
                                                        tmp_path):
    """A scaffold imports from the port, lands under the name the
    registry's external search looks for, and runs in a pipeline from
    its search path (in a child process, so the registry here stays
    clean)."""
    import numpy as np

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert main(["--scaffold", kind, name]) == 0
        assert main(["--scaffold", kind, name]) == 2  # never overwrites
    finally:
        os.chdir(cwd)
    path = tmp_path / f"nnstreamer_tpu_torch_{kind}_{name}.py"
    text = path.read_text()
    assert "from nnstreamer_tpu_torch." in text
    assert "nnstreamer_tpu." not in text and "jax" not in text.lower()
    code = (
        "import numpy as np\n"
        "import nnstreamer_tpu_torch as nt\n"
        "nt.set_device('cpu')\n"
        f"pipe = nt.parse_launch({use!r})\n"
        "pipe.get('src').push([np.arange(6, dtype=np.float32)])\n"
        "pipe.get('src').end_of_stream()\n"
        "msg = pipe.run(timeout=60)\n"
        "assert msg is not None and msg.kind == 'eos', msg\n"
        "out = pipe.get('out').buffers\n"
        "print(len(out), np.asarray(out[0].tensors[0]).reshape(-1).tolist())\n")
    env = dict(os.environ, **{f"NNSTREAMER_TPU_{kind.upper()}_PATH":
                              str(tmp_path)})
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[0] == "1"
    assert np.allclose(eval(proc.stdout.split(" ", 1)[1]), np.arange(6))


@pytest.mark.parametrize("argv", [["--scaffold", "sink", "x"],
                                  ["--scaffold", "filter", "9bad name"]])
def test_scaffold_rejects_a_bad_kind_or_name(argv, tmp_path):
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert main(argv) == 2
    finally:
        os.chdir(cwd)
    assert list(tmp_path.iterdir()) == []


@pytest.fixture
def kernel_build_dir(monkeypatch):
    from nnstreamer_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "_override", None)


@pytest.mark.parametrize("flag", ["export", "checkpoint-dir",
                                  "compile-cache", "custom", "input"])
def test_continuity_flags_are_ported(flag, tmp_path, capsys,
                                     kernel_build_dir):
    """The serving-continuity flags (ROADMAP A.20): ``--export`` writes a
    ``.pt2`` (a missing model fails with rc 1), ``--checkpoint-dir``
    checkpoints at stop, ``--compile-cache`` moves the kernels' build
    directory, and ``--custom``/``--input`` belong to ``--export``."""
    from nnstreamer_tpu_torch.ops import _build
    from nnstreamer_tpu_torch.pipeline import continuity

    if flag == "export":
        assert main(["--export", str(tmp_path / "none.pt"),
                     str(tmp_path / "out.pt2")]) == 1
        assert "export failed" in capsys.readouterr().err
    elif flag == "checkpoint-dir":
        assert main(["--platforms", "cpu", "-q", "--checkpoint-dir",
                     str(tmp_path), DESC]) == 0
        assert (tmp_path / continuity.STATE_FILE).is_file()
    elif flag == "compile-cache":
        assert main(["--platforms", "cpu", "-q", "--compile-cache",
                     str(tmp_path), DESC]) == 0
        assert _build.build_dir() == (tmp_path / "kernels").resolve()
    else:
        with pytest.raises(SystemExit):
            main([f"--{flag}", "3:4:4:1", DESC])
        assert "only apply with --export" in capsys.readouterr().err


def test_bad_platform_is_a_usage_error():
    with pytest.raises(SystemExit):
        main(["--platforms", "tpu", DESC])


def test_module_entry_point_runs_without_jax(tmp_path):
    """``python -m nnstreamer_tpu_torch.cli`` in a fresh interpreter: it
    runs the string on the CPU, and imports neither JAX nor the JAX
    package on the way."""
    code = ("import runpy, sys\n"
            "sys.argv = ['nns-launch-torch', '-q', '--platforms', 'cpu', "
            f"{DESC!r}]\n"
            "try:\n"
            "    runpy.run_module('nnstreamer_tpu_torch.cli', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'nnstreamer_tpu'))\n"
            "print('BAD', bad)\n"
            "sys.exit(rc or (1 if bad else 0))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Got EOS from pipeline." in proc.stdout
    assert "BAD []" in proc.stdout
