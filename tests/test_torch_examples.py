"""``examples/torch/``: one script per ``examples/*.py``, on the port.

- Each JAX example has its port counterpart under the same file name.
- Every launch string of the port's scripts passes ``nns-launch-torch
  --check`` with no error diagnostic (``serve.py`` drives the engine's
  API and has none, as the JAX ``serve.py``).
- Each script runs to rc 0 as a subprocess with
  ``NNSTPU_TORCH_DEVICE=cpu`` (each under 20 s on the CPU), and the
  scripts that share their weights' seeds with the JAX example print the
  JAX example's tokens (``llm_stream.py``: the JAX package's
  ``init_params`` draw) or labels (``audio.py``: its ``fast_init``).
- The scripts import no ``jax``, ``flax``, ``msgpack`` or
  ``nnstreamer_tpu``.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from nnstreamer_tpu_torch.analysis.extract import extract_from_file
from nnstreamer_tpu_torch.cli import main as cli_main

REPO = Path(__file__).resolve().parent.parent
JAX_EXAMPLES = REPO / "examples"
PORT_EXAMPLES = JAX_EXAMPLES / "torch"
NAMES = sorted(p.stem for p in JAX_EXAMPLES.glob("*.py"))
#: per-script time limit on the CPU (each runs in under 15 s here)
TIMEOUT_S = 120


def test_every_jax_example_has_its_port_counterpart():
    assert len(NAMES) == 14
    assert sorted(p.stem for p in PORT_EXAMPLES.glob("*.py")) == NAMES
    assert (PORT_EXAMPLES / "README.md").is_file()
    readme = (PORT_EXAMPLES / "README.md").read_text()
    for name in NAMES:
        assert f"examples/torch/{name}.py" in readme, name


@pytest.mark.parametrize("name", NAMES)
def test_launch_strings_pass_check(name, capsys):
    snippets = extract_from_file(PORT_EXAMPLES / f"{name}.py")
    if name == "serve":
        assert snippets == []  # the engine's API, as the JAX serve.py
        return
    assert snippets, f"{name}.py: no launch string found"
    for s in snippets:
        assert cli_main(["--check", s.description]) == 0, \
            f"{name}.py:{s.line}: {capsys.readouterr().out}"


@pytest.mark.parametrize("name", NAMES)
def test_scripts_import_no_jax_flax_or_msgpack(name):
    tree = ast.parse((PORT_EXAMPLES / f"{name}.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "flax", "msgpack", "ml_dtypes",
                        "nnstreamer_tpu"}, roots
    assert "ensure_jax_platform" not in \
        (PORT_EXAMPLES / f"{name}.py").read_text()


def _run(path: Path, **env_extra) -> str:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env.update(PYTHONPATH=str(REPO), **env_extra)
    proc = subprocess.run([sys.executable, str(path)], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if n not in ("llm_stream", "audio")])
def test_script_runs_on_the_cpu(name):
    out = _run(PORT_EXAMPLES / f"{name}.py", NNSTPU_TORCH_DEVICE="cpu")
    assert out.strip(), f"{name}.py printed nothing"


@pytest.mark.parametrize("name,pattern", [
    ("llm_stream", r"streamed \d+ tokens: \[[\d, ]*\]"),
    ("audio", r"classified \d+ windows; labels: \[[\d, ]*\]"),
])
def test_script_prints_the_jax_examples_result(name, pattern):
    ours = _run(PORT_EXAMPLES / f"{name}.py", NNSTPU_TORCH_DEVICE="cpu")
    theirs = _run(JAX_EXAMPLES / f"{name}.py", JAX_PLATFORMS="cpu")
    want = re.search(pattern, theirs)
    assert want is not None, theirs
    got = re.search(pattern, ours)
    assert got is not None and got.group(0) == want.group(0), ours
