"""Static gates over the port: ``tests/test_static_gates.py`` on
``nnstreamer_tpu_torch``.

- Every module byte-compiles and carries a module docstring.
- No stray debugging artifacts and no ``print()`` outside CLI surfaces.
- ``nns-lint-torch --self`` and ``--concurrency`` report zero findings on
  the port (each deliberate exception carries a justified pragma, which
  NNS199 verifies), and the static lock graph is non-trivial.
- Every launch string of the README's port section passes the port's
  verifier with no error-severity diagnostic.
- The twelve modules ported last import no JAX, ``nnstreamer_tpu``,
  ``grpc``, ``tensorflow`` or ``transformers``.
- The port has a counterpart of every JAX module that needs one, and
  names every ``NNSTPU_*`` variable and ``nns_*`` series that the JAX
  package names.
"""

import ast
import json
import pathlib
import py_compile
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "nnstreamer_tpu_torch"
MODULES = sorted(p for p in PKG.rglob("*.py") if "_build" not in p.parts)


def test_package_has_expected_shape():
    assert len(MODULES) > 60  # sanity: the glob found the real package


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(
    p.relative_to(PKG)))
def test_module_compiles_and_documented(path, tmp_path):
    py_compile.compile(str(path), cfile=str(tmp_path / "c.pyc"),
                       doraise=True)
    tree = ast.parse(path.read_text())
    assert ast.get_docstring(tree), f"{path} lacks a module docstring"


def test_no_debug_artifacts():
    offenders = [str(p) for p in MODULES
                 if "pdb.set_trace" in p.read_text()
                 or "breakpoint()" in p.read_text()]
    assert not offenders, offenders


def _print_calls(tree):
    class V(ast.NodeVisitor):
        def __init__(self):
            self.hits, self._in_main = [], 0

        def visit_FunctionDef(self, node):
            bump = node.name == "main"  # CLI entry points may print
            self._in_main += bump
            self.generic_visit(node)
            self._in_main -= bump

        def visit_Call(self, node):
            if (not self._in_main and isinstance(node.func, ast.Name)
                    and node.func.id == "print"):
                self.hits.append(node.lineno)
            self.generic_visit(node)

    v = V()
    v.visit(tree)
    return v.hits


def test_no_stray_prints_in_library_code():
    offenders = [f"{p}:{n}" for p in MODULES if p.name != "cli.py"
                 for n in _print_calls(ast.parse(p.read_text()))]
    assert not offenders, offenders


def test_self_lint_clean():
    from nnstreamer_tpu_torch.analysis.astlint import lint_tree

    diags = lint_tree(PKG)
    assert not diags, "\n".join(d.render() for d in diags)


def test_concurrency_lint_clean():
    from nnstreamer_tpu_torch.analysis.concurrency import (
        lint_concurrency,
        static_lock_graph,
    )

    diags = lint_concurrency(PKG)
    assert not diags, "\n".join(d.render() for d in diags)
    graph = static_lock_graph(PKG)
    assert len(graph["sites"]) >= 20
    assert graph["nodes"]


def test_every_pragma_carries_a_justification():
    missing = []
    for p in MODULES:
        for n, line in enumerate(p.read_text().splitlines(), 1):
            if "nns-lint: disable=" in line and " -- " not in \
                    line.split("nns-lint: disable=", 1)[1]:
                missing.append(f"{p}:{n}")
    assert not missing, missing


def _port_section(tmp_path):
    text = (ROOT / "README.md").read_text()
    start = text.index("## PyTorch/CUDA port")
    end = text.index("\n## ", start + 1)
    path = tmp_path / "README-port.md"
    path.write_text(text[start:end])
    return path


def test_readme_port_strings_verify(tmp_path):
    from nnstreamer_tpu_torch.analysis.diagnostics import ERROR
    from nnstreamer_tpu_torch.analysis.extract import extract_from_file
    from nnstreamer_tpu_torch.analysis.verify import verify_description

    snippets = extract_from_file(_port_section(tmp_path))
    assert len(snippets) >= 5  # the extractor found the port's strings
    errors = [d.render() for s in snippets
              for d in verify_description(s.description,
                                          source=f"README:{s.line}")
              if d.severity == ERROR]
    assert not errors, "\n".join(errors)


NEW_MODULES = ["native", "query.grpc_bridge", "elements.grpc_io",
               "analysis", "analysis.astlint", "analysis.catalog",
               "analysis.cli", "analysis.concurrency",
               "analysis.diagnostics", "analysis.extract",
               "analysis.verify", "obs.lockgraph", "utils.flax_msgpack",
               "utils.checkpoint", "models", "filters.torch_backend",
               "filters.artifact"]


def test_the_new_modules_import_no_jax_grpc_tf_or_transformers():
    code = (
        "import importlib, json, sys\n"
        f"for m in {NEW_MODULES!r}:\n"
        "    importlib.import_module('nnstreamer_tpu_torch.' + m)\n"
        "import nnstreamer_tpu_torch.elements\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'nnstreamer_tpu', 'grpc',\n"
        "              'tensorflow', 'transformers', 'ml_dtypes',\n"
        "              'msgpack'))\n"
        "print(json.dumps(bad))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_the_port_has_every_single_card_module():
    """``comm`` of the two packages' module lists: the JAX files with no
    counterpart are the three that need no port; no ``not_ported`` raise
    names A.24 (the serving mesh) or A.25 (ring attention, pipeline
    parallelism, multi-host runs and the train steps) any more."""
    jax_pkg = ROOT / "nnstreamer_tpu"
    ours = {str(p.relative_to(PKG)) for p in MODULES}
    theirs = {str(p.relative_to(jax_pkg)) for p in jax_pkg.rglob("*.py")
              if "__pycache__" not in p.parts}
    missing = theirs - ours
    no_port = {"filters/jax_backend.py", "models/_init.py",
               "ops/tiling.py"}
    assert missing == no_port, sorted(missing)
    assert len(missing) == 3, sorted(missing)
    named = [str(p.relative_to(PKG)) for p in MODULES
             if "A.24" in p.read_text() or "A.25" in p.read_text()]
    assert named == [], named


#: ``NNSTPU_*`` variables and ``nns_*`` series of the JAX package the port
#: does not name, each with its reason
NAMES_NOT_PORTED: dict = {}


def _names(pkg: pathlib.Path, pattern: str) -> set:
    """Every match of ``pattern`` in the package's Python sources (as
    ``grep -rhoE`` over its ``*.py`` files)."""
    import re

    found = set()
    for path in pkg.rglob("*.py"):
        if "_build" in path.parts or "__pycache__" in path.parts:
            continue
        found.update(re.findall(pattern, path.read_text()))
    return found


@pytest.mark.parametrize("kind,pattern", [
    ("variables", r"\bNNSTPU_[A-Z0-9_]+"),
    ("series", r"\bnns_[a-z0-9_]+"),
])
def test_the_port_names_every_variable_and_series(kind, pattern):
    """Each environment switch and metric series of the JAX package is a
    contract of the port too: ``NNSTPU_RESIDENT``,
    ``nns_buffer_resident_ratio``, ``nns_fault_poisoned_batches_total``
    and ``nns_tensor_filter_opens_total`` were the last missing."""
    theirs = _names(ROOT / "nnstreamer_tpu", pattern)
    ours = _names(PKG, pattern)
    assert len(theirs) > 30, sorted(theirs)  # the scan found the names
    missing = theirs - ours - set(NAMES_NOT_PORTED)
    assert not missing, sorted(missing)
    assert not set(NAMES_NOT_PORTED) - theirs, NAMES_NOT_PORTED
