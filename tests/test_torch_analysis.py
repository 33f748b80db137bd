"""The port's static analyzer (``nnstreamer_tpu_torch/analysis``) held to
the JAX package's.

- Every source fixture of ``tests/test_analysis.py`` (read from that file:
  each ``lint_source``/``lint_concurrency_source(s)`` call with its
  literal source and label) gives the same (code, severity, line, column)
  list in both packages, except the five rules rewritten for PyTorch
  (NNS107, NNS108, NNS113, NNS117, NNS118), which get torch fixtures
  here: hits, clean cases and a pragma each.
- The verifier gives the same codes in both packages for every launch
  string of ``tests/test_analysis.py``, of the golden pipelines, of the
  README and of ``examples/``.
- ``nns-lint-torch``: exit codes, JSON, ``--self``/``--concurrency`` on
  the port, ``--scan``.
- ROADMAP C.52, a fault the port shares: an f-string's ``caps={expr}`` is
  extracted as ``caps=0``, which the verifier reports as NNS005.
"""

import ast
import json
import pathlib

import pytest

from nnstreamer_tpu.analysis import astlint as JA
from nnstreamer_tpu.analysis import concurrency as JC
from nnstreamer_tpu.analysis import extract as JE
from nnstreamer_tpu.analysis import verify as JV
from nnstreamer_tpu_torch.analysis import (
    CODE_TABLE,
    lint_concurrency_source,
    lint_concurrency_sources,
    lint_source,
    verify_description,
)
from nnstreamer_tpu_torch.analysis import extract as TE
from nnstreamer_tpu_torch.analysis.cli import main as lint_main

ROOT = pathlib.Path(__file__).resolve().parent.parent
REWRITTEN = {"NNS107", "NNS108", "NNS113", "NNS117", "NNS118"}


def codes(diags):
    return [d.code for d in diags]


def by_code(diags, code):
    return [d for d in diags if d.code == code]


def _key(diags, drop=frozenset()):
    return sorted((d.code, d.severity, d.loc.line, d.loc.column)
                  for d in diags if d.code not in drop)


# -- the fixtures of tests/test_analysis.py ------------------------------------
def _literal(node, env):
    if isinstance(node, ast.Name):
        return env.get(node.id)
    try:
        value = ast.literal_eval(node)
    except ValueError:
        return None
    return value if isinstance(value, (str, dict)) else None


def _fixtures():
    """(kind, source or {rel: source}, rel) for every analyzer call of
    tests/test_analysis.py whose arguments are literals."""
    tree = ast.parse((ROOT / "tests" / "test_analysis.py").read_text())
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef) or \
                not fn.name.startswith("test_"):
            continue
        env = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                value = _literal(node.value, env)
                if value is not None:
                    env[node.targets[0].id] = value
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            name = node.func.attr if isinstance(node.func, ast.Attribute) \
                else getattr(node.func, "id", "")
            kind = {"lint_source": "ast", "_lint": "conc",
                    "lint_concurrency_source": "conc",
                    "lint_concurrency_sources": "multi"}.get(name)
            if kind is None:
                continue
            src = _literal(node.args[0], env)
            rel = _literal(node.args[1], env) if len(node.args) > 1 \
                else "x.py"
            if src is None or not isinstance(rel, str) or \
                    (kind == "multi") != isinstance(src, dict):
                continue
            out.append((kind, src, rel, f"{fn.name}:{node.lineno}"))
    return out


FIXTURES = _fixtures()


def test_the_fixtures_were_found():
    kinds = [f[0] for f in FIXTURES]
    assert kinds.count("ast") >= 60 and kinds.count("conc") >= 15
    assert "multi" in kinds


@pytest.mark.parametrize("kind,src,rel", [f[:3] for f in FIXTURES],
                         ids=[f[3] for f in FIXTURES])
def test_fixture_diagnostics_equal_the_jax_analyzers(kind, src, rel):
    if kind == "ast":
        ours = _key(lint_source(src, rel), REWRITTEN)
        theirs = _key(JA.lint_source(src, rel), REWRITTEN)
    elif kind == "conc":
        ours = _key(lint_concurrency_source(src, rel))
        theirs = _key(JC.lint_concurrency_source(src, rel))
    else:
        ours = _key(lint_concurrency_sources(src))
        theirs = _key(JC.lint_concurrency_sources(src))
    assert ours == theirs


def test_the_code_table_is_the_jax_packages():
    from nnstreamer_tpu.analysis.diagnostics import CODE_TABLE as JT

    assert set(CODE_TABLE) == set(JT)
    assert {k for k in CODE_TABLE if CODE_TABLE[k] != JT[k]} == \
        {"NNS108", "NNS113", "NNS117", "NNS118"}
    assert not any("jax" in CODE_TABLE[k].lower() for k in CODE_TABLE)


# -- the five rewritten rules, on torch fixtures --------------------------------
def _lint(src, rel="x.py"):
    return lint_source(src, rel)


@pytest.mark.parametrize("call,what", [
    ("v = out.item()", ".item()"),
    ("v = out.cpu()", ".cpu()"),
    ("v = out.tolist()", ".tolist()"),
    ("v = out.numpy()", ".numpy()"),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize()"),
    ("v = int(out[0])", "int(t[...])"),
    ("v = float(out[0, 1])", "float(t[...])"),
])
def test_nns107_sync_in_a_hot_path(call, what):
    src = ("import torch\n"
           "def chain(self, pad, buf):\n"
           f"    {call}\n")
    diags = by_code(_lint(src), "NNS107")
    assert len(diags) == 1 and what in diags[0].message
    assert diags[0].loc.line == 3


@pytest.mark.parametrize("src", [
    # outside a hot path
    "def to_host(buf):\n    return buf.tensors[0].cpu()\n",
    # .cpu() with arguments is not the sync method; .to(device) is fine
    "def chain(self, pad, buf):\n    y = x.to(self.device)\n",
    # int() of a plain name
    "def chain(self, pad, buf):\n    n = int(k)\n",
    # a pragma
    "def chain(self, pad, buf):\n"
    "    v = out.item()  # nns-lint: disable=NNS107 -- host scalar\n",
])
def test_nns107_clean(src):
    assert by_code(_lint(src), "NNS107") == []


def test_nns107_nested_in_device_stage():
    src = ("def device_stage(self):\n"
           "    def run(x):\n"
           "        return x.cpu()\n"
           "    return run\n")
    assert codes(_lint(src)) == ["NNS107"]


@pytest.mark.parametrize("expr", [
    "np.asarray(buf.tensors[0])",
    "buf.tensors[0].cpu()",
    "buf.tensors[0].numpy()",
    "buf.tensors[1].tolist()",
    "buf.tensors[0].to('cpu')",
    "buf.tensors[0].to(device='cpu')",
])
def test_nns108_materializing_buffer_tensors(expr):
    src = ("import numpy as np\n"
           "def render(buf):\n"
           f"    return {expr}\n")
    diags = by_code(_lint(src), "NNS108")
    assert len(diags) == 1 and diags[0].loc.line == 3


@pytest.mark.parametrize("src", [
    "def render(x):\n    return x.cpu()\n",                 # loose tensor
    "def to_host(self):\n    return self.tensors[0].cpu()\n",  # sanctioned
    "def render(buf):\n    return buf.tensors[0].to(dev)\n",  # an upload
    "def render(buf):\n"
    "    return buf.tensors[0].cpu()  # nns-lint: disable=NNS108 -- host\n",
])
def test_nns108_clean(src):
    assert by_code(_lint(src), "NNS108") == []


@pytest.mark.parametrize("expr", [
    "x.to(device)",
    "x.to(self.device, non_blocking=True)",
    "x.to('cuda:0')",
    "x.to(torch.device('cuda'))",
    "x.to(dtype=torch.float16, device=dev)",
    "x.to(self._in_device)",
    "x.cuda()",
    "torch.as_tensor(a, device=dev)",
    "torch.tensor([1, 2], device=dev)",
])
def test_nns113_direct_upload(expr):
    src = ("import torch\n"
           "def prepare(x, a, dev, device):\n"
           f"    return {expr}\n")
    diags = by_code(_lint(src), "NNS113")
    assert len(diags) == 1 and diags[0].loc.line == 3


@pytest.mark.parametrize("fn,expr", [
    ("prepare", "x.to(torch.float16)"),          # a dtype cast
    ("prepare", "x.to('cpu')"),                  # a fetch, not an upload
    ("prepare", "torch.as_tensor(a)"),           # no device
    ("prepare", "torch.cuda.current_stream()"),  # not .cuda()
    ("to_device", "x.to(device)"),               # the accountant's entry
    ("upload_many", "x.cuda()"),
    ("install_weights", "x.to(device)"),
    ("open", "torch.as_tensor(a, device=dev)"),
])
def test_nns113_clean(fn, expr):
    src = ("import torch\n"
           f"def {fn}(x, a, dev, device):\n"
           f"    return {expr}\n")
    assert by_code(_lint(src), "NNS113") == []


def test_nns113_pragma_suppressible():
    src = ("def f(x, device):\n"
           "    return x.to(  # nns-lint: disable=NNS113 -- a constant\n"
           "        device)\n")
    assert by_code(_lint(src), "NNS113") == []


@pytest.mark.parametrize("expr", [
    "Placement(mesh, P('dp'))",
    "mesh_mod.Placement(mesh, P())",
    "nnstreamer_tpu_torch.parallel.mesh.Placement(mesh, P(None, 'tp'))",
    "shard_tensor(x, Placement(mesh, P('dp')))",
    "ShardedTensor([x], placement, x.shape)",
])
def test_nns117_placement_outside_parallel(expr):
    src = ("import torch\n"
           "def f(x, mesh):\n"
           f"    return {expr}\n")
    hits = by_code(_lint(src, "elements/foo.py"), "NNS117")
    assert hits and all(d.loc.line == 3 for d in hits)


@pytest.mark.parametrize("rel,src", [
    ("nnstreamer_tpu_torch/parallel/serve.py",
     "def f(x, mesh):\n    return shard_tensor(x, Placement(mesh, P()))\n"),
    ("elements/foo.py", "def f(x):\n    return x.shard(0)\n"),
    ("elements/foo.py",
     "def f(x, plan):\n    return serve.place_batch(x, plan)\n"),
    ("elements/foo.py",
     "def f(x, mesh):\n    return shard_tensor(  # nns-lint: "
     "disable=NNS117 -- a test harness\n        x, mesh)\n"),
])
def test_nns117_clean(rel, src):
    assert by_code(_lint(src, rel), "NNS117") == []


@pytest.mark.parametrize("expr", [
    "self.arena.values[:, blk]",
    "pool.arena.scale[0]",
    "kv_arena[0]",
])
def test_nns118_arena_subscript(expr):
    src = ("def gather(self, pool, kv_arena, blk):\n"
           f"    return {expr}\n")
    diags = by_code(_lint(src, "models/transformer.py"), "NNS118")
    assert len(diags) == 1 and diags[0].loc.line == 2


@pytest.mark.parametrize("rel,src", [
    ("nnstreamer_tpu_torch/serving/kvpool.py",
     "def f(self, blk):\n    return self.arena.values[:, blk]\n"),
    ("models/transformer.py",
     "def f(self, i):\n    return self.arenas_used[i]\n"),
    ("models/transformer.py",
     "def f(self, i):\n    return self.arena.values[i]  "
     "# nns-lint: disable=NNS118 -- read-only debug view\n"),
])
def test_nns118_clean(rel, src):
    assert by_code(_lint(src, rel), "NNS118") == []


# -- the verifier against the JAX package's -------------------------------------
def _descriptions():
    out = []
    tree = ast.parse((ROOT / "tests" / "test_analysis.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "id", "") == "verify_description" and \
                node.args and isinstance(node.args[0], ast.Constant):
            out.append(("test_analysis", node.args[0].value))
    files = [ROOT / "tests" / "test_golden_pipelines.py", ROOT / "README.md"]
    files += sorted((ROOT / "examples").glob("*.py"))
    files += sorted((ROOT / "docs").glob("*.md"))
    for f in files:
        for snip in JE.extract_from_file(f):
            out.append((f"{f.name}:{snip.line}", snip.description))
    return out


DESCRIPTIONS = _descriptions()


def test_the_descriptions_were_found():
    assert len(DESCRIPTIONS) >= 60


def test_the_extractors_agree(tmp_path):
    for f in [ROOT / "README.md", ROOT / "tests" / "test_golden_pipelines.py"]:
        assert TE.extract_from_file(f) == JE.extract_from_file(f)


@pytest.mark.parametrize("desc", [d for _, d in DESCRIPTIONS],
                         ids=[i for i, _ in DESCRIPTIONS])
def test_verifier_codes_equal_the_jax_verifiers(desc):
    assert sorted(codes(verify_description(desc))) == \
        sorted(codes(JV.verify_description(desc)))


def test_c52_an_interpolated_caps_is_verified_as_caps_0():
    """ROADMAP C.52, shared with the JAX package: the extractor replaces
    each ``{expr}`` of an f-string by ``0``, so ``caps={caps}`` reaches the
    verifier as the caps ``0`` and fails NNS005, whatever the caps were."""
    src = ('caps = "other/tensors,format=static"\n'
           'p = parse_launch(f"appsrc caps={caps} ! tensor_query_client '
           'port=1 ! tensor_sink")\n')
    for ex, ver in ((TE, verify_description), (JE, JV.verify_description)):
        (snip,) = ex.extract_from_python(src, "x.py")
        assert "caps=0 " in snip.description
        assert "NNS005" in codes(ver(snip.description))


# -- Pipeline.verify() ---------------------------------------------------------
@pytest.mark.parametrize("build", ["parsed", "dangling", "tee"])
def test_pipeline_verify_equals_the_jax_pipelines(build):
    """``Pipeline.verify()`` on the same constructed graph in both
    packages: a parsed clean string, a lone queue (NNS006), a tee fanning
    out without queues (NNS009)."""
    import nnstreamer_tpu as jnt
    import nnstreamer_tpu_torch as tnt
    from nnstreamer_tpu.pipeline.pipeline import Pipeline as JPipeline
    from nnstreamer_tpu.pipeline.pipeline import Queue as JQueue
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline, Queue

    if build == "parsed":
        desc = "videotestsrc num-buffers=2 ! tensor_converter ! tensor_sink"
        ours, theirs = tnt.parse_launch(desc), jnt.parse_launch(desc)
    elif build == "dangling":
        ours, theirs = Pipeline("p"), JPipeline("p")
        ours.add(Queue(name="q"))
        theirs.add(JQueue(name="q"))
    else:
        desc = ("videotestsrc num-buffers=2 ! tensor_converter ! tee name=t "
                "t. ! tensor_sink t. ! tensor_sink")
        ours, theirs = tnt.parse_launch(desc), jnt.parse_launch(desc)
    got = sorted(codes(ours.verify()))
    assert got == sorted(codes(theirs.verify()))
    assert set(got) == {"parsed": set(), "dangling": {"NNS006"},
                        "tee": {"NNS009"}}[build]


# -- nns-lint-torch --------------------------------------------------------------
def test_cli_verifies_a_description(capsys):
    assert lint_main(["videotestsrc ! tensor_converter ! tensor_sink"]) == 0
    assert lint_main(["videotestsrc ! tensor_convertr ! tensor_sink"]) == 1
    assert "NNS001" in capsys.readouterr().out


def test_cli_json_schema(capsys):
    assert lint_main(["--format", "json", "videotestsrc ! bogus_el"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["version"] == 1 and doc["summary"]["error"] >= 1
    assert {"code", "severity", "message", "hint", "loc"} <= \
        set(doc["diagnostics"][0])


def test_cli_usage_errors(capsys):
    assert lint_main([]) == 2
    assert lint_main(["-f", "/nonexistent/desc.txt"]) == 2


def test_cli_self_and_concurrency_are_clean_on_the_port(capsys):
    assert lint_main(["--self", "--concurrency"]) == 0
    out = capsys.readouterr().out
    assert "0 error(s), 0 warning(s)" in out


def test_cli_scan_finds_and_verifies(tmp_path, capsys):
    f = tmp_path / "demo.py"
    f.write_text('p = parse_launch("videotestsrc ! tensor_convertr ! '
                 'tensor_sink")\n')
    assert lint_main(["--scan", str(tmp_path)]) == 1
    assert "NNS001" in capsys.readouterr().out


def test_the_console_script_is_declared():
    text = (ROOT / "pyproject.toml").read_text()
    assert 'nns-lint-torch = "nnstreamer_tpu_torch.analysis.cli:main"' \
        in text
