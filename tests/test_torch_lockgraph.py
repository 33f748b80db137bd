"""The port's runtime lock-order witness
(``nnstreamer_tpu_torch/obs/lockgraph.py``): ``tests/test_lockgraph.py``
on the port, plus what is the port's own — only the port's locks are
instrumented (the JAX package's stay real in the same process), and the
graph a port pipeline takes on the CPU agrees with the port's static
NNS202 graph.

The JAX tests' contracts, on the port:

Three contracts under test:

- **kill switch**: with ``NNSTPU_LOCKGRAPH`` unset the module is a
  byte-identical no-op — the ``threading`` factories are untouched and
  the graph records zero acquisitions (subprocess-verified, since this
  test process itself must not be armed);
- **witness**: a seeded two-lock inversion across two threads is
  detected online (one violation carrying the cycle path), while
  consistent orderings, RLock reentrancy, and Condition wait/notify
  stay clean;
- **cross-check**: :func:`lockgraph.cross_check` reports a cycle when
  the union of the observed and static graphs is cyclic (runtime B→A
  against static A→B) and stays silent when they agree.

The factory only instruments locks whose creating frame lives under
the package root, so the scenarios are written to a real file and the
root is pointed at it — an inline ``exec`` would be filtered out.
"""

import importlib.util
import json
import os
import subprocess
import sys
import threading

import pytest

from nnstreamer_tpu_torch.obs import lockgraph

_SCENARIO = '''\
"""Lock-acquisition scenarios driven by test_torch_lockgraph.py."""
import threading


def make_locks():
    a = threading.Lock()
    b = threading.Lock()
    return a, b


def run_inversion():
    """Two threads take the same two locks in opposite orders.

    Sequential (join between them) on purpose: the witness flags the
    *order* contradiction, no actual deadlock interleaving needed."""
    a, b = make_locks()

    def fwd():
        with a:
            with b:
                pass

    def rev():
        with b:
            with a:
                pass

    t1 = threading.Thread(target=fwd, name="lg-fwd")
    t1.start()
    t1.join()
    t2 = threading.Thread(target=rev, name="lg-rev")
    t2.start()
    t2.join()


def run_ordered():
    a, b = make_locks()

    def fwd():
        with a:
            with b:
                pass

    for name in ("lg-one", "lg-two"):
        t = threading.Thread(target=fwd, name=name)
        t.start()
        t.join()


def run_rlock():
    r = threading.RLock()
    with r:
        with r:
            pass


def run_condition():
    lk = threading.Lock()
    cv = threading.Condition(lk)
    done = []

    def waiter():
        with cv:
            while not done:
                cv.wait(1.0)

    t = threading.Thread(target=waiter, name="lg-wait")
    t.start()
    with cv:
        done.append(1)
        cv.notify_all()
    t.join()
'''


@pytest.fixture
def armed(tmp_path, monkeypatch):
    """Arm the witness with the creator-frame filter pointed at a
    scenario module written to tmp_path; restore everything after."""
    scen = tmp_path / "scenario.py"
    scen.write_text(_SCENARIO)
    monkeypatch.setattr(lockgraph, "_PKG_ROOT", str(tmp_path))
    monkeypatch.setattr(lockgraph, "_REL_BASE", str(tmp_path))
    lockgraph.reset()
    lockgraph.activate()
    try:
        spec = importlib.util.spec_from_file_location("lg_scenario", scen)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        yield mod
    finally:
        lockgraph.deactivate()
        lockgraph.reset()
    assert threading.Lock is lockgraph._REAL_LOCK
    assert threading.RLock is lockgraph._REAL_RLOCK


def test_locks_are_instrumented_and_site_keyed(armed):
    a, b = armed.make_locks()
    assert type(a).__name__ == "_InstrumentedLock"
    assert type(b).__name__ == "_InstrumentedLock"
    assert a._site.startswith("scenario.py:")
    snap = lockgraph.snapshot()
    assert set(snap["nodes"].values()) == {"lock"}


def test_seeded_inversion_detected(armed):
    armed.run_inversion()
    snap = lockgraph.snapshot()
    assert len(snap["violations"]) == 1
    v = snap["violations"][0]
    # the second thread's reversed order closes the cycle
    assert v["thread"] == "lg-rev"
    assert len(set(v["cycle"])) == 2
    assert all(s.startswith("scenario.py:") for s in v["cycle"])
    # both directions were recorded as edges
    pairs = {(e["from"], e["to"]) for e in snap["edges"]}
    assert len(pairs) == 2
    assert {(b, a) for a, b in pairs} == pairs


def test_consistent_order_clean(armed):
    armed.run_ordered()
    snap = lockgraph.snapshot()
    assert snap["violations"] == []
    assert len(snap["edges"]) == 1
    assert snap["edges"][0]["count"] == 2
    assert snap["acquisitions"] == 4


def test_rlock_reentrancy_adds_no_edge(armed):
    armed.run_rlock()
    snap = lockgraph.snapshot()
    assert snap["violations"] == []
    assert snap["edges"] == []
    assert set(snap["nodes"].values()) == {"rlock"}


def test_condition_wait_notify_balanced(armed):
    armed.run_condition()
    snap = lockgraph.snapshot()
    assert snap["violations"] == []
    # wait() released and re-took the one lock; the per-thread stacks
    # must have drained (an unbalanced stack would leave phantom holds
    # that manufacture bogus edges on the next acquisition)
    a, _ = armed.make_locks()
    with a:
        pass
    assert lockgraph.snapshot()["edges"] == []


def test_dump_roundtrip(armed, tmp_path):
    armed.run_inversion()
    out = tmp_path / "graph.json"
    lockgraph.dump(str(out))
    doc = json.loads(out.read_text())
    assert doc["version"] == 1
    assert doc["nodes"] and doc["edges"] and doc["violations"]
    assert not out.with_suffix(".json.tmp").exists()


# -- kill switch (subprocess: this process must stay unarmed) -------------

def _run(code, env_extra):
    env = {k: v for k, v in os.environ.items()
           if k != lockgraph.ENV}
    env.update(env_extra)
    env.setdefault("JAX_PLATFORMS", "cpu")
    return subprocess.run([sys.executable, "-c", code],
                          capture_output=True, text=True, env=env,
                          timeout=120)


def test_env_unset_is_byte_identical_noop():
    proc = _run(
        "import threading\n"
        "import nnstreamer_tpu\n"
        "from nnstreamer_tpu_torch.obs import lockgraph\n"
        "assert threading.Lock is lockgraph._REAL_LOCK\n"
        "assert threading.RLock is lockgraph._REAL_RLOCK\n"
        "assert not lockgraph.is_active()\n"
        "assert lockgraph.graph().acquisitions == 0\n"
        "assert lockgraph.graph().nodes == {}\n",
        {})
    assert proc.returncode == 0, proc.stderr


def test_env_armed_instruments_package_locks():
    proc = _run(
        "import json\n"
        "import nnstreamer_tpu\n"
        "from nnstreamer_tpu_torch.obs import lockgraph\n"
        "assert lockgraph.is_active()\n"
        "snap = lockgraph.snapshot()\n"
        "assert snap['nodes'], 'import-time locks not instrumented'\n"
        "assert snap['violations'] == []\n"
        "print(json.dumps(len(snap['nodes'])))\n",
        {lockgraph.ENV: "1"})
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) >= 5   # import-time lock sites


def test_env_path_dumps_at_exit(tmp_path):
    out = tmp_path / "observed.json"
    proc = _run("import nnstreamer_tpu_torch\n", {lockgraph.ENV: str(out)})
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(out.read_text())
    assert doc["version"] == 1
    assert doc["violations"] == []


# -- static/runtime cross-check -------------------------------------------

def _static(edges, sites):
    return {"version": 1,
            "nodes": sorted({n for e in edges for n in e}),
            "edges": [{"from": a, "to": b, "site": "s"} for a, b in edges],
            "sites": sites}


def _runtime(edges, violations=()):
    return {"version": 1,
            "nodes": {n: "lock" for e in edges for n in e},
            "edges": [{"from": a, "to": b, "count": 1} for a, b in edges],
            "acquisitions": 2 * len(edges),
            "violations": list(violations)}


def test_cross_check_agreement_is_silent():
    sites = {"m.py:1": "m:A", "m.py:2": "m:B"}
    static = _static([("m:A", "m:B")], sites)
    runtime = _runtime([("m.py:1", "m.py:2")])
    assert lockgraph.cross_check(runtime, static) == []


def test_cross_check_flags_union_cycle():
    # statically A is taken before B; at runtime a path took B then A —
    # neither graph alone is cyclic, the union is the deadlock
    sites = {"m.py:1": "m:A", "m.py:2": "m:B"}
    static = _static([("m:A", "m:B")], sites)
    runtime = _runtime([("m.py:2", "m.py:1")])
    problems = lockgraph.cross_check(runtime, static)
    assert len(problems) == 1
    assert "contradiction" in problems[0]
    assert "m:A" in problems[0] and "m:B" in problems[0]


def test_cross_check_reports_observed_violations():
    sites = {"m.py:1": "m:A", "m.py:2": "m:B"}
    runtime = _runtime(
        [("m.py:1", "m.py:2"), ("m.py:2", "m.py:1")],
        violations=[{"cycle": ["m.py:1", "m.py:2", "m.py:1"],
                     "thread": "t2",
                     "edge": ["m.py:2", "m.py:1"]}])
    problems = lockgraph.cross_check(runtime, _static([], sites))
    assert any("observed lock-order cycle" in p and "m:A" in p
               for p in problems)


# -- the port's own ---------------------------------------------------------

def test_only_the_ports_locks_are_instrumented():
    """Armed in a process that also imports the JAX package (its own
    witness left off), the port's witness wraps the port's locks and
    leaves the JAX package's real, though that package's directory name
    is a prefix of the port's."""
    proc = _run(
        "import json, os\n"
        "import nnstreamer_tpu_torch\n"
        "from nnstreamer_tpu_torch.obs import lockgraph\n"
        "del os.environ['NNSTPU_LOCKGRAPH']  # the JAX witness stays off\n"
        "from nnstreamer_tpu.obs import lockgraph as jlg\n"
        "import nnstreamer_tpu\n"
        "from nnstreamer_tpu_torch.obs import registry as treg\n"
        "from nnstreamer_tpu.obs import registry as jreg\n"
        "t = treg.MetricsRegistry()._lock\n"
        "j = jreg.MetricsRegistry()._lock\n"
        "nodes = lockgraph.snapshot()['nodes']\n"
        "print(json.dumps([type(t).__name__, type(j).__name__,\n"
        "    all(n.startswith('nnstreamer_tpu_torch/') for n in nodes),\n"
        "    jlg.is_active()]))\n",
        {lockgraph.ENV: "1"})
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == \
        ["_InstrumentedLock", "lock", True, False]


_PIPELINE = """\
import numpy as np
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu_torch.filters import register_custom_easy
tnt.set_device("cpu")
info = tnt.TensorsInfo.from_str("4:4:3:1", "uint8")
register_custom_easy("lg_id", lambda ins: [np.asarray(ins[0])], info, info)
server = tnt.parse_launch(
    "tensor_query_serversrc name=ss port=0 id=81 ! "
    "tensor_filter framework=custom-easy model=lg_id ! "
    "tensor_query_serversink id=81")
server.start()
assert server.get("ss").server.native
pipe = tnt.parse_launch(
    "videotestsrc num-buffers=24 width=4 height=4 ! tensor_converter ! "
    "queue max-size-buffers=4 leaky=downstream stamp-admission=true ! "
    "tensor_query_client dest-host=127.0.0.1 dest-port="
    + str(server.get("ss").port) + " timeout=10 max-in-flight=4 ! "
    "tensor_sink name=out", lanes=2)
msg = pipe.run(timeout=60)
server.stop()
assert msg is not None and msg.kind == "eos", msg
assert len(pipe.get("out").buffers) > 0
"""


def test_a_query_pipeline_agrees_with_the_static_graph(tmp_path):
    """A lanes-2 ingress behind a leaky admission queue, offloading to a
    native-core server, under the armed witness: no observed cycle, and
    the observed orders do not contradict the port's static graph."""
    from pathlib import Path

    from nnstreamer_tpu_torch.analysis.concurrency import static_lock_graph

    out = tmp_path / "observed.json"
    proc = _run(_PIPELINE, {lockgraph.ENV: str(out),
                            "NNSTPU_TORCH_DEVICE": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    runtime = json.loads(out.read_text())
    assert runtime["violations"] == []
    assert runtime["acquisitions"] > 0 and runtime["nodes"]
    static = static_lock_graph(
        Path(lockgraph._PKG_ROOT))
    assert lockgraph.cross_check(runtime, static) == []
