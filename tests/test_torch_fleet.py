"""The replicated serving fleet in the PyTorch port (``serving/fleet.py``),
held to the JAX package's launcher and exactly-once contract.

Replicas are separate processes (``subprocess.Popen``), each a fresh
interpreter: the echo replica, a resilient ``QueryServer`` that doubles
each frame, and ``--desc`` replicas running ``python -m
nnstreamer_tpu_torch.cli`` on the CPU (asked for with
``env={"NNSTPU_TORCH_DEVICE": "cpu"}``).
A balanced, reliable client serves every frame once and in order, across
a crash and a rolling restart; a two-replica fleet serves a narrow
flagship (MobileNetV2 width 0.35, 32×32, 10 classes, fp32, on weights
converted from the JAX package's seeded variables) bit-identically to an
in-process run and within the model tolerance of the JAX flagship. Every
wait on a process or a socket is bounded.
"""

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.filters.jax_backend import (
    register_jax_model,
    unregister_jax_model,
)
from nnstreamer_tpu.models.mobilenet_v2 import mobilenet_v2 as jax_mobilenet_v2
from nnstreamer_tpu.serving import fleet as jfleet
from nnstreamer_tpu_torch.elements.query import TensorQueryClient
from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2, params_from_jax
from nnstreamer_tpu_torch.obs.distributed import FederatedMetrics
from nnstreamer_tpu_torch.serving import fleet
from nnstreamer_tpu_torch.serving.fleet import FleetLauncher
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

BOOT_S = 60.0  # a replica's boot, advertisement included
WAIT = 60      # every pipeline wait
SIZE, CLASSES, WIDTH, FRAMES = 32, 10, 0.35, 24


@pytest.fixture(autouse=True)
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


def _fleet_invokes(fl):
    """Every ``instance:req_id`` witness line in the replicas' invoke
    logs — each line is one worker invoke (``tests/test_fleet.py``)."""
    lines = []
    for i in range(fl.replicas):
        p = fl.state_dir / f"replica{i}" / "invokes.log"
        if p.exists():
            lines.extend(p.read_text().splitlines())
    return lines


def _client_for(fl, operation, window=8):
    cl = TensorQueryClient(operation=operation, broker_port=fl.broker_port,
                           reliable=True, balance="shortest-slack",
                           max_in_flight=window, timeout=5.0,
                           discovery_stale_s=5.0)
    outs = []
    cl.srcpad.push = lambda b: outs.append(b)
    return cl, outs


def _send_range(cl, lo, hi):
    for i in range(lo, hi):
        cl.chain(cl.sinkpad, TensorBuffer(
            [np.full((4,), i, dtype=np.float32)], pts=i))


def _values(outs):
    return [int(np.asarray(o.to_host().tensors[0])[0]) for o in outs]


# -- the launcher, against the JAX one -----------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(replicas=2),
    dict(replicas=3, base_port=47000, spin_ms=20.0, budget_ms=30.0,
         metrics=True, log_invokes=True, advertise_interval_s=0.5),
    dict(replicas=1, desc="appsrc ! tensor_sink name=s{index}"),
])
def test_replica_commands_equal_jax(kw, tmp_path):
    """The replica argv equals the JAX launcher's, but for the module the
    replica runs (and, for a ``--desc`` replica with ``metrics``, the
    metrics server the JAX launcher does not give it, ROADMAP C.44)."""
    ours = FleetLauncher(state_dir=str(tmp_path / "p"), broker_port=1883,
                         **kw)
    theirs = jfleet.FleetLauncher(state_dir=str(tmp_path / "p"),
                                  broker_port=1883, **kw)
    for i in range(ours.replicas):
        h = fleet.ReplicaHandle(i, tmp_path / "p" / f"replica{i}")
        a, b = ours._replica_cmd(h), theirs._replica_cmd(h)
        assert [x.replace("nnstreamer_tpu_torch", "nnstreamer_tpu")
                for x in a] == b


def test_desc_replica_gets_platforms_and_a_metrics_port(tmp_path):
    """A ``--desc`` replica with ``metrics`` gets a metrics server, the
    one argv addition to the JAX launcher's (ROADMAP C.44); its device
    comes through ``env=`` (``NNSTPU_TORCH_DEVICE``), as a JAX replica's
    platform through ``JAX_PLATFORMS``, not through an argv flag."""
    fl = FleetLauncher(replicas=1, state_dir=str(tmp_path), metrics=True,
                       env={"NNSTPU_TORCH_DEVICE": "cpu"},
                       desc="x metrics-port={metrics_port} y{index}")
    theirs = jfleet.FleetLauncher(replicas=1, state_dir=str(tmp_path),
                                  metrics=True,
                                  desc="x metrics-port={metrics_port} "
                                       "y{index}")
    h = fleet.ReplicaHandle(0, tmp_path / "replica0")
    cmd = fl._replica_cmd(h)
    port = cmd[cmd.index("--metrics-port") + 1]
    assert f"x metrics-port={port} y0" in cmd
    assert "--platforms" not in cmd
    i = cmd.index("--metrics-port")
    rest = cmd[:i] + cmd[i + 2:]
    assert [x.replace("nnstreamer_tpu_torch", "nnstreamer_tpu")
            .replace(f"metrics-port={port}", "metrics-port={metrics_port}")
            for x in rest] == theirs._replica_cmd(h)
    assert fl.extra_env == {"NNSTPU_TORCH_DEVICE": "cpu"}


@pytest.mark.parametrize("env, want", [
    (None, "cuda:0"), ("cpu", "cpu"), ("cuda:1", "cuda:1")])
def test_the_package_device_from_the_environment(monkeypatch, env, want):
    """``NNSTPU_TORCH_DEVICE`` names the package device of a process that
    sets none; ``set_device`` outranks it."""
    from nnstreamer_tpu_torch import device

    if env is None:
        monkeypatch.delenv(device.DEVICE_ENV, raising=False)
    else:
        monkeypatch.setenv(device.DEVICE_ENV, env)
    tnt.set_device(None)
    assert device.get_device() == torch.device(want)
    tnt.set_device("cpu")
    assert device.get_device() == torch.device("cpu")


def test_replicas_validate():
    with pytest.raises(ValueError):
        FleetLauncher(replicas=0)
    assert tnt.serving.FleetLauncher is FleetLauncher


# -- echo replicas ----------------------------------------------------------------------
def test_round_trip_balanced_exactly_once():
    fl = FleetLauncher(replicas=2, operation="tf-rt", spin_ms=1.0,
                       log_invokes=True).start()
    try:
        assert len(fl.endpoints(timeout=BOOT_S)) == 2
        assert fl.replicas_up() == 2
        cl, outs = _client_for(fl, "tf-rt")
        try:
            _send_range(cl, 0, 40)
            cl.handle_eos()
        finally:
            cl.stop()
        assert _values(outs) == [2 * i for i in range(40)]
        invokes = _fleet_invokes(fl)
        assert len(invokes) == len(set(invokes)) == 40
    finally:
        fl.stop()
    assert fl.replicas_up() == 0


def test_crash_restart_supervision():
    fl = FleetLauncher(replicas=2, operation="tf-crash",
                       spin_ms=1.0).start()
    try:
        fl.endpoints(timeout=BOOT_S)
        fl.kill_replica(0, graceful=False)
        assert fl.replicas_up() == 1
        deadline = time.monotonic() + BOOT_S
        while fl.replicas_up() < 2:
            assert time.monotonic() < deadline, \
                "the supervisor never relaunched the crashed replica"
            time.sleep(0.1)
    finally:
        fl.stop()


def test_rolling_restart_exactly_once(tmp_path):
    """The deploy contract: frames streamed across a rolling restart all
    arrive, in order, each request invoked once — the SIGTERM checkpoint
    carries each replica's dedup windows to its successor."""
    base = fleet._free_port() + 1000
    fl = FleetLauncher(replicas=2, operation="tf-roll", spin_ms=1.0,
                       base_port=base, log_invokes=True,
                       state_dir=str(tmp_path)).start()
    try:
        fl.endpoints(timeout=BOOT_S)
        cl, outs = _client_for(fl, "tf-roll", window=4)
        try:
            _send_range(cl, 0, 30)
            fl.rolling_restart(wait_s=BOOT_S)
            _send_range(cl, 30, 60)
            cl.handle_eos()
        finally:
            cl.stop()
        assert _values(outs) == [2 * i for i in range(60)]
        invokes = _fleet_invokes(fl)
        assert len(set(invokes)) == len(invokes) == 60
    finally:
        fl.stop()
    for i in range(2):
        assert (tmp_path / f"replica{i}" / fleet.CHECKPOINT_FILE).exists()


def test_a_jax_client_through_a_port_fleet():
    """The JAX package's balanced client fronts the port's echo replicas:
    the wire holds across the packages."""
    from nnstreamer_tpu.registry import ELEMENT, get_subplugin
    from nnstreamer_tpu.tensors.buffer import TensorBuffer as JaxBuffer

    fl = FleetLauncher(replicas=2, operation="tf-jax", spin_ms=1.0,
                       log_invokes=True).start()
    try:
        fl.endpoints(timeout=BOOT_S)
        cl = get_subplugin(ELEMENT, "tensor_query_client")(
            operation="tf-jax", broker_port=fl.broker_port, reliable=True,
            balance="shortest-slack", max_in_flight=8, timeout=5.0)
        outs = []
        cl.srcpad.push = lambda b: outs.append(b)
        try:
            for i in range(30):
                cl.chain(cl.sinkpad, JaxBuffer(
                    [np.full((4,), i, dtype=np.float32)], pts=i))
            cl.handle_eos()
        finally:
            cl.stop()
        assert _values(outs) == [2 * i for i in range(30)]
        assert len(set(_fleet_invokes(fl))) == 30
    finally:
        fl.stop()


def test_the_fleet_cli_prints_its_line(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch.serving.fleet", "-n",
         "2", "--operation", "tf-cli", "--duration-s", "0.5",
         "--state-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=BOOT_S * 2)
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[0])
    assert line["fleet"] == "tf-cli" and line["replicas"] == 2
    assert len(line["endpoints"]) == 2


def test_federation_of_echo_replicas_through_the_cli(tmp_path):
    """``nns-launch --fleet op=...`` finds the replicas' metrics servers
    through the broker and serves the merged view while its own pipeline
    runs; it exits 0."""
    fl = FleetLauncher(replicas=2, operation="tf-fed", spin_ms=1.0,
                       metrics=True).start()
    try:
        fl.endpoints(timeout=BOOT_S)
        fed = FederatedMetrics(operation="tf-fed",
                               broker_port=fl.broker_port)
        assert len(fed.discover(timeout=BOOT_S)) == 2
        view = fed.collect()
        assert len(view["endpoints"]) == 2
        assert all(e["ok"] for e in view["endpoints"].values())
        proc = subprocess.run(
            [sys.executable, "-m", "nnstreamer_tpu_torch.cli", "--platforms",
             "cpu", "-q", "--metrics-port", "0", "--fleet",
             f"op=tf-fed,broker=127.0.0.1:{fl.broker_port}",
             "videotestsrc num-buffers=2 ! tensor_converter ! tensor_sink"],
            capture_output=True, text=True, timeout=BOOT_S * 2)
    finally:
        fl.stop()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Serving fleet federation on" in proc.stdout


# -- the narrow flagship behind a --desc fleet -------------------------------------------
def _frames(n):
    rng = np.random.default_rng(3)
    return [rng.integers(0, 256, (1, SIZE, SIZE, 3), dtype=np.uint8)
            for _ in range(n)]


BODY = ("tensor_quant_dec ! tensor_transform mode=arithmetic "
        "option=typecast:float32,add:-127.5,div:127.5 ! "
        "tensor_filter framework=jax model={model}")


def _run_appsrc(pkg, desc, frames):
    caps = (f"other/tensors,format=static,num_tensors=1,"
            f"dimensions=3:{SIZE}:{SIZE}:1,types=uint8")
    pipe = pkg.parse_launch(f"appsrc name=src caps={caps} "
                            f"max-buffers={len(frames) + 1} ! {desc} ! "
                            "tensor_sink name=out")
    src = pipe.get("src")
    for i, f in enumerate(frames):
        src.push([f], pts=i)
    src.end_of_stream()
    msg = pipe.run(timeout=WAIT)
    assert msg is not None and msg.kind == "eos", msg
    return [np.asarray(b.to_host()[0]) for b in pipe.get("out").buffers], \
        [b.pts for b in pipe.get("out").buffers]


def test_narrow_flagship_fleet_matches_in_process_and_jax(tmp_path):
    apply_fn, variables, in_info, out_info = jax_mobilenet_v2(
        num_classes=CLASSES, width=WIDTH, image_size=SIZE,
        dtype=jnp.float32, seed=0)
    module = MobileNetV2(num_classes=CLASSES, width=WIDTH)
    module.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                        variables)))
    path = tmp_path / "mnv2.pt"
    torch.save(module.eval(), path)
    frames = _frames(FRAMES)
    from nnstreamer_tpu_torch.query.pubsub import Broker

    broker = Broker(port=0).start()
    fl = FleetLauncher(
        replicas=2, operation="tf-mnv2", metrics=True,
        env={"NNSTPU_TORCH_DEVICE": "cpu"},
        broker_port=broker.port, state_dir=str(tmp_path / "fleet"),
        desc=("tensor_query_serversrc port=0 operation=tf-mnv2 "
              f"broker-host=127.0.0.1 broker-port={broker.port} "
              "reliable=true advertise-interval-s=0.25 "
              "metrics-port={metrics_port} ! "
              + BODY.format(model=path) + " ! tensor_query_serversink"))
    fl.start()
    try:
        assert len(fl.endpoints(timeout=BOOT_S * 2)) == 2
        client = ("tensor_quant_enc ! tensor_query_client operation=tf-mnv2 "
                  f"broker-port={fl.broker_port} reliable=true "
                  "balance=shortest-slack max-in-flight=8 timeout=30")
        got, pts = _run_appsrc(tnt, client, frames)
        fed = FederatedMetrics(operation="tf-mnv2",
                               broker_port=fl.broker_port)
        assert len(fed.discover(timeout=BOOT_S)) == 2
        view = fed.collect()
        # each replica's own counts, from its /metrics.json
        scrapes = [fed.scrape_one(h, p) for h, p in fed.endpoints]
    finally:
        fl.stop()
        broker.stop()
    want, _ = _run_appsrc(tnt, "tensor_quant_enc ! " +
                          BODY.format(model=path), frames)
    assert pts == list(range(FRAMES))
    assert len(got) == FRAMES
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and a.shape == (1, CLASSES)
        assert a.tobytes() == b.tobytes()
    served = sum(c["value"] for c in view["counters"]
                 if c["name"] == "nns_query_requests_total")
    assert served == FRAMES
    # on the CPU no kernel launches; every frame a replica served is one
    # dispatch of its fused region, which captures nothing
    assert all(snap["launches"] == {"normalize_chain": 0,
                                    "flash_attention": 0,
                                    "quantize_int8": 0} for snap in scrapes)
    regions = [r for snap in scrapes for r in snap["regions"].values()]
    assert len(regions) == 2
    assert all(any("filter" in m for m in r["members"]) for r in regions)
    assert sum(r["eager_frames"] + r["replays"] for r in regions) == FRAMES
    assert sum(r["captures"] for r in regions) == 0
    register_jax_model("fleet_mnv2", apply_fn, variables, in_info=in_info,
                       out_info=out_info)
    try:
        ref, _ = _run_appsrc(jnt, "tensor_quant_enc ! " +
                             BODY.format(model="fleet_mnv2"), frames)
    finally:
        unregister_jax_model("fleet_mnv2")
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(b).max()))
