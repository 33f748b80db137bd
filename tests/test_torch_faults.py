"""Deterministic fault injection in the PyTorch port (``pipeline/faults.py``),
held to the JAX package's injector.

- The same spec and seed fire the same occurrences at every site for
  n ≤ 10,000, under ``rate``, ``nth`` and ``every``: the decision is a pure
  function of ``(seed, site, n)`` in both packages.
- The spec grammar, its errors, the kinds' exception classes, the
  ``nns_fault_injected_total{site,kind}`` counter and the ledger mark
  are the JAX module's.
- Every compute-site hook of the port fires in a pipeline and halts it
  as the JAX package's does; the MQTT client's ``mqtt.publish`` hook
  drops, disconnects and corrupts as the JAX client's does. The
  ``grpc.call`` hook is held to the JAX bridge's in
  ``tests/test_torch_grpc.py``.
"""

import time


import numpy as np
import pytest

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.pipeline import faults as jfaults
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.obs import timeline as _timeline
from nnstreamer_tpu_torch.pipeline import faults
from nnstreamer_tpu_torch.pipeline.element import FlowError
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)

import torch


@pytest.fixture(autouse=True)
def _no_active_injector():
    faults.deactivate()
    jfaults.deactivate()
    yield
    faults.deactivate()
    jfaults.deactivate()


def _drive(inj, site, n):
    """Occurrences 1..n at ``site``; the fired ones, in order."""
    fired = []
    for i in range(1, n + 1):
        try:
            inj.check(site)
        except Exception:  # noqa: BLE001 — every injected kind raises here
            fired.append(i)
    return fired


# -- the fired set, against the JAX injector ------------------------------------
SPECS = [
    ("filter.invoke:rate=0.01", 0),
    ("filter.invoke:rate=0.05", 3),
    ("queue.push:rate=0.2,seed=11", 5),
    ("transfer.h2d:rate=0.001", 99),
    ("transfer.d2h:rate=0.5", 2 ** 40 + 7),
    ("pool.alloc:nth=37", 0),
    ("dispatch.fence:every=13", 0),
    ("lane.worker:every=1000,kind=crash", 0),
    ("filter.open:nth=10000,kind=oom", 1),
    ("filter.invoke:rate=0.3,kind=crash", 7),
]


@pytest.mark.parametrize("spec,seed", SPECS)
def test_fired_set_matches_jax(spec, seed):
    site = spec.split(":", 1)[0]
    mine = faults.FaultInjector(faults.parse_faults(spec), seed=seed)
    ref = jfaults.FaultInjector(jfaults.parse_faults(spec), seed=seed)
    got = _drive(mine, site, 10_000)
    want = _drive(ref, site, 10_000)
    assert got == want and got
    assert mine.fired_set(site) == ref.fired_set(site) == got
    assert mine.fired == ref.fired
    assert mine.snapshot() == ref.snapshot()


def test_multi_site_spec_matches_jax():
    spec = ("filter.invoke:rate=0.02;queue.push:every=7;"
            "transfer.h2d:nth=3")
    mine = faults.FaultInjector(faults.parse_faults(spec), seed=4)
    ref = jfaults.FaultInjector(jfaults.parse_faults(spec), seed=4)
    sites = ("filter.invoke", "queue.push", "transfer.h2d", "pool.alloc")
    for i in range(3000):
        site = sites[i % len(sites)]
        for inj in (mine, ref):
            try:
                inj.check(site)
            except Exception:  # noqa: BLE001
                pass
    assert mine.fired == ref.fired
    for site in sites:
        assert mine.injected(site) == ref.injected(site)


def test_parse_matches_jax():
    spec = ("filter.invoke:rate=0.25,kind=crash,seed=9;"
            "dispatch.fence:nth=5,kind=stall,ms=5000; queue.push:every=3")
    mine = faults.parse_faults(spec)
    ref = jfaults.parse_faults(spec)
    assert [vars(r) for r in mine] == [vars(r) for r in ref]
    assert faults.SITES == jfaults.SITES
    assert faults.KINDS == jfaults.KINDS


@pytest.mark.parametrize("bad", [
    "filter.nope:rate=0.1", "filter.invoke:kind=explode",
    "filter.invoke:when=3",
])
def test_bad_spec_raises_as_jax(bad):
    with pytest.raises(ValueError) as mine:
        faults.parse_faults(bad)
    with pytest.raises(ValueError) as ref:
        jfaults.parse_faults(bad)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("kind,cls", [
    ("raise", "InjectedFault"), ("crash", "InjectedCrash"),
    ("oom", "InjectedOom"), ("drop", "InjectedFault"),
])
def test_check_kinds_raise_the_jax_classes(kind, cls):
    for mod in (faults, jfaults):
        inj = mod.FaultInjector(mod.parse_faults(
            f"filter.invoke:nth=1,kind={kind}"))
        with pytest.raises(getattr(mod, cls)) as err:
            inj.check("filter.invoke")
        assert type(err.value).__name__ == cls
        assert err.value.kind == kind
        assert str(err.value) == \
            "injected fault at filter.invoke (occurrence 1)"


def test_env_activation(monkeypatch):
    monkeypatch.delenv("NNSTPU_FAULTS", raising=False)
    assert faults.maybe_activate_env() is None and faults.ACTIVE is None
    monkeypatch.setenv("NNSTPU_FAULTS", "queue.push:rate=0.5")
    monkeypatch.setenv("NNSTPU_FAULTS_SEED", "17")
    inj = faults.maybe_activate_env()
    assert inj is faults.ACTIVE and inj.seed == 17
    assert faults.maybe_activate_env() is inj  # idempotent
    faults.deactivate()
    monkeypatch.setenv("NNSTPU_FAULTS_SEED", "x")
    assert faults.maybe_activate_env().seed == 0
    faults.deactivate()
    monkeypatch.setenv("NNSTPU_FAULTS", "mqtt.publish:rate=0.5,kind=drop")
    inj = faults.maybe_activate_env()
    assert inj is faults.ACTIVE and list(inj._rules) == ["mqtt.publish"]
    faults.deactivate()


def _publish_under_fault(mod, fmod, spec, qos):
    """Six payloads published by ``mod``'s MqttClient under ``spec`` to a
    subscriber on the port's broker: (payloads received in order, the
    injector's fired list, the publisher's reconnects)."""
    from nnstreamer_tpu_torch.query.mqtt import MqttBroker, MqttClient

    broker = MqttBroker()
    got = []
    sub = MqttClient(port=broker.port)
    sub.subscribe("f/t", lambda t, p: got.append(p), qos=qos)
    pub = mod.MqttClient(port=broker.port, keepalive=2)
    inj = fmod.activate(spec, seed=4)
    try:
        for i in range(6):
            if i == 2 and "disconnect" in spec:
                # the link went down at the second publish: wait for the
                # reader's reconnect before the next one
                deadline = time.monotonic() + 15
                while pub.reconnects == 0 and time.monotonic() < deadline:
                    time.sleep(0.02)
            if qos:
                pub.publish("f/t", b"m%d" % i, qos=1, timeout=10.0)
            else:
                pub.publish("f/t", b"m%d" % i)
        deadline = time.monotonic() + 5
        want = 6 if qos else 5
        while len(got) < want and time.monotonic() < deadline:
            time.sleep(0.02)
        time.sleep(0.2)  # nothing more may arrive
        return list(got), list(inj.fired), pub.reconnects
    finally:
        fmod.deactivate()
        pub.close()
        sub.close()
        broker.close()


@pytest.mark.parametrize("kind,qos", [("drop", 0), ("disconnect", 0),
                                      ("corrupt", 0), ("drop", 1)])
def test_mqtt_publish_fires_as_jax(kind, qos):
    """``mqtt.publish`` at its second occurrence: a QoS0 payload is lost
    (dropped, sent into a severed link, or replaced by a reserved packet
    the broker ignores), the others arrive in order; a dropped QoS1 first
    copy arrives by its DUP retransmission. The JAX client loses the same
    payload and fires the same occurrence."""
    from nnstreamer_tpu.query import mqtt as jmqtt
    from nnstreamer_tpu_torch.query import mqtt as tmqtt

    spec = f"mqtt.publish:nth=2,kind={kind}"
    port = _publish_under_fault(tmqtt, faults, spec, qos)
    jax = _publish_under_fault(jmqtt, jfaults, spec, qos)
    want = [b"m%d" % i for i in range(6) if qos or i != 1]
    assert port[0] == jax[0] == want
    assert port[1] == jax[1] == [("mqtt.publish", 2, kind)]
    assert port[2] == jax[2] == (1 if kind == "disconnect" else 0)


def test_metric_and_mark_count_each_fire():
    c = get_registry().counter("nns_fault_injected_total", "",
                               site="transfer.h2d", kind="raise")
    c0 = c.value
    with _timeline.tracing() as tl:
        inj = faults.FaultInjector(faults.parse_faults(
            "transfer.h2d:every=4"))
        for i in range(20):
            try:
                inj.check("transfer.h2d", seq=i)
            except faults.InjectedFault:
                pass
    assert c.value - c0 == 5
    marks = [r for r in tl._snapshot() if r[1] == "fault"]
    assert [r[2] for r in marks] == [3, 7, 11, 15, 19]
    assert all(r[5] == "faults" for r in marks)


def test_action_verdicts_match_jax():
    for kind in ("drop", "disconnect", "corrupt"):
        for mod in (faults, jfaults):
            inj = mod.FaultInjector(mod.parse_faults(
                f"filter.invoke:nth=2,kind={kind}"))
            assert inj.action("filter.invoke") is None
            assert inj.action("filter.invoke") == kind


def test_stall_ends_on_release():
    import threading
    import time

    inj = faults.FaultInjector(faults.parse_faults(
        "dispatch.fence:nth=1,kind=stall,ms=20000"))
    done = threading.Event()

    def stall():
        inj.check("dispatch.fence")
        done.set()

    t = threading.Thread(target=stall, daemon=True)
    t.start()
    time.sleep(0.1)
    assert not done.is_set()
    t0 = time.monotonic()
    inj.release_stalls()
    assert done.wait(5) and time.monotonic() - t0 < 2
    inj.check("dispatch.fence")  # later stalls return at once


# -- every compute-site hook fires in a pipeline ---------------------------------
class _Double(torch.nn.Module):
    def forward(self, x):
        return x.float() * 2.0


@pytest.fixture
def cpu_model():
    tnt.set_device("cpu")
    register_torch_model("faults_double", _Double())
    yield "faults_double"
    unregister_torch_model("faults_double")
    tnt.set_device(None)


SITE_PIPES = {
    "queue.push": "videotestsrc num-buffers=6 width=8 height=8 ! "
                  "tensor_converter ! queue ! tensor_sink name=out",
    "filter.invoke": "videotestsrc num-buffers=6 width=8 height=8 ! "
                     "tensor_converter ! tensor_filter framework=jax "
                     "model={m} ! tensor_sink name=out",
    "filter.open": "videotestsrc num-buffers=6 width=8 height=8 ! "
                   "tensor_converter ! tensor_filter framework=jax "
                   "model={m} ! tensor_sink name=out",
    "transfer.h2d": "videotestsrc num-buffers=6 width=8 height=8 ! "
                    "tensor_converter ! queue prefetch-device=true "
                    "batch-h2d=false ! tensor_sink name=out",
    "pool.alloc": "videotestsrc num-buffers=6 width=8 height=8 "
                  "pattern=ball ! tensor_converter ! tensor_sink name=out",
    "dispatch.fence": "videotestsrc num-buffers=6 width=8 height=8 ! "
                      "tensor_converter ! tensor_filter framework=jax "
                      "model={m} inflight=0 ! tensor_sink name=out",
    "lane.worker": "videotestsrc num-buffers=6 width=8 height=8 ! "
                   "tensor_converter ! queue ! tensor_sink name=out",
}


@pytest.mark.parametrize("site", sorted(SITE_PIPES))
@pytest.mark.parametrize("fuse", [False, True])
def test_each_compute_hook_fires_and_halts(cpu_model, site, fuse):
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

    desc = SITE_PIPES[site].format(m=cpu_model)
    faults.activate(f"{site}:nth=1")
    lanes = 2 if site == "lane.worker" else 1
    pipe = tnt.parse_launch(desc, pipeline=Pipeline(fuse=fuse), lanes=lanes)
    # filter.open fires in start(), before any streaming thread: it
    # raises from run() itself, as in the JAX package
    with pytest.raises((FlowError, faults.InjectedFault),
                       match=f"injected fault at {site}"):
        pipe.run(timeout=60)
    assert faults.ACTIVE.injected(site) == 1


def test_unset_env_is_the_off_path(monkeypatch, cpu_model):
    monkeypatch.delenv("NNSTPU_FAULTS", raising=False)
    outs = []
    pipe = tnt.parse_launch(SITE_PIPES["filter.invoke"].format(m=cpu_model))
    pipe.get("out").connect(lambda b: outs.append(np.asarray(b.tensors[0])))
    pipe.run(timeout=60)
    assert faults.ACTIVE is None and len(outs) == 6
    ref = jnt.parse_launch(
        "videotestsrc num-buffers=6 width=8 height=8 ! tensor_converter ! "
        "tensor_sink name=out")
    routs = []
    ref.get("out").connect(lambda b: routs.append(np.asarray(b.tensors[0])))
    ref.run(timeout=60)
    for a, b in zip(outs, routs):
        np.testing.assert_array_equal(a, b.astype(np.float32) * 2.0)
