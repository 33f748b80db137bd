"""The HBM accountant of the PyTorch port (``nnstreamer_tpu_torch/tensors/
memory.py``), its hooks in the staging pool, the transfers, the
scheduler and the pressure ladder, held to the JAX package's
``tests/test_memory.py``.

Each accounting case runs the same sequence of register, evict and
pressure calls through both packages' accountants and compares their
``snapshot()`` numbers exactly (integers: no tolerance). The ladder runs
an injected ``kind=oom`` under ``error-policy=degrade`` through a
pipeline of each package and compares the delivered frames bit for bit
(the models are ``x * w[0, 0]`` in float32 on both sides, one rounding)
and the ``nns_mem_pressure_events_total{rung}`` counts exactly.
"""

import gc

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
from nnstreamer_tpu.obs import get_registry as jax_registry
from nnstreamer_tpu.pipeline import faults as jfaults
from nnstreamer_tpu.tensors import memory as jmemory
from nnstreamer_tpu.tensors.pool import BufferPool as JaxPool
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.pipeline import faults
from nnstreamer_tpu_torch.pipeline.dispatch import (
    POOL_STASH_META,
    release_shed_payload,
)
from nnstreamer_tpu_torch.serving.scheduler import SloScheduler
from nnstreamer_tpu_torch.tensors import memory
from nnstreamer_tpu_torch.tensors.buffer import (
    H2D_EXCLUSIVE_META,
    TensorBuffer,
)
from nnstreamer_tpu_torch.tensors.pool import BufferPool, get_pool


@pytest.fixture(autouse=True)
def _clean_slate():
    for mod in (faults, jfaults, memory, jmemory):
        mod.deactivate()
    yield
    for mod in (faults, jfaults, memory, jmemory):
        mod.deactivate()


@pytest.fixture(autouse=True)
def _restore_jax_memory_counters():
    """The JAX package's ``tests/test_memory.py`` reads its accountant's
    process-wide eviction and prefetch counters as absolute counts, and
    a test worker runs several files: what a test here adds to the JAX
    package's counters is taken back after it."""
    from nnstreamer_tpu.obs import get_registry as jax_reg

    keys = [("nns_mem_evictions_total", ()), ("nns_mem_prefetches_total", ())]
    keys += [("nns_mem_pressure_events_total", (("rung", r),))
             for r in ("evict", "pool", "shed", "cpu")]
    saved = {}
    for name, labels in keys:
        m = jax_reg().get(name, **dict(labels))
        saved[name, labels] = 0.0 if m is None else m.value
    yield
    for (name, labels), value in saved.items():
        m = jax_reg().get(name, **dict(labels))
        if m is not None:
            with m._lock:
                m._value = value


def _cval(name, reg=get_registry, **labels):
    m = reg().get(name, **labels)
    return 0.0 if m is None else m.value


def _accounting(snap):
    """The accountant's own figures (the port adds the allocator's)."""
    return {k: v for k, v in snap.items() if k != "allocator"}


# -- parse_bytes ---------------------------------------------------------------
@pytest.mark.parametrize("text", ["512", "512b", "4k", "16K", "6m", "2g",
                                  " 8M ", "1.5m"])
def test_parse_bytes_as_jax(text):
    assert memory.parse_bytes(text) == jmemory.parse_bytes(text)


@pytest.mark.parametrize("text", ["", "cat", "12q", "-4k", "0"])
def test_parse_bytes_rejects_as_jax(text):
    for mod in (memory, jmemory):
        with pytest.raises(ValueError):
            mod.parse_bytes(text)


# -- the accountant --------------------------------------------------------------
def _register_sequence(mod):
    acct = mod.activate(1000)
    acct.register(400, "pool", reclaim=False)
    acct.register(300, "frames", reclaim=False)
    mid = (acct.used_bytes(), acct.headroom(), acct.breached())
    acct.register(500, "weights", reclaim=False)
    over = (acct.breached(), acct.overage(), acct.high_water)
    acct.unregister(300, "frames")
    acct.unregister(500, "weights")
    return mid, over, _accounting(acct.snapshot())


def test_register_unregister_and_high_water_as_jax():
    got = _register_sequence(memory)
    assert got == _register_sequence(jmemory)
    mid, over, snap = got
    assert mid == (700, 300, False) and over == (True, 200, 1200)
    assert snap["used_by_category"] == {"pool": 400}
    assert snap["high_water_bytes"] == 1200


def test_underflow_warns_but_never_goes_negative():
    for mod in (memory, jmemory):
        acct = mod.activate(1000)
        acct.register(100, "pool", reclaim=False)
        acct.unregister(250, "pool")
        assert acct.used_bytes() == 0
        assert "pool" not in acct.snapshot()["used_by_category"]


def test_env_kill_switch(monkeypatch):
    monkeypatch.delenv("NNSTPU_HBM_BUDGET", raising=False)
    assert memory.maybe_activate_env() is None and memory.ACTIVE is None
    monkeypatch.setenv("NNSTPU_HBM_BUDGET", "64k")
    acct = memory.maybe_activate_env()
    assert acct is memory.ACTIVE and acct.limit == 64 << 10
    explicit = memory.activate(123)
    monkeypatch.setenv("NNSTPU_HBM_BUDGET", "1g")
    assert memory.maybe_activate_env() is explicit
    assert memory.ACTIVE.limit == 123


def test_pool_slabs_register_and_release_as_jax():
    """A slab registers at growth, stays registered on the free list, and
    unregisters when the pool drops it — the same bytes in both pools."""
    held = {}
    for name, mod, Pool in (("port", memory, BufferPool),
                            ("jax", jmemory, JaxPool)):
        acct = mod.activate(1 << 20)
        pool = Pool(name=f"membudget-{name}")
        a = pool.acquire((1024,), np.uint8)
        held[name] = acct.snapshot()["used_by_category"].get("pool", 0)
        pool.release(a)
        assert acct.snapshot()["used_by_category"].get("pool", 0) == \
            held[name]
        del a
        pool.clear()
        assert acct.snapshot()["used_by_category"].get("pool", 0) == 0
        mod.deactivate()
    assert held["port"] == held["jax"] >= 1024


def test_h2d_bytes_track_the_wrapper_lifetime():
    acct = memory.activate(1 << 20)
    buf = TensorBuffer([np.zeros(1024, np.float32)]).to_device(
        torch.device("cpu"))
    assert acct.snapshot()["used_by_category"].get("frames", 0) == 4096
    del buf
    gc.collect()
    assert acct.snapshot()["used_by_category"].get("frames", 0) == 0


def test_snapshot_reports_the_allocator_only_on_a_card():
    acct = memory.activate(1 << 20)
    assert ("allocator" in acct.snapshot()) == (
        tnt.get_device().type == "cuda" and torch.cuda.is_available())


@pytest.mark.parametrize("obj,want", [
    (torch.zeros(3, 4), 48),
    ({"a": torch.zeros(2, dtype=torch.bfloat16), "b": np.zeros(3)}, 28),
    ([torch.zeros(1, dtype=torch.int64), (np.zeros(2, np.int8),)], 10),
])
def test_nbytes_of(obj, want):
    assert memory.nbytes_of(obj) == want


def test_nbytes_of_a_module_is_its_state_dict():
    m = torch.nn.Linear(4, 3)
    assert memory.nbytes_of(m) == (4 * 3 + 3) * 4 == \
        jmemory.pytree_nbytes([np.zeros((4, 3), np.float32),
                               np.zeros(3, np.float32)])


# -- residency -------------------------------------------------------------------
def _loader(host):
    return [np.asarray(h).copy() for h in host]


def _lru_sequence(mod):
    acct = mod.activate(10_000)
    res = acct.residency
    a = res.register("a", [np.arange(8)], 4000, _loader)
    b = res.register("b", [np.arange(8) * 2], 4000, _loader)
    c = res.register("c", [np.arange(8) * 3], 4000, _loader)
    trace = [res.resident_count()]
    a.value(), b.value()
    trace.append((a.resident, b.resident, res.resident_count()))
    c.value()
    trace.append((a.resident, b.resident, c.resident, acct.used_bytes()))
    va2 = a.value()
    trace.append((a.resident, b.resident, c.resident,
                  va2[0].tolist(), a.loads, a.evictions))
    snap = _accounting(acct.snapshot())
    for u in snap["units"]:
        u.pop("group", None)
    return trace, snap


def test_lru_evicts_coldest_and_prefetches_back_as_jax():
    got = _lru_sequence(memory)
    assert got == _lru_sequence(jmemory)
    trace, snap = got
    assert trace[2][:3] == (False, True, True)
    assert snap["evictions"] == 2 and snap["prefetches"] == 1


def test_unregister_frees_budget():
    acct = memory.activate(10_000)
    res = acct.residency
    freed = []
    u = res.register("u", [np.zeros(4)], 4000, _loader,
                     on_evict=lambda: freed.append(1))
    u.value()
    assert acct.used_bytes() == 4000
    res.unregister("u")
    assert acct.used_bytes() == 0 and res.resident_count() == 0
    assert freed == [1]  # the storage was freed too


def test_breach_reclaims_cold_units_inline_as_jax():
    for mod in (memory, jmemory):
        acct = mod.activate(8000)
        u = acct.residency.register("u", [np.zeros(4)], 4000, _loader)
        u.value()
        acct.register(6000, "frames")
        assert not u.resident
        assert acct.snapshot()["pressure_events"] == 1
        acct.unregister(6000, "frames")


def test_a_held_unit_is_never_an_eviction_victim():
    acct = memory.activate(8000)
    res = acct.residency
    a = res.register("a", [np.zeros(4)], 4000, _loader)
    b = res.register("b", [np.zeros(4)], 6000, _loader)
    with res.hold(a) as loads:
        assert loads == 1 and a.busy == 1
        b.value()  # needs a's room, but a is being read
        assert a.resident and b.resident and acct.breached()
    assert a.busy == 0
    res.reclaim(0)
    assert not a.resident  # released: now it goes
    with res.hold(a) as loads:
        assert loads == 2  # new storage: a fused region recaptures


def test_a_held_unit_unregistered_keeps_its_storage_until_released():
    """A swap retires the old epoch's unit: while a dispatch still holds
    it, its storage and bytes stay; the last hold's end frees both."""
    acct = memory.activate(8000)
    res = acct.residency
    freed = []
    u = res.register("u", [np.zeros(4)], 4000, _loader,
                     on_evict=lambda: freed.append(1))
    with res.hold(u):
        res.unregister("u")
        assert u.resident and freed == [] and acct.used_bytes() == 4000
        assert res.resident_count() == 0  # gone from the LRU already
    assert not u.resident and freed == [1] and acct.used_bytes() == 0


def test_droppable_units_ride_the_evict_rung():
    acct = memory.activate(10_000)
    dropped = []
    acct.residency.register_droppable("p", 3000, dropped.append)
    assert acct.snapshot()["used_by_category"] == {"kvcache": 3000}
    assert acct.residency.evict_all() == 3000
    assert dropped == ["p"] and acct.used_bytes() == 0


def test_residency_lru_order_restored_by_label():
    acct = memory.activate(1 << 20)
    res = acct.residency
    units = {n: res.register(f"k:{n}", np.zeros(4), 16, lambda h: h,
                             label=n) for n in ("ua", "ub", "uc")}
    units["ua"].value()
    state = res.checkpoint_state()
    assert state["lru"] == ["ub", "uc", "ua"]
    memory.deactivate()
    res2 = memory.activate(1 << 20).residency
    for n in ("ua", "ub", "uc"):
        res2.register(f"k2:{n}", np.zeros(4), 16, lambda h: h, label=n)
    res2.restore_state(state)
    assert [u.label for u in res2._units.values()] == ["ub", "uc", "ua"]


# -- the oom fault kind ------------------------------------------------------------
@pytest.mark.parametrize("site", ["pool.alloc", "transfer.h2d",
                                  "filter.open", "filter.invoke"])
def test_oom_raises_at_every_contract_site(site):
    fi = faults.activate(f"{site}:nth=1,kind=oom", seed=3)
    with pytest.raises(faults.InjectedOom) as ei:
        fi.check(site)
    assert ei.value.kind == "oom" and site in str(ei.value)


def test_oom_is_classified_as_memory_pressure():
    from nnstreamer_tpu_torch.pipeline.supervise import _is_memory_pressure

    assert _is_memory_pressure(faults.InjectedOom("pool.alloc", 1))
    assert _is_memory_pressure(torch.cuda.OutOfMemoryError("CUDA oom"))
    assert _is_memory_pressure(RuntimeError("CUDA out of memory. Tried"))
    assert not _is_memory_pressure(RuntimeError("shape mismatch"))


def test_pool_alloc_site_fires_on_slab_miss():
    fi = faults.activate("pool.alloc:nth=1,kind=oom", seed=3)
    pool = BufferPool(name="oomsite-test")
    with pytest.raises(faults.InjectedOom):
        pool.acquire((64,), np.uint8)
    a = pool.acquire((64,), np.uint8)
    pool.release(a)
    b = pool.acquire((64,), np.uint8)
    assert fi.injected("pool.alloc") == 1
    pool.release(b)
    pool.clear()


# -- shed frames free their payload now ----------------------------------------------
def test_shed_pool_stash_returns_to_pool():
    pool = get_pool()
    arr = pool.acquire((256,), np.uint8)
    assert pool.owns(arr)
    buf = TensorBuffer([np.zeros(4, np.float32)])
    buf.meta[POOL_STASH_META] = [arr]
    release_shed_payload(buf)
    assert POOL_STASH_META not in buf.meta and not pool.owns(arr)


def test_scheduler_shed_path_releases_an_exclusive_payload():
    sched = SloScheduler(budget_ms=100.0, name="memshed-port")
    # a tensor off the host stands for the card's upload (a CPU tensor is
    # host memory, which the shed leaves alone)
    buf = TensorBuffer([torch.ones(4, device="meta")])
    buf.meta.update({"admitted_t": 0.0, "deadline_t": 0.0,
                     H2D_EXCLUSIVE_META: True})
    sched.note_shed(buf, now=1.0)
    assert "admitted_t" not in buf.meta and len(buf.tensors) == 0


# -- the scheduler's memory term -------------------------------------------------------
def test_admission_backlog_from_overage_as_jax():
    for mod in (memory, jmemory):
        acct = mod.activate(1000)
        assert acct.admission_backlog() == 0
        acct.register(1500, "weights", reclaim=False)
        assert acct.admission_backlog() == 1
        acct._frame_bytes_ewma = 100.0
        assert acct.admission_backlog() == 5
        mod.deactivate()


def test_decide_sheds_under_pressure_and_self_heals():
    sched = SloScheduler(budget_ms=50.0, name="memterm-port")
    sched.observe_service(0.010)
    assert sched.decide(now=0.0, backlog=0)[0]
    acct = memory.activate(1000)
    acct.register(2000, "weights", reclaim=False)
    acct._frame_bytes_ewma = 100.0  # 10 frames of overage
    admit, _, slack = sched.decide(now=0.0, backlog=0)
    assert not admit and slack < 0
    acct.unregister(2000, "weights")
    assert sched.decide(now=0.0, backlog=0)[0]


# -- the pressure ladder, both packages --------------------------------------------------
N_FRAMES = 24
LADDER = ("videotestsrc pattern=ball num-buffers={n} width=8 height=8 ! "
          "tensor_converter ! queue name=q max-size-buffers=8 ! "
          "tensor_filter framework=jax model={m} name=f ! "
          "queue materialize-host=true ! tensor_sink name=out")


class _Ballast(torch.nn.Module):
    """``x * w[0, 0]`` in float32 over a [128, 128] float32 weight (64
    KiB): a lost or corrupted weight shows in the bytes."""

    def __init__(self, scale):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((128, 128), float(scale)),
                                    requires_grad=False)

    def forward(self, x):
        return x.to(torch.float32) * self.w[0, 0]


@pytest.fixture
def ballast_models():
    tnt.set_device("cpu")
    register_torch_model("mem_l", _Ballast(2.5))
    register_jax_model(
        "mem_l", lambda p, x: (x.astype(jnp.float32) * p["w"][0, 0],),
        {"w": jnp.ones((128, 128), jnp.float32) * 2.5})
    yield "mem_l"
    unregister_torch_model("mem_l")
    unregister_jax_model("mem_l")
    tnt.set_device(None)


def _run(pkg, desc, policy=None):
    mod = tnt if pkg == "port" else jnt
    pipe = mod.parse_launch(desc, **({"error_policy": policy}
                                     if policy else {}))
    outs = []
    pipe.get("out").connect(
        lambda b: outs.append(np.asarray(b.tensors[0]).copy()))
    msg = pipe.run(timeout=120)
    assert msg is not None and msg.kind == "eos", msg
    return pipe, outs


@pytest.mark.parametrize("budget", [True, False])
def test_injected_oom_climbs_the_ladder_as_jax(ballast_models, budget):
    """``kind=oom`` at the 5th invoke under ``degrade``: both packages
    recover at the ``evict`` rung (with no accountant the rung is a
    no-op and the retry passes), deliver every frame bit-identical to
    their unfaulted runs, and never reach ``cpu``."""
    desc = LADDER.format(n=N_FRAMES, m=ballast_models)
    counts = {}
    for pkg, mem, flt, reg in (("port", memory, faults, get_registry),
                               ("jax", jmemory, jfaults, jax_registry)):
        _, base = _run(pkg, desc)
        if budget:
            mem.activate(1 << 20)
        fi = flt.activate("filter.invoke:nth=5,kind=oom", seed=7)
        # the JAX ladder's fourth rung, ``cpu``, is read on both sides:
        # the port has no such rung (ROADMAP C.29) and counts none
        rungs = memory.PRESSURE_RUNGS + ("cpu",)
        before = {r: _cval("nns_mem_pressure_events_total", reg, rung=r)
                  for r in rungs}
        pipe, outs = _run(pkg, desc, policy="degrade")
        assert fi.injected("filter.invoke") == 1
        assert len(outs) == len(base) == N_FRAMES
        for a, b in zip(outs, base):
            np.testing.assert_array_equal(a, b)
        counts[pkg] = {r: _cval("nns_mem_pressure_events_total", reg,
                                rung=r) - before[r]
                       for r in rungs}
        assert pipe.get("f").get_property("accelerator") in (None, "")
        flt.deactivate()
        mem.deactivate()
    assert counts["port"] == counts["jax"]
    assert counts["port"]["evict"] == (1 if budget else 0)
    assert counts["port"]["cpu"] == 0 and "cpu" not in memory.PRESSURE_RUNGS


def test_two_faults_one_run_reopen_once_each(ballast_models):
    """Two ordinary faults under ``degrade``: one reload each, no window
    entry left behind, no CPU rung."""
    desc = LADDER.format(n=120, m=ballast_models)
    _, base = _run("port", desc)
    fi = faults.activate("filter.invoke:every=50,kind=raise", seed=5)
    pipe, outs = _run("port", desc, policy="degrade")
    assert fi.injected("filter.invoke") == 2
    assert len(outs) == len(base)
    for a, b in zip(outs, base):
        np.testing.assert_array_equal(a, b)
    el = pipe.get("f")
    assert el.get_property("accelerator") is None
    assert len(el._window) == 0


def test_budget_unset_is_a_noop(ballast_models, monkeypatch):
    monkeypatch.delenv("NNSTPU_HBM_BUDGET", raising=False)
    pipe, outs = _run("port", LADDER.format(n=6, m=ballast_models))
    assert memory.ACTIVE is None and len(outs) == 6
    assert "memory" not in pipe.metrics_snapshot()


def test_env_budget_reports_memory_in_the_snapshot(ballast_models,
                                                   monkeypatch):
    monkeypatch.setenv("NNSTPU_HBM_BUDGET", "4m")
    pipe, outs = _run("port", LADDER.format(n=6, m=ballast_models))
    assert memory.ACTIVE is not None and memory.ACTIVE.limit == 4 << 20
    snap = pipe.metrics_snapshot()["memory"]
    assert snap["budget_bytes"] == 4 << 20
    # the weights registered at open and left at stop
    assert snap["high_water_bytes"] >= 128 * 128 * 4
    assert snap["used_by_category"].get("weights", 0) == 0


# -- the LM engine under the accountant ----------------------------------------------
def _lm():
    from nnstreamer_tpu_torch.models import transformer as ttr

    cfg = ttr.TransformerConfig(vocab=97, d_model=64, n_heads=4, n_layers=2,
                                d_ff=128, max_seq=64, dtype=torch.float32)
    return cfg, ttr.init_params(cfg, seed=3)


LM_PROMPTS = [[5, 11, 23, 42, 7], [4, 8, 15], [5, 11, 23, 42, 7],
              [9] * 17, [5, 11, 23, 42, 7, 1]]


def _engine(**kw):
    from nnstreamer_tpu_torch.serving import ContinuousBatchingEngine

    cfg, params = _lm()
    args = dict(max_streams=3, steps_per_dispatch=4, device="cpu")
    args.update(kw)
    return ContinuousBatchingEngine(cfg, params, **args).start()


def _generate(eng, prompts, n=6):
    return [eng.generate(p, max_new_tokens=n, timeout=120) for p in prompts]


def test_paged_arena_registers_its_bytes_under_kvcache():
    plain = _engine(block_tokens=8, kv_blocks=32)
    try:
        want = _generate(plain, LM_PROMPTS)
    finally:
        plain.close()
    acct = memory.activate(1 << 30)
    eng = _engine(block_tokens=8, kv_blocks=32)
    try:
        assert acct.snapshot()["used_by_category"] == \
            {"kvcache": eng._pool.nbytes}
        assert _generate(eng, LM_PROMPTS) == want
    finally:
        eng.close()
    assert acct.used_bytes() == 0
    eng.close()  # idempotent
    assert acct.used_bytes() == 0


def test_prefix_cache_entries_are_droppable_and_net_out_at_close():
    plain = _engine(prefix_cache=4)
    try:
        want = _generate(plain, LM_PROMPTS)
    finally:
        plain.close()
    acct = memory.activate(1 << 30)
    eng = _engine(prefix_cache=4)
    try:
        got = _generate(eng, LM_PROMPTS)
        used = acct.snapshot()["used_by_category"].get("kvcache", 0)
        assert used > 0 and len(eng._prefix_acct) == len(eng._prefix) > 0
        # the evict rung revokes every entry; the engine thread reaps
        assert acct.residency.evict_all() == used
        assert acct.used_bytes() == 0
        again = _generate(eng, LM_PROMPTS[:1])
        assert again == want[:1]
    finally:
        eng.close()
    assert got == want
    assert acct.used_bytes() == 0 and eng._prefix_acct == {}


def test_a_starved_pool_counts_shed_and_evict_rungs():
    shed0 = _cval("nns_mem_pressure_events_total", rung="shed")
    memory.activate(1 << 30)
    eng = _engine(max_streams=2, block_tokens=8, kv_blocks=6,
                  prefix_cache=0)
    try:
        streams = [eng.submit(LM_PROMPTS[i % 5], max_new_tokens=24)
                   for i in range(8)]
        for s in streams:
            s.result(timeout=240)
        sheds = eng.stats["kv_sheds"]
    finally:
        eng.close()
    assert sheds > 0
    assert _cval("nns_mem_pressure_events_total", rung="shed") - shed0 == \
        sheds
    assert eng._pool.live_blocks() == 0
