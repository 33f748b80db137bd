"""Weight residency of the PyTorch port under the HBM accountant
(``filters/torch_backend.py``, ``tensors/memory.py``, ``pipeline/fuse.py``),
model sharing (``shared-tensor-filter-key``) and hot reload
(``is-updatable``), held to the JAX package where it has the same
behaviour.

The time-sharing case runs two MobileNetV2 classifiers, whose summed
weights exceed the budget, behind a ``tee`` in both packages on the CPU
(the port's weights converted from the JAX variables with
``params_from_jax``): the labels agree exactly, the scores to rtol 1e-4
and atol 1e-4 * max|score| (the tolerance of
``test_torch_mobilenet_v2.py``), and each package evicts. Within the port
a budgeted run is byte-identical to an unbudgeted one.
"""

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
from nnstreamer_tpu.tensors import memory as jmemory
from nnstreamer_tpu_torch.filters.torch_backend import (
    TorchFilter,
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.filters.api import FilterProperties
from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2, params_from_jax
from nnstreamer_tpu_torch.pipeline.element import CustomEvent
from nnstreamer_tpu_torch.tensors import memory

SIZE, CLASSES, FRAMES = 32, 10, 6


@pytest.fixture(autouse=True)
def _cpu():
    tnt.set_device("cpu")
    memory.deactivate()
    jmemory.deactivate()
    yield
    memory.deactivate()
    jmemory.deactivate()
    tnt.set_device(None)


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


class _Scale(torch.nn.Module):
    def __init__(self, scale, n=64):
        super().__init__()
        self.w = torch.nn.Parameter(torch.full((n, n), float(scale)),
                                    requires_grad=False)
        self.register_buffer("b", torch.full((1,), float(scale) / 2))

    def forward(self, x):
        return x.to(torch.float32) * self.w[0, 0] + self.b


@pytest.fixture
def scale_models():
    names = {"res_a": _Scale(2.0), "res_b": _Scale(3.0)}
    for n, m in names.items():
        register_torch_model(n, m)
    yield names
    for n in names:
        unregister_torch_model(n)


def _open(model, **kw):
    fw = TorchFilter()
    fw.open(FilterProperties(model=model, **kw))
    return fw


def _tee(a, b, pre=""):
    return (f"videotestsrc num-buffers={FRAMES} width={SIZE} "
            f"height={SIZE} pattern=ball ! tensor_converter ! tee name=t "
            f"t. ! {pre}tensor_filter framework=jax model={a} name=fa ! "
            "tensor_decoder mode=image_labeling ! tensor_sink name=oa "
            f"t. ! {pre}tensor_filter framework=jax model={b} name=fb ! "
            "tensor_decoder mode=image_labeling ! tensor_sink name=ob")


NORM = ("tensor_transform mode=arithmetic "
        "option=typecast:float32,add:-127.5,div:127.5 ! ")


def _run_tee(pkg, desc):
    pipe = pkg.parse_launch(desc)
    got = {"oa": [], "ob": []}
    for k in got:
        pipe.get(k).connect(lambda b, k=k: got[k].append(dict(b.meta)))
    msg = pipe.run(timeout=120)
    assert msg is not None and msg.kind == "eos", msg
    return pipe, got


def _register_mobilenets(seeds):
    nbytes = 0
    for name, seed in seeds.items():
        apply_fn, variables, in_info, out_info = jax_mobilenet_v2(
            num_classes=CLASSES, image_size=SIZE, dtype=jnp.float32,
            seed=seed)
        register_jax_model(name, apply_fn, variables, in_info=in_info,
                           out_info=out_info)
        module = MobileNetV2(num_classes=CLASSES)
        module.load_state_dict(params_from_jax(
            jax.tree.map(np.asarray, variables)))
        register_torch_model(
            name, module.eval(),
            tnt.TensorsInfo.from_str(f"3:{SIZE}:{SIZE}:1", "float32"),
            tnt.TensorsInfo.from_str(f"{CLASSES}:1", "float32"))
        nbytes += memory.nbytes_of(module)
    return nbytes


def test_two_mobilenets_time_share_as_jax():
    seeds = {"res_mnv2_a": 21, "res_mnv2_b": 22}
    total = _register_mobilenets(seeds)
    desc = _tee(*seeds, pre=NORM)
    try:
        _, base = _run_tee(tnt, desc)
        acct = memory.activate(total - total // 4)
        _, got = _run_tee(tnt, desc)
        snap = acct.snapshot()
        jacct = jmemory.activate(total - total // 4)
        _, ref = _run_tee(jnt, desc)
        jsnap = jacct.snapshot()
    finally:
        for n in seeds:
            unregister_jax_model(n)
            unregister_torch_model(n)
    assert snap["evictions"] > 0 and jsnap["evictions"] > 0
    assert snap["high_water_bytes"] < total
    for k in ("oa", "ob"):
        assert len(got[k]) == len(ref[k]) == FRAMES
        assert [m["label"] for m in got[k]] == [m["label"] for m in ref[k]]
        # within the port the budget changes nothing, bit for bit
        assert [(m["label"], m["score"]) for m in got[k]] == \
            [(m["label"], m["score"]) for m in base[k]]
        ref_scores = np.array([m["score"] for m in ref[k]])
        np.testing.assert_allclose(
            [m["score"] for m in got[k]], ref_scores, rtol=1e-4,
            atol=1e-4 * float(np.abs(ref_scores).max()))


@pytest.mark.parametrize("fuse", [True, False])
def test_budgeted_run_is_byte_identical(scale_models, fuse):
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

    desc = _tee("res_a", "res_b", pre=NORM)
    base = _run_tee(tnt, desc)[1]
    nbytes = memory.nbytes_of(scale_models["res_a"])
    acct = memory.activate(nbytes + nbytes // 2)
    pipe = tnt.parse_launch(desc, pipeline=Pipeline(fuse=fuse))
    got = {"oa": [], "ob": []}
    for k in got:
        pipe.get(k).connect(lambda b, k=k: got[k].append(dict(b.meta)))
    assert pipe.run(timeout=60).kind == "eos"
    snap = acct.snapshot()
    assert snap["evictions"] >= FRAMES and snap["prefetches"] > 0
    assert snap["high_water_bytes"] < 2 * nbytes
    assert bool(pipe._regions) == fuse
    for k in ("oa", "ob"):
        assert [(m["label"], m["score"]) for m in got[k]] == \
            [(m["label"], m["score"]) for m in base[k]]
    assert acct.used_bytes() == 0  # the units left at stop


def test_unit_registers_and_close_unregisters(scale_models):
    acct = memory.activate(1 << 20)
    fw = _open("res_a")
    want = memory.nbytes_of(scale_models["res_a"])
    assert acct.snapshot()["used_by_category"] == {"weights": want}
    (unit,) = acct.snapshot()["units"]
    assert unit["label"] == "res_a" and unit["resident"]
    fw.close()
    assert acct.used_bytes() == 0 and acct.snapshot()["units"] == []


def test_eviction_frees_the_storage_and_reload_is_exact(scale_models):
    acct = memory.activate(1 << 20)
    fw = _open("res_a")
    served = fw._module
    assert served is not scale_models["res_a"]  # a private module
    acct.residency.evict_all()
    assert served.w.numel() == 0 and served.b.numel() == 0
    # the registered module is untouched
    assert scale_models["res_a"].w.shape == (64, 64)
    out = fw.invoke([np.full((1, 4), 2.0, np.float32)])
    np.testing.assert_array_equal(out[0].numpy(),
                                  np.full((1, 4), 5.0, np.float32))
    assert served.w.shape == (64, 64) and fw._resident.loads == 2
    fw.close()


def test_negotiation_loads_an_evicted_model(scale_models):
    acct = memory.activate(1 << 20)
    fw = _open("res_a")
    acct.residency.evict_all()
    info = fw.set_input_info(tnt.TensorsInfo.from_str("4:1", "float32"))
    assert str(info[0].dim[:2]) == "(4, 1)"
    fw.close()


def test_region_drops_graphs_when_the_weights_reload(scale_models):
    """A fused region reads the unit's load count on every dispatch: a
    reload (new storage) drops the graphs captured over the old one."""
    acct = memory.activate(1 << 20)
    pipe = tnt.parse_launch(
        "appsrc name=src ! " + NORM +
        "tensor_filter framework=jax model=res_a name=f ! "
        "tensor_sink name=out")
    outs = []
    pipe.get("out").connect(lambda b: outs.append(np.asarray(b[0])))
    pipe.start()

    def push_one():
        n = len(outs)
        src.push([np.ones((1, 4), np.uint8)])
        deadline = time.monotonic() + 30
        while len(outs) == n:
            assert time.monotonic() < deadline, "frame never arrived"
            time.sleep(0.005)

    try:
        src = pipe.get("src")
        push_one()
        (region,) = pipe._regions
        region._graphs = {("never-matches",): None}  # a stand-in graph
        push_one()
        assert region.rebinds == 0 and region._graphs
        acct.residency.evict_all()
        push_one()
        assert region.rebinds == 1 and region._graphs == {}
        src.end_of_stream()
        assert pipe.wait(timeout=30).kind == "eos"
    finally:
        pipe.stop()
    assert len(outs) == 3 and all(np.array_equal(o, outs[0]) for o in outs)


def test_shared_key_filters_share_one_backend(scale_models):
    acct = memory.activate(1 << 20)
    desc = _tee("res_a", "res_a").replace(
        "name=fa", "name=fa shared-tensor-filter-key=k").replace(
        "name=fb", "name=fb shared-tensor-filter-key=k")
    desc = desc.replace("tensor_decoder mode=image_labeling ! ", "")
    pipe = tnt.parse_launch(desc)
    pipe.start()
    try:
        fa, fb = pipe.get("fa"), pipe.get("fb")
        assert fa.fw is fb.fw
        # the weights sit in the accountant once
        assert acct.snapshot()["used_by_category"]["weights"] == \
            memory.nbytes_of(scale_models["res_a"])
    finally:
        pipe.stop()
    assert acct.used_bytes() == 0


def test_shared_backend_closes_with_its_last_filter(scale_models):
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    a = TensorFilter("fa", framework="torch", model="res_a",
                     shared_tensor_filter_key="k2")
    b = TensorFilter("fb", framework="torch", model="res_a",
                     shared_tensor_filter_key="k2")
    fw = a._open_fw()
    assert b._open_fw() is fw
    a._close_fw()
    assert fw._module is not None  # b still serves it
    b._close_fw()
    assert fw._module is None


def test_reload_model_event_needs_is_updatable(scale_models):
    from nnstreamer_tpu_torch.elements.filter import TensorFilter

    f = TensorFilter("f", framework="torch", model="res_a",
                     is_updatable=True)
    f._open_fw()
    before = f.fw._module
    f.sink_event(f.sinkpads[0], CustomEvent("reload_model",
                                            {"model": "res_b"}))
    assert f.get_property("model") == "res_b"
    out = f.fw.invoke([np.ones((1, 2), np.float32)])
    np.testing.assert_array_equal(out[0].numpy(), np.full((1, 2), 4.5))
    assert f.fw._module is not before
    assert f._obs_reloads().value == 1
    g = TensorFilter("g", framework="torch", model="res_a")
    g._open_fw()
    with pytest.raises(RuntimeError, match="is-updatable"):
        g.reload_model("res_b")


def test_install_weights_copies_in_place(scale_models):
    fw = _open("res_a", is_updatable=True)
    ptr = fw._module.w.data_ptr()
    new = {"w": torch.full((64, 64), 7.0), "b": torch.full((1,), 1.0)}
    rep = fw.install_weights(new, epoch=1)
    assert rep["rebound"] == 0 and fw._module.w.data_ptr() == ptr
    out = fw.invoke([np.ones((1, 2), np.float32)])
    np.testing.assert_array_equal(out[0].numpy(), np.full((1, 2), 8.0))
    # the registered module is not the one swapped
    assert float(scale_models["res_a"].w[0, 0]) == 2.0


def test_install_weights_rebinds_a_changed_shape(scale_models):
    fw = _open("res_a", is_updatable=True)
    new = {"w": torch.full((8, 8), 5.0), "b": torch.full((1,), 0.0)}
    rep = fw.install_weights(new, epoch=1)
    assert rep["rebound"] == 1 and fw._module.w.shape == (8, 8)
    with pytest.raises(ValueError, match="does not match"):
        fw.install_weights({"w": torch.zeros(1)}, epoch=2)


def test_install_weights_under_a_budget_nets_out(scale_models):
    acct = memory.activate(1 << 20)
    fw = _open("res_a")
    used, old_key = acct.used_bytes(), fw._resident.key
    rep = fw.install_weights(
        {"w": torch.full((64, 64), 9.0), "b": torch.full((1,), 0.5)},
        epoch=1)
    keys = set(acct.residency._units)
    assert acct.used_bytes() == used
    assert rep["retired"] == old_key and old_key not in keys
    assert rep["residency"] in keys and rep["residency"].endswith(":e1")
    out = fw.invoke([np.ones((1, 2), np.float32)])
    np.testing.assert_array_equal(out[0].numpy(), np.full((1, 2), 9.5))
    fw.close()
    assert acct.used_bytes() == 0


@pytest.mark.gpu
def test_two_flagship_models_time_share_on_the_card(tmp_path):
    """Two MobileNetV2s at the flagship's size (224×224, 1001 classes,
    bf16) whose summed weights exceed the budget, each in a fused region
    behind a tee: every frame evicts the other model, loads its own into
    new storage and captures its region again, and the labels and scores
    equal an unbudgeted run bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the regions capture CUDA graphs")
    from nnstreamer_tpu_torch.models.mobilenet_v2 import mobilenet_v2

    tnt.set_device(None)
    labels = tmp_path / "labels.txt"
    labels.write_text("".join(f"c{i}\n" for i in range(1001)))
    total = 0
    for seed, name in enumerate(("gpu_mem_a", "gpu_mem_b"), start=1):
        module, _, _ = mobilenet_v2(num_classes=1001, image_size=224,
                                    dtype=torch.bfloat16, seed=seed)
        register_torch_model(name, module)
        total += memory.nbytes_of(module)
    desc = (_tee("gpu_mem_a", "gpu_mem_b", pre=NORM)
            .replace(f"width={SIZE} height={SIZE}", "width=224 height=224")
            .replace("mode=image_labeling",
                     f"mode=image_labeling option1={labels}"))
    try:
        pipe0, base = _run_tee(tnt, desc)
        acct = memory.activate(3 * total // 4)
        pipe1, got = _run_tee(tnt, desc)
        snap = acct.snapshot()
    finally:
        for name in ("gpu_mem_a", "gpu_mem_b"):
            unregister_torch_model(name)
    assert snap["evictions"] > 0
    regions = pipe1.metrics_snapshot()["regions"]
    assert len(regions) == 2
    assert sum(r["captures"] for r in regions.values()) > 2
    for k in ("oa", "ob"):
        assert len(got[k]) == FRAMES
        assert [(m["label"], np.float32(m["score"]).tobytes())
                for m in got[k]] == \
            [(m["label"], np.float32(m["score"]).tobytes()) for m in base[k]]
