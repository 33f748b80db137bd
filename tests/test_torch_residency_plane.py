"""The device-residency plane's switch and accounting, the poisoned-fence
series and the filter's opens counter, held to the JAX package on the CPU.

- ``NNSTPU_RESIDENT`` is read at each call as the JAX package reads it
  (``nnstreamer_tpu/tensors/buffer.py:38-45``); with it off no
  ``DeviceBuffer`` is made (JAX ``tests/test_residency.py::TestLazyToHost::
  test_disabled_never_wraps``). A meta tensor stands in for a card's: it
  is "on the device" for ``as_device_buffer``, which is all the switch
  decides.
- Every ``DeviceBuffer`` pad entry is tallied resident or materialized
  (``transfer_snapshot()``'s ``resident_entries``/``materialized_entries``,
  the ``nns_buffer_resident_ratio`` gauge), per buffer and on the list
  path, with the same counts as the JAX element on the cases of JAX
  ``TestEntryPolicy``.
- A run with ``NNSTPU_RESIDENT=0`` is byte-identical to the default run
  (JAX ``TestEndToEnd::test_byte_equality_vs_residency_disabled``), and
  the port's sums equal the JAX package's within rtol 1e-5 (float32 sums
  of 3,072 values in [0, 1] added in another order).
- A failed fence is counted in ``nns_fault_poisoned_batches_total`` and
  raised as the JAX package's ``FlowError`` message, after its stash was
  released (JAX ``pipeline/dispatch.py:154-225``).
- ``nns_tensor_filter_opens_total`` counts a backend open, and a swap
  counts none, as in the JAX filter (``elements/filter.py:145-148, 217``).

On the CPU the port makes no DeviceBuffer in a pipeline (a CPU tensor is
not on a device); the end-to-end split on the card is
``tests/test_torch_perf_smoke.py::test_residency_off_is_byte_identical``
(a ``gpu`` test, in a file that imports no JAX).
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.elements.filter import TensorFilter as JaxFilter
from nnstreamer_tpu.filters.jax_backend import (
    register_jax_model,
    unregister_jax_model,
)
from nnstreamer_tpu.obs import get_registry as jax_registry
from nnstreamer_tpu.pipeline import element as jelement
from nnstreamer_tpu.pipeline import faults as jfaults
from nnstreamer_tpu.pipeline.pipeline import Pipeline as JaxPipeline
from nnstreamer_tpu.tensors import buffer as jbuf
from nnstreamer_tpu.tensors.pool import get_pool as jax_pool
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.pipeline import element as telement
from nnstreamer_tpu_torch.pipeline import faults
from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline
from nnstreamer_tpu_torch.tensors import buffer as tbuf
from nnstreamer_tpu_torch.tensors.pool import get_pool

SWITCH = "NNSTPU_RESIDENT"


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(SWITCH, raising=False)
    faults.deactivate()
    jfaults.deactivate()
    tnt.set_device("cpu")
    yield
    faults.deactivate()
    jfaults.deactivate()
    tnt.set_device(None)


def _split(mod):
    snap = mod.transfer_snapshot()
    return snap["resident_entries"], snap["materialized_entries"]


# -- the switch ----------------------------------------------------------------
@pytest.mark.parametrize("value", [None, "1", "0", "false", "No", " off ",
                                   "OFF", "true", "yes", ""])
def test_switch_reads_as_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv(SWITCH, raising=False)
    else:
        monkeypatch.setenv(SWITCH, value)
    assert tbuf.residency_enabled() == jbuf.residency_enabled()
    assert tbuf.residency_enabled() == (
        value is None or value.strip().lower() not in
        ("0", "false", "no", "off"))


class TestLazyToHost:
    @staticmethod
    def _wraps(monkeypatch, value):
        if value is None:
            monkeypatch.delenv(SWITCH, raising=False)
        else:
            monkeypatch.setenv(SWITCH, value)
        mine = tbuf.TensorBuffer([torch.ones(4, device="meta")])
        theirs = jbuf.TensorBuffer([np.ones(4, np.float32)]).to_device()
        assert mine.on_device() and theirs.on_device()
        out, ref = tbuf.as_device_buffer(mine), jbuf.as_device_buffer(theirs)
        wrapped = isinstance(out, tbuf.DeviceBuffer)
        assert wrapped == isinstance(ref, jbuf.DeviceBuffer)
        if not wrapped:
            assert out is mine  # the input, unwrapped and uncopied
        return wrapped

    def test_disabled_never_wraps(self, monkeypatch):
        assert not self._wraps(monkeypatch, "0")

    def test_enabled_wraps(self, monkeypatch):
        assert self._wraps(monkeypatch, None)
        assert self._wraps(monkeypatch, "1")

    @pytest.mark.parametrize("switch", [None, "0"])
    def test_uploads_wrap_only_with_the_switch_on(self, monkeypatch,
                                                   switch):
        """``upload_many`` and a queue's per-buffer upload to a device
        (the meta device here) hand over DeviceBuffers that adopt the
        pre-upload host arrays, or plain buffers with the switch off."""
        from nnstreamer_tpu_torch.pipeline.pipeline import Queue

        if switch is not None:
            monkeypatch.setenv(SWITCH, switch)
        host = [np.full((3,), i, np.float32) for i in range(3)]
        bufs = [tbuf.TensorBuffer([h], pts=i) for i, h in enumerate(host)]
        meta = torch.device("meta")
        out, _ = tbuf.upload_many(bufs, meta)
        q = Queue(prefetch_device=True)
        q._device = meta
        out.append(q._upload_one(bufs[0]))
        assert all(b.on_device() for b in out)
        wrapped = [isinstance(b, tbuf.DeviceBuffer) for b in out]
        assert wrapped == [switch is None] * 4
        if switch is None:  # the host view: to_host reads no device
            got = [b.to_host().tensors[0] for b in out]
            assert [g is h for g, h in zip(got, host + host[:1])] == \
                [True] * 4


# -- the entry policy's split, against the JAX element ---------------------------
class _Collect:
    """Mix-in of a collecting sink element: records what its chain got."""

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.buffers = []

    def chain(self, pad, buf):
        self.buffers.append(buf)


def _elements(mod):
    """(host, passthrough, deferred) collectors of one package."""
    base = mod.Element
    host = type("_HostCollect", (_Collect, base),
                {"ELEMENT_NAME": "_hostcollect_rp"})
    dev = type("_DevCollect", (_Collect, base),
               {"ELEMENT_NAME": "_devcollect_rp", "DEVICE_PASSTHROUGH": True})
    deferred = type("_DeferredCollect", (_Collect, base),
                    {"ELEMENT_NAME": "_defcollect_rp",
                     "DEVICE_PASSTHROUGH": True, "HANDLES_DEFERRED": True})
    return {"host": host, "passthrough": dev, "deferred": deferred}


def _plus_one(b):
    return b.with_tensors([np.asarray(t) + 1 for t in b.tensors])


def _torch_dev(i, finalize):
    return tbuf.DeviceBuffer(tensors=[torch.full((3,), float(i))], pts=i,
                             finalize=_plus_one if finalize else None)


def _jax_dev(i, finalize):
    buf = jbuf.TensorBuffer([np.full((3,), float(i), np.float32)],
                            pts=i).to_device()
    out = jbuf.as_device_buffer(buf)
    if finalize:
        out = out.replace(finalize=_plus_one)
    assert isinstance(out, jbuf.DeviceBuffer)
    return out


ENTRY_CASES = {
    # (element kind, pending finalize) -> (resident, materialized) a buffer
    ("host", False): (0, 1),
    ("passthrough", False): (1, 0),
    ("passthrough", True): (0, 1),
    ("deferred", True): (1, 0),
}


@pytest.mark.parametrize("path", ["buffer", "list"])
@pytest.mark.parametrize("kind,finalize", sorted(ENTRY_CASES))
def test_entry_split_matches_jax(kind, finalize, path):
    n = 3
    deltas = []
    for mod, buf_mod, make in ((telement, tbuf, _torch_dev),
                               (jelement, jbuf, _jax_dev)):
        el = _elements(mod)[kind]()
        bufs = [make(i, finalize) for i in range(n)]
        before = _split(buf_mod)
        if path == "list":
            el._chain_list_entry(el.sinkpads[0], bufs)
        else:
            for b in bufs:
                el._chain_entry(el.sinkpads[0], b)
        after = _split(buf_mod)
        deltas.append((after[0] - before[0], after[1] - before[1]))
        assert len(el.buffers) == n
        kept = [isinstance(b, buf_mod.DeviceBuffer) for b in el.buffers]
        assert kept == [ENTRY_CASES[(kind, finalize)][0] == 1] * n
        if not kept[0]:  # materialized: host tensors, finalize applied
            for i, b in enumerate(el.buffers):
                assert isinstance(b.tensors[0], np.ndarray)
                np.testing.assert_array_equal(
                    b.tensors[0], np.full((3,), i + int(finalize),
                                          np.float32))
    mine, theirs = deltas
    res, mat = ENTRY_CASES[(kind, finalize)]
    assert mine == theirs == (res * n, mat * n)


def test_resident_ratio_and_gauge():
    before = _split(tbuf)
    el = _elements(telement)["passthrough"]()
    for i in range(3):
        el._chain_entry(el.sinkpads[0], _torch_dev(i, False))
    el._chain_entry(el.sinkpads[0], _torch_dev(3, True))
    r, m = _split(tbuf)
    assert (r - before[0], m - before[1]) == (3, 1)
    assert tbuf.resident_ratio() == pytest.approx(r / (r + m))
    gauge = get_registry().get("nns_buffer_resident_ratio")
    assert gauge is not None and gauge.value == pytest.approx(r / (r + m))
    assert "nns_buffer_resident_ratio" in \
        get_registry().render_prometheus()


class _Event:
    """A finished copy's event: the stand-in of a prefetched fetch."""

    def synchronize(self):
        pass


def _meta_payload(value):
    """A plain buffer whose payload lies "on the device" (a meta tensor),
    with its host copy already fetched (``prefetch_host``'s shape), so
    ``to_host`` hands over the host array without reading the device."""
    host = np.full((3,), value, np.float32)
    return tbuf.TensorBuffer([torch.zeros(3, device="meta")],
                             host_copy=([host], _Event())), host


@pytest.mark.parametrize("switch", [None, "0"])
def test_disabled_hands_a_host_element_a_host_buffer(monkeypatch, switch):
    """With the switch off nothing is a DeviceBuffer, so the entry of an
    element that is not device-capable fetches an all-device payload
    itself; the default path leaves plain buffers as they are."""
    if switch is not None:
        monkeypatch.setenv(SWITCH, switch)
    kinds = _elements(telement)
    host, dev = kinds["host"](), kinds["passthrough"]()
    before = _split(tbuf)
    buf, arr = _meta_payload(2.0)
    host._chain_entry(host.sinkpads[0], buf)
    dev._chain_entry(dev.sinkpads[0], buf)
    assert _split(tbuf) == before  # no DeviceBuffer entered
    assert dev.buffers[0] is buf
    (got,) = host.buffers
    if switch == "0":
        assert got is not buf and got.tensors[0] is arr
    else:
        assert got is buf


# -- end to end: byte equality with the switch off -------------------------------
DESC = (
    "videotestsrc pattern=ball num-buffers=12 width=16 height=16 ! "
    "tensor_converter ! "
    "tensor_aggregator frames-in=1 frames-out=4 frames-flush=4 "
    "frames-dim=3 concat=true ! "
    "queue max-size-buffers=4 prefetch-device=true ! "
    "tensor_transform mode=arithmetic option=typecast:float32,div:255.0 ! "
    "tensor_filter framework=jax model=residency_plane_sum name=filter "
    "inflight=2 ! "
    "queue max-size-buffers=8 materialize-host=true ! "
    "tensor_sink name=sink to-host=true"
)


class _Sum(torch.nn.Module):
    def forward(self, x):
        return torch.sum(x, dim=(1, 2, 3))[:, None]


@pytest.fixture
def sum_models():
    register_torch_model("residency_plane_sum", _Sum())
    register_jax_model("residency_plane_sum",
                       lambda x: (jnp.sum(x, axis=(1, 2, 3))[:, None],),
                       None)
    yield "residency_plane_sum"
    unregister_torch_model("residency_plane_sum")
    unregister_jax_model("residency_plane_sum")


def _run(pkg, name, monkeypatch, switch=None, pipeline_cls=None):
    if switch is None:
        monkeypatch.delenv(SWITCH, raising=False)
    else:
        monkeypatch.setenv(SWITCH, switch)
    pipe = pkg.parse_launch(DESC, pipeline=pipeline_cls(name=name))
    msg = pipe.run(timeout=120)
    assert msg is not None and msg.kind == "eos", msg
    return [np.asarray(tbuf.host_array(b.tensors[0])).copy()
            for b in pipe.get("sink").buffers]


def test_byte_equality_vs_residency_disabled(sum_models, monkeypatch):
    on = _run(tnt, "rp_on", monkeypatch, pipeline_cls=Pipeline)
    off = _run(tnt, "rp_off", monkeypatch, "0", pipeline_cls=Pipeline)
    jon = _run(jnt, "rp_jon", monkeypatch, pipeline_cls=JaxPipeline)
    joff = _run(jnt, "rp_joff", monkeypatch, "0", pipeline_cls=JaxPipeline)
    assert len(on) == len(off) == len(jon) == len(joff) == 3  # 12 / 4
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    for a, b in zip(jon, joff):
        assert a.tobytes() == b.tobytes()
    for a, b in zip(on, jon):
        assert a.shape == b.shape == (4, 1)
        np.testing.assert_allclose(a, b, rtol=1e-5)


# -- a poisoned fence -------------------------------------------------------------
def _poisoned(filter_cls, fault_mod, pool, make, name):
    """Three batches into a window of 2 under ``dispatch.fence:nth=1``: the
    third admission fences the first, whose fault is raised. Returns the
    error, the stashes and the window."""
    owner = filter_cls(name=name, inflight=2)
    window = owner._window
    stashes = [pool.acquire((4,), np.float32) for _ in range(3)]
    fault_mod.activate("dispatch.fence:nth=1,kind=raise")
    try:
        window.admit(*make(stashes[0]))
        window.admit(*make(stashes[1]))
        with pytest.raises(RuntimeError) as err:
            window.admit(*make(stashes[2]))
        remaining = len(window)
        window.drain()
    finally:
        fault_mod.deactivate()
    return err.value, stashes, remaining


def _counter(registry, name, **labels):
    c = registry.get(name, **labels)
    return 0.0 if c is None else c.value


def test_poisoned_fence_matches_jax():
    name = "rp_poison"
    labels = {"pipeline": "", "element": name}
    series = "nns_fault_poisoned_batches_total"
    c0 = _counter(get_registry(), series, **labels)
    j0 = _counter(jax_registry(), series, **labels)

    mine, stashes, left = _poisoned(
        TensorFilter, faults, get_pool(),
        lambda st: ([torch.zeros(2)], [st], _Event()), name)
    theirs, jstashes, jleft = _poisoned(
        JaxFilter, jfaults, jax_pool(),
        lambda st: ([jnp.zeros(2)], [st]), name)

    assert type(mine).__name__ == type(theirs).__name__ == "FlowError"
    assert isinstance(mine, telement.FlowError)
    assert str(mine) == str(theirs) == (
        f"{name}: poisoned in-flight batch at fence: injected fault at "
        "dispatch.fence (occurrence 1)")
    assert isinstance(mine.__cause__, faults.InjectedFault)
    assert _counter(get_registry(), series, **labels) - c0 == 1
    assert _counter(jax_registry(), series, **labels) - j0 == 1
    # the poisoned batch's stash went back at its fence; the two behind
    # it stayed in the window and fenced normally at the drain
    assert left == jleft == 2
    assert not any(get_pool().owns(s) for s in stashes)
    assert not any(jax_pool().owns(s) for s in jstashes)


def test_flow_error_at_the_fence_passes_unwrapped():
    owner = TensorFilter(name="rp_flow", inflight=0)

    class _Failing:
        def synchronize(self):
            raise telement.FlowError("rp_flow: already a flow error")

    with pytest.raises(telement.FlowError) as err:
        owner._window.admit([torch.zeros(2)], event=_Failing())
    assert str(err.value) == "rp_flow: already a flow error"


@pytest.fixture
def double_models():
    class _Double(torch.nn.Module):
        def forward(self, x):
            return x.float() * 2.0

    register_torch_model("rp_double", _Double())
    register_jax_model("rp_double",
                       lambda x: (x.astype(jnp.float32) * 2.0,), None)
    yield "rp_double"
    unregister_torch_model("rp_double")
    unregister_jax_model("rp_double")


POISON_DESC = ("videotestsrc num-buffers=8 width=8 height=8 ! "
               "tensor_converter ! tensor_filter framework=jax "
               "model=rp_double inflight=2 name=f ! tensor_sink name=out")


def _pts(pipe):
    return [b.pts for b in pipe.get("out").buffers]


@pytest.mark.parametrize("fuse", [False, True])
def test_poisoned_pipeline_halts_as_jax(double_models, fuse):
    """Under ``skip-frame`` a poisoned fence still ends the run, as in the
    JAX package (its ``FlowError`` passes every error policy); the
    windows delivered before it are the unfaulted run's, in order."""
    got = {}
    for key, pkg, pcls, fmod, reg in (
            ("port", tnt, Pipeline, faults, get_registry),
            ("jax", jnt, JaxPipeline, jfaults, jax_registry)):
        clean = pkg.parse_launch(POISON_DESC, pipeline=pcls(
            name=f"rp_clean_{key}_{fuse}", fuse=fuse))
        assert clean.run(timeout=60).kind == "eos"
        name = f"rp_poisoned_{key}_{fuse}"
        before = _counter(reg(), "nns_fault_poisoned_batches_total",
                          pipeline=name, element="f")
        fmod.activate("dispatch.fence:nth=3,kind=raise")
        pipe = pkg.parse_launch(POISON_DESC, pipeline=pcls(
            name=name, fuse=fuse), error_policy="skip-frame")
        try:
            with pytest.raises(RuntimeError) as err:
                pipe.run(timeout=60)
        finally:
            fmod.deactivate()
        after = _counter(reg(), "nns_fault_poisoned_batches_total",
                         pipeline=name, element="f")
        delivered = _pts(pipe)
        assert delivered == _pts(clean)[:len(delivered)]
        got[key] = (str(err.value), after - before)
    assert got["port"] == got["jax"] == (
        "f: poisoned in-flight batch at fence: injected fault at "
        "dispatch.fence (occurrence 3)", 1.0)


# -- the opens counter --------------------------------------------------------------
SWAP_DESC = (
    "appsrc name=src ! "
    "tensor_transform mode=arithmetic option=typecast:float32,add:0.0 ! "
    "tensor_filter framework=jax model=rp_a name=filter "
    "is-updatable=true ! tensor_sink name=sink")


@pytest.fixture
def swap_models():
    class _Add(torch.nn.Module):
        def forward(self, x):
            return x + 1.0

    class _Mul(torch.nn.Module):
        def forward(self, x):
            return x * 3.0

    register_torch_model("rp_a", _Add())
    register_torch_model("rp_b", _Mul())
    register_jax_model("rp_a", lambda x: x + 1.0)
    register_jax_model("rp_b", lambda x: x * 3.0)
    yield
    for name in ("rp_a", "rp_b"):
        unregister_torch_model(name)
        unregister_jax_model(name)


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


def _opens_through_a_swap(pkg, pcls, reg, name):
    """The filter's opens after start, after a swap to ``rp_b`` and after
    a stop and a second run of the same pipeline."""
    def opens():
        return _counter(reg(), "nns_tensor_filter_opens_total",
                        pipeline=name, element="filter")

    pipe = pkg.parse_launch(SWAP_DESC, pipeline=pcls(name=name))
    src, sink = pipe.get("src"), pipe.get("sink")
    counts = [opens()]
    pipe.start()
    try:
        src.push([np.ones(4, np.float32)])
        _wait(lambda: len(sink.buffers) >= 1)
        counts.append(opens())
        pipe.swap_model("filter", model="rp_b")
        src.push([np.ones(4, np.float32)])
        src.end_of_stream()
        msg = pipe.wait(timeout=60)
        assert msg is not None and msg.kind == "eos", msg
        counts.append(opens())
    finally:
        pipe.stop()
    outs = [float(np.asarray(tbuf.host_array(b.tensors[0]))[0])
            for b in sink.buffers]
    assert outs == [2.0, 3.0]  # the swap took
    return counts


def test_opens_counted_as_jax(swap_models):
    mine = _opens_through_a_swap(tnt, Pipeline, get_registry, "rp_opens")
    theirs = _opens_through_a_swap(jnt, JaxPipeline, jax_registry,
                                   "rp_opens")
    assert mine == theirs == [0.0, 1.0, 1.0]


def test_a_restart_opens_again_as_jax(double_models):
    got = []
    for pkg, pcls, reg in ((tnt, Pipeline, get_registry),
                           (jnt, JaxPipeline, jax_registry)):
        pipe = pkg.parse_launch(POISON_DESC, pipeline=pcls(
            name="rp_reopen", fuse=False))
        counts = []
        for _ in range(2):
            assert pipe.run(timeout=60).kind == "eos"
            counts.append(_counter(reg(), "nns_tensor_filter_opens_total",
                                   pipeline="rp_reopen", element="f"))
        got.append(counts)
    assert got[0] == got[1] == [1.0, 2.0]


def test_a_failed_open_is_not_counted(double_models):
    before = _counter(get_registry(), "nns_tensor_filter_opens_total",
                      pipeline="rp_badopen", element="f")
    faults.activate("filter.open:nth=1")
    pipe = tnt.parse_launch(POISON_DESC, pipeline=Pipeline(
        name="rp_badopen"))
    with pytest.raises(Exception, match="injected fault at filter.open"):
        pipe.run(timeout=60)
    assert _counter(get_registry(), "nns_tensor_filter_opens_total",
                    pipeline="rp_badopen", element="f") == before
