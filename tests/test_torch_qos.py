"""QoS in the PyTorch port: ``tensor_rate`` (``elements/rate.py``), the
filter's ``throttle`` and its QoS drop check, and the fused region's QoS
gate and mid-stream fallback (``pipeline/fuse.py``), held to the JAX
package's.

- ``tensor_rate`` drops and duplicates the same pts as the JAX element;
- with ``throttle=true`` it posts a QoS interval upstream, and the filter
  (or the fused region holding it) drops the same frames as the JAX
  package's, before any dispatch; a dropped frame's staged slabs are
  released;
- a filter with ``throttle > 0`` is not fused; setting it mid-stream
  unsplices the region, and from then on the members run eagerly, the
  transform calling B1's wrapper itself, with no graph replayed.
"""

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.filters.jax_backend import (
    register_jax_model,
    unregister_jax_model,
)
from nnstreamer_tpu.obs import get_registry as jget_registry
from nnstreamer_tpu.pipeline.element import QosEvent as JaxQos
from nnstreamer_tpu_torch.elements import filter as filter_mod
from nnstreamer_tpu_torch.elements import transform as transform_mod
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.pipeline.element import QosEvent
from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

PKGS = {"jax": (jnt, jget_registry, JaxQos),
        "port": (tnt, get_registry, QosEvent)}


class _Scale(torch.nn.Module):
    def forward(self, x):
        return x.float() * 0.5


@pytest.fixture(autouse=True)
def models():
    tnt.set_device("cpu")
    register_jax_model("tqos", lambda x: x.astype("float32") * 0.5)
    register_torch_model("tqos", _Scale())
    yield "tqos"
    unregister_jax_model("tqos")
    unregister_torch_model("tqos")
    tnt.set_device(None)


def _run(pkg, desc, fuse=True, name="tqos"):
    mod = PKGS[pkg][0]
    kw = {}
    if pkg == "port":
        kw["pipeline"] = Pipeline(name=name, fuse=fuse)
    else:
        from nnstreamer_tpu.pipeline.pipeline import Pipeline as JPipeline

        kw["pipeline"] = JPipeline(name=name, fuse=fuse)
    pipe = mod.parse_launch(desc, **kw)
    assert pipe.run(timeout=120).kind == "eos"
    return pipe


def _delivered(pipe):
    return [(b.pts, np.asarray(b.to_host().tensors[0]).tobytes())
            for b in pipe.get("out").buffers]


# -- tensor_rate ------------------------------------------------------------------
@pytest.mark.parametrize("rate", ["10/1", "60/1", "30/1"])
def test_rate_converts_as_jax(rate):
    desc = ("videotestsrc num-buffers=30 width=4 height=4 framerate=30/1 ! "
            f"tensor_converter ! tensor_rate name=r framerate={rate} ! "
            "tensor_sink name=out")
    got, ref = _run("port", desc), _run("jax", desc)
    assert _delivered(got) == _delivered(ref)
    r, jr = got.get("r"), ref.get("r")
    assert (r.dropped, r.duplicated, r.out_count) == \
        (jr.dropped, jr.duplicated, jr.out_count)
    assert got.get("out").sinkpad.caps["framerate"] == rate
    snap = got.metrics_snapshot()["elements"]["r"]
    assert (snap["drops"], snap["duplicates"]) == (r.dropped, r.duplicated)


QOS = ("videotestsrc num-buffers=20 width=4 height=4 framerate=1000/1 ! "
       "tensor_converter ! tensor_transform mode=typecast option=float32 ! "
       "tensor_filter framework=jax model=tqos name=f ! "
       "tensor_rate name=r framerate={rate} throttle={throttle} ! "
       "tensor_sink name=out")


@pytest.mark.parametrize("fuse", [True, False])
def test_qos_throttle_drops_the_jax_frames(fuse):
    """A 10-second QoS interval against 20 frames that arrive within
    milliseconds: only the first frame is dispatched, in both packages,
    fused or not, and the same pts reach the sink."""
    desc = QOS.format(rate="1/10", throttle="true")
    got = _run("port", desc, fuse=fuse, name=f"tqos-{fuse}")
    ref = _run("jax", desc, fuse=fuse, name=f"tqos-{fuse}-jax")
    assert _delivered(got) == _delivered(ref) and len(_delivered(got)) == 1
    assert got.get("f")._qos_interval_s == 10.0
    if fuse:
        (region,) = got._regions
        assert not region._dead and region.qos_drops == 19
        assert region.eager_frames == 1
    else:
        assert got.metrics_snapshot()["elements"]["f"]["qos_drops"] == 19
        jdrops = jget_registry().get("nns_tensor_filter_qos_drops_total",
                                     pipeline=f"tqos-{fuse}-jax",
                                     element="f")
        assert jdrops.value == 19


@pytest.mark.parametrize("fuse", [True, False])
def test_unthrottled_rate_leaves_the_filter_alone(fuse):
    desc = QOS.format(rate="1/10", throttle="false")
    got = _run("port", desc, fuse=fuse, name=f"tqos-free-{fuse}")
    ref = _run("jax", desc, fuse=fuse, name=f"tqos-free-{fuse}-jax")
    assert _delivered(got) == _delivered(ref)
    assert getattr(got.get("f"), "_qos_interval_s", 0.0) == 0.0
    if fuse:
        assert got._regions[0].qos_drops == 0
        assert got._regions[0].eager_frames == 20


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_qos_event_reaches_filter_and_lifts(pkg):
    mod, _reg, Qos = PKGS[pkg]
    pipe = mod.parse_launch("appsrc name=a ! tensor_filter framework=jax "
                            "model=tqos name=f ! tensor_sink name=s")
    pipe.get("s").sinkpad.push_upstream_event(
        Qos(target_interval_ns=250_000_000))
    assert pipe.get("f")._qos_interval_s == 0.25
    pipe.get("s").sinkpad.push_upstream_event(Qos(0))
    assert pipe.get("f")._qos_interval_s == 0.0


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_downstream_plain_rate_does_not_cancel_throttle(pkg):
    pipe = _run(pkg, "videotestsrc num-buffers=2 width=4 height=4 "
                "framerate=1000/1 ! tensor_converter ! "
                "tensor_transform mode=typecast option=float32 ! "
                "tensor_filter framework=jax model=tqos name=f ! "
                "tensor_rate framerate=2/1 throttle=true ! "
                "tensor_rate ! tensor_sink name=out", fuse=False,
                name=f"tqos-plain-{pkg}")
    assert pipe.get("f")._qos_interval_s == 0.5


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_throttle_property_limits_invokes(pkg):
    """``throttle=1``: at most one invoke a second, so of 20 frames that
    arrive within milliseconds only the first is invoked."""
    pipe = _run(pkg, "videotestsrc num-buffers=20 width=4 height=4 ! "
                "tensor_converter ! tensor_transform mode=typecast "
                "option=float32 ! tensor_filter framework=jax model=tqos "
                "name=f throttle=1 ! tensor_sink name=out",
                name=f"tqos-throttle-{pkg}")
    assert not pipe._regions  # a throttled filter is not fused
    assert [b.pts for b in pipe.get("out").buffers] == [0]


def test_qos_drop_releases_the_staged_slabs(monkeypatch):
    released = []
    monkeypatch.setattr(filter_mod, "release_shed_payload",
                        lambda buf: released.append(buf.pts))
    pipe = _run("port", QOS.format(rate="1/10", throttle="true"),
                fuse=False, name="tqos-release")
    assert len(released) == 19
    assert pipe.metrics_snapshot()["elements"]["f"]["qos_drops"] == 19


def test_runtime_throttle_unsplices_and_members_run_eagerly(monkeypatch):
    """``throttle`` set on a fused filter mid-stream: the next frame
    unsplices the region and runs through the member chain, where the
    transform calls B1's wrapper (``normalize_chain``) for every frame;
    no graph is replayed and the stream survives."""
    calls = []
    b1 = transform_mod.normalize_chain
    monkeypatch.setattr(transform_mod, "normalize_chain",
                        lambda x, *a, **k: calls.append(tuple(x.shape))
                        or b1(x, *a, **k))
    pipe = tnt.parse_launch(
        "appsrc name=src ! tensor_transform mode=arithmetic "
        "option=typecast:float32,add:-127.5,div:127.5 ! "
        "tensor_filter framework=jax model=tqos name=f ! "
        "tensor_sink name=sink")
    src, sink = pipe.get("src"), pipe.get("sink")
    pipe.start()
    try:
        frame = np.full((8, 4), 255, np.uint8)
        src.push([frame.copy()])
        sink.wait(1)
        (region,) = pipe._regions
        assert not region._dead and region.eager_frames == 1
        # B1's wrapper ran once, inside the region's composed stages
        assert calls == [(8, 4)]
        pipe.get("f").set_property("throttle", 1000000)
        for _ in range(3):
            src.push([frame.copy()])
        src.end_of_stream()
        msg = pipe.wait(timeout=60)
        assert msg is not None and msg.kind == "eos", msg
        assert region._dead and region.eager_frames == 1
        assert region.replays == 0
        # then once a frame from the transform's own chain: the region
        # ran no more frames
        assert calls == [(8, 4)] * 4
        assert len(sink.buffers) == 4
        np.testing.assert_allclose(np.asarray(sink.buffers[-1].tensors[0]),
                                   np.full((8, 4), 0.5, np.float32))
    finally:
        pipe.stop()
