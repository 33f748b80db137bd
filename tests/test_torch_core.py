"""The framework-neutral core of the PyTorch port (types, buffers, caps,
launch parsing, queue, decoder), held to the JAX package where both have
the same function."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.decoders.image_labeling import ImageLabeling as JaxLabeling
from nnstreamer_tpu.tensors import types as jtypes
from nnstreamer_tpu_torch.decoders.image_labeling import ImageLabeling
from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline
from nnstreamer_tpu_torch.tensors import types as ttypes
from nnstreamer_tpu_torch.tensors.buffer import (
    DeviceBuffer,
    TensorBuffer,
    as_torch,
    host_array,
    is_device_array,
)


@pytest.mark.parametrize("name", [t.value for t in ttypes.TensorType])
def test_tensor_types_match_jax_package(name):
    ours, theirs = ttypes.TensorType(name), jtypes.TensorType(name)
    assert ours.size == theirs.size
    assert ttypes.TensorType.from_any(ours.torch_dtype) is ours
    if name != "bfloat16":
        assert ours.np_dtype == theirs.np_dtype


def test_bfloat16_needs_no_numpy_extension():
    bf16 = ttypes.TensorType.from_any("bfloat16")
    assert bf16.torch_dtype is torch.bfloat16 and bf16.size == 2
    with pytest.raises(TypeError):
        bf16.np_dtype  # noqa: B018
    info = ttypes.TensorsInfo.from_arrays([torch.zeros(2, 3,
                                                       dtype=torch.bfloat16)])
    assert info[0].dim == (3, 2) and info[0].type is bf16


@pytest.mark.parametrize("dims,types", [
    ("3:224:224:1", "uint8"), ("1001:1", "float32"),
    ("3:4:1,10:1", "float32,int32"),
])
def test_caps_strings_match_jax_package(dims, types):
    ours = ttypes.TensorsConfig(info=ttypes.TensorsInfo.from_str(dims, types),
                                rate=ttypes.Fraction(30, 1))
    theirs = jtypes.TensorsConfig(info=jtypes.TensorsInfo.from_str(dims,
                                                                   types),
                                  rate=jtypes.Fraction(30, 1))
    assert str(ours.to_caps()) == str(theirs.to_caps())
    back = ttypes.TensorsConfig.from_caps(ours.to_caps())
    assert back.info.is_equal(ours.info)


def test_buffer_placement():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert not is_device_array(t) and not is_device_array(np.zeros(2))
    assert is_device_array(torch.empty(2, device="meta"))
    ro = np.arange(4, dtype=np.uint8)
    ro.setflags(write=False)
    x = as_torch(ro)  # a read-only array is copied, not wrapped
    x[0] = 9
    assert ro[0] == 0
    bf = torch.ones(2, dtype=torch.bfloat16)
    assert host_array(bf).dtype is torch.bfloat16
    assert isinstance(host_array(t), np.ndarray)
    buf = TensorBuffer([t], pts=5).to_device(torch.device("cpu"))
    assert buf.pts == 5 and torch.equal(buf[0], t)


def test_device_buffer_materializes_once():
    calls = []

    def fin(host):
        calls.append(1)
        return host.replace(meta={**host.meta, "done": True})

    buf = DeviceBuffer(tensors=[torch.ones(3)], finalize=fin)
    first, second = buf.to_host(), buf.to_host()
    assert first is second and calls == [1] and first.meta["done"]
    assert isinstance(first.tensors[0], np.ndarray)


@pytest.mark.parametrize("batched", [False, True])
def test_image_labeling_device_half_matches_jax(batched):
    scores = np.random.default_rng(4).standard_normal((3, 7)).astype(
        np.float32)
    scores[1, 2] = scores[1, 5] = 10.0  # ties resolve to the first maximum
    opts = {"option2": "batched"} if batched else {}
    _, ours = ImageLabeling().device_kernel(opts)
    _, theirs = JaxLabeling().device_kernel(opts)
    idx, top = ours(None, [torch.from_numpy(scores)])
    jidx, jtop = theirs(None, [jnp.asarray(scores)])
    assert idx.dtype is torch.int32 and top.dtype is torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(top.numpy(), np.asarray(jtop))


@pytest.mark.parametrize("queue_props", [
    "max-size-buffers=4", "leaky=downstream max-size-buffers=64",
    "prefetch-host=true", "materialize-host=true",
])
def test_queue_properties_run(queue_props):
    desc = ("videotestsrc num-buffers=5 width=8 height=4 ! tensor_converter "
            f"! tensor_transform mode=typecast option=float32 ! "
            f"queue {queue_props} ! tensor_sink name=out")
    tnt.set_device("cpu")
    try:
        pipe = tnt.parse_launch(desc)
        out = []
        pipe.get("out").connect(lambda buf: out.append(buf))
        pipe.run(timeout=60)
    finally:
        tnt.set_device(None)
    assert len(out) == 5
    ref = jnt.parse_launch(desc)
    jout = []
    ref.get("out").connect(lambda buf: jout.append(buf))
    ref.run(timeout=60)
    for a, b in zip(out, jout):
        np.testing.assert_array_equal(np.asarray(a.to_host()[0]),
                                      np.asarray(b.to_host()[0]))


@pytest.mark.parametrize("desc,item", [
    ("videotestsrc ! tensor_converter ! tensor_filter framework=jax "
     "model=m shard=dp2 ! tensor_sink", "A.24"),
    # the converter's other media are ported (ROADMAP A.17); the
    # query client's reference wire and resilient transport are not
    ("videotestsrc ! tensor_converter ! tensor_query_client "
     "wire=nnstreamer ! tensor_sink", "26d"),
    ("videotestsrc ! tensor_converter ! tensor_filter framework=jax "
     "model=m mesh=dp4 ! tensor_sink", "A.24"),
    ("videotestsrc ! tensor_converter ! tensor_query_client "
     "reliable=true ! tensor_sink", "26a"),
])
def test_unported_properties_raise_naming_the_roadmap(desc, item):
    with pytest.raises(NotImplementedError, match=item):
        tnt.parse_launch(desc)


@pytest.mark.parametrize("kwargs", [
    dict(slo_budget_ms=10.0, lanes=2), dict(slo_budget_ms=10.0),
    dict(slo_budget_ms=10.0, error_policy="retry"),
    dict(slo_budget_ms=10.0, watchdog_s=1.0),
])
def test_unported_pipeline_options_raise(kwargs):
    """Every pipeline option of the JAX package is ported: the SLO budget
    attaches the scheduler beside the other options. What the scheduler
    still lacks, the serving mesh's admission quantum, raises naming
    ROADMAP A.24."""
    from nnstreamer_tpu_torch.serving.scheduler import ensure_scheduler

    pipe = Pipeline(**kwargs)
    assert pipe.slo_budget_ms == 10.0
    sched = ensure_scheduler(pipe)
    assert sched is pipe._slo_scheduler and sched.budget_ms == 10.0
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md, A\.24"):
        sched.note_mesh(2)


def test_unknown_property_is_an_error():
    with pytest.raises(KeyError):
        tnt.parse_launch("videotestsrc ! queue no-such-thing=1 ! tensor_sink")


def test_host_transform_keeps_the_negotiated_dtype():
    """ROADMAP.md C.1: with acceleration=false the JAX package computes in
    numpy, which promotes uint8 + float to float64 while its caps say
    float32; the port computes in torch and delivers the float32 its caps
    announce."""
    from nnstreamer_tpu.elements.transform import _TransformSpec as JaxSpec
    from nnstreamer_tpu_torch.elements.transform import _TransformSpec

    x = np.arange(6, dtype=np.uint8)
    option = "add:-127.5,div:127.5"
    assert JaxSpec("arithmetic", option, False)(x).dtype == np.float64
    pipe = tnt.parse_launch(
        "appsrc name=src ! tensor_transform mode=arithmetic "
        f"option={option} acceleration=false ! tensor_sink name=out")
    out = []
    pipe.get("out").connect(lambda buf: out.append(buf))
    pipe.start()
    try:
        pipe.get("src").push([x])
        pipe.get("src").end_of_stream()
        pipe.wait(timeout=30)
    finally:
        pipe.stop()
    assert len(out) == 1 and out[0][0].dtype == np.float32
    spec = _TransformSpec("arithmetic", option)
    np.testing.assert_allclose(out[0][0], (x - 127.5) / 127.5, rtol=1e-6)
    assert spec.apply(torch.from_numpy(x)).dtype is torch.float32
