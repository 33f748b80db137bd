"""The port's stream algebra — ``tensor_demux``, ``tensor_split``,
``join``, ``tensor_if``, ``tensor_crop`` and the ``custom``/``custom-easy``
filters (``elements/demux.py``, ``split.py``, ``join.py``, ``cond.py``,
``crop.py``, ``filters/custom.py``, ``tensors/data.py``) — held to the
JAX package's.

The cases are ``tests/test_stream_algebra.py``'s ``TestMuxDemux``,
``TestMergeSplit``, ``TestTeeJoin``, ``TestIf`` and ``TestCrop``: each
launch string (or element graph) runs through both packages on the CPU,
and the buffers' tensors, counts, timestamps and caps must be equal.
"""

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt


@pytest.fixture
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


def _run(pkg, desc, timeout=60):
    pipe = pkg.parse_launch(desc)
    msg = pipe.run(timeout=timeout)
    assert msg is not None and msg.kind == "eos", f"pipeline failed: {msg}"
    return pipe


def _tensors(buf):
    return [np.asarray(t) for t in buf.tensors]


def _same_sinks(desc, sinks, *, order=True):
    """Run ``desc`` through both packages; every named sink gets equal
    buffers (in order, or as a multiset of payloads with ``order=False``).
    Returns the port's pipeline."""
    jp, tp = _run(jnt, desc), _run(tnt, desc)
    for s in sinks:
        want = [_tensors(b) for b in jp.get(s).buffers]
        got = [_tensors(b) for b in tp.get(s).buffers]
        assert len(got) == len(want), s
        if not order:
            key = (lambda ts: b"".join(t.tobytes() for t in ts))
            want, got = sorted(want, key=key), sorted(got, key=key)
        for a, b in zip(got, want):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x, y)
        if order:
            assert [b.pts for b in tp.get(s).buffers] == \
                [b.pts for b in jp.get(s).buffers]
        jc, tc = jp.get(s).sinkpad.caps, tp.get(s).sinkpad.caps
        assert str(tc) == str(jc), s
    return tp


# -- TestMuxDemux -------------------------------------------------------------
def test_demux_tensorpick_matches_jax(cpu_device):
    tp = _same_sinks(
        "videotestsrc num-buffers=3 width=8 height=8 ! tensor_converter ! "
        "mux.  videotestsrc num-buffers=3 width=4 height=4 ! "
        "tensor_converter ! mux.  tensor_mux name=mux ! "
        "tensor_demux name=d tensorpick=1 ! tensor_sink name=out", ["out"])
    bufs = tp.get("out").buffers
    assert len(bufs) == 3 and bufs[0].num_tensors == 1
    assert bufs[0][0].shape == (1, 4, 4, 3)


def test_demux_two_branches_matches_jax(cpu_device):
    tp = _same_sinks(
        "videotestsrc num-buffers=2 width=8 height=8 ! tensor_converter ! "
        "mux.  audiotestsrc num-buffers=2 samplesperbuffer=64 ! "
        "tensor_converter ! mux.  tensor_mux name=mux ! tensor_demux name=d "
        " d. ! tensor_sink name=video_out  d. ! tensor_sink name=audio_out",
        ["video_out", "audio_out"])
    assert tp.get("video_out").buffers[0][0].dtype == np.uint8
    assert tp.get("audio_out").buffers[0][0].dtype == np.int16


def test_demux_groups_match_jax(cpu_device):
    """``tensorpick=0:2,1``: pad 0 gets tensors 0 and 2, pad 1 tensor 1."""
    tp = _same_sinks(
        "tensor_mux name=m sync-mode=nosync ! tensor_demux name=d "
        "tensorpick=0:2,1  d.src_0 ! tensor_sink name=a  "
        "d.src_1 ! tensor_sink name=b  " + " ".join(
            f"videotestsrc num-buffers=2 width={w} height=4 "
            f"pattern={p} ! tensor_converter ! m." for w, p in
            ((4, "gradient"), (6, "black"), (8, "smpte"))), ["a", "b"])
    assert [t.shape for t in tp.get("a").buffers[0].tensors] == \
        [(1, 4, 4, 3), (1, 4, 8, 3)]


def test_mux_demux_passes_tensors_by_reference(cpu_device):
    """No copy: the demuxed tensor is the object the source pushed."""
    from nnstreamer_tpu_torch.elements.demux import TensorDemux
    from nnstreamer_tpu_torch.elements.sink import TensorSink
    from nnstreamer_tpu_torch.elements.source import AppSrc
    from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

    src, demux = AppSrc(name="src"), TensorDemux(tensorpick="1,0")
    a, b = TensorSink(name="a"), TensorSink(name="b", to_host=False)
    pipe = Pipeline().add(src, demux, a, b)
    src.link(demux)
    demux.link(a)
    demux.link(b)
    x, y = torch.arange(4.0), torch.arange(6, dtype=torch.int32)
    pipe.start()
    src.push([x, y])
    src.end_of_stream()
    pipe.wait(timeout=15)
    pipe.stop()
    assert b.buffers[0].tensors[0] is x
    np.testing.assert_array_equal(a.buffers[0][0], y.numpy())


# -- TestMergeSplit -------------------------------------------------------------
def test_split_inverse_of_merge_matches_jax(cpu_device):
    tp = _same_sinks(
        "videotestsrc num-buffers=2 width=8 height=8 ! tensor_converter ! "
        "tensor_split name=s tensorseg=4,4 dimension=1 ! "
        "tensor_sink name=o1  s. ! tensor_sink name=o2", ["o1", "o2"])
    o1, o2 = tp.get("o1").buffers, tp.get("o2").buffers
    assert o1[0][0].shape == (1, 8, 4, 3)
    assert o2[0][0].shape == (1, 8, 4, 3)


def test_merge_then_split_roundtrip_matches_jax(cpu_device):
    """``TestMergeSplit::test_merge_batches_on_dim``'s batch of 2, split
    back into its two frames along the batch dim."""
    tp = _same_sinks(
        "videotestsrc num-buffers=3 width=8 height=8 ! tensor_converter ! "
        "m.  videotestsrc num-buffers=3 width=8 height=8 pattern=black ! "
        "tensor_converter ! m.  tensor_merge name=m mode=linear option=3 ! "
        "tensor_split name=s tensorseg=1,1 dimension=3  "
        "s. ! tensor_sink name=a  s. ! tensor_sink name=b", ["a", "b"])
    assert tp.get("a").buffers[0][0].shape == (1, 8, 8, 3)
    assert not np.asarray(tp.get("b").buffers[0][0]).any()  # black


def test_split_bad_seg_errors_as_jax(cpu_device):
    from nnstreamer_tpu.pipeline.element import FlowError as JaxFlowError
    from nnstreamer_tpu_torch.pipeline.element import FlowError

    desc = ("videotestsrc num-buffers=1 width=8 height=8 ! tensor_converter "
            "! tensor_split tensorseg=3,3 dimension=1 ! fakesink")
    for pkg, err in ((jnt, JaxFlowError), (tnt, FlowError)):
        with pytest.raises(err, match="tensorseg sums"):
            pkg.parse_launch(desc).run(timeout=15)


@pytest.mark.parametrize("seg,dim", [("1:4:8:1,1:4:8:1", 1), ("2,1", 0),
                                     ("3,5", 2)])
def test_split_parts_are_views(seg, dim):
    """The parts are views of the input tensor (no copy), for a numpy
    array and a torch tensor, along any dimension."""
    from nnstreamer_tpu_torch.elements.split import TensorSplit
    from nnstreamer_tpu_torch.pipeline.element import FlowReturn
    from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

    split = TensorSplit(tensorseg=seg, dimension=dim)
    got = []
    split._ensure_pads(2)
    for sp in split.srcpads:
        sp.push = lambda buf, got=got: got.append(buf) or FlowReturn.OK
    for x in (np.arange(8 * 8 * 3, dtype=np.uint8).reshape(1, 8, 8, 3),
              torch.arange(8 * 8 * 3.0).reshape(1, 8, 8, 3)):
        got.clear()
        split.chain(split.sinkpad, TensorBuffer([x]))
        parts = [b[0] for b in got]
        axis = x.ndim - 1 - dim
        cat = np.concatenate([np.asarray(p) for p in parts], axis=axis)
        np.testing.assert_array_equal(cat, np.asarray(x))
        for p in parts:
            if isinstance(p, np.ndarray):
                assert np.shares_memory(p, x)
            else:
                assert p.untyped_storage().data_ptr() == \
                    x.untyped_storage().data_ptr()


# -- TestTeeJoin ------------------------------------------------------------------
def test_tee_fanout_matches_jax(cpu_device):
    _same_sinks(
        "videotestsrc num-buffers=3 width=8 height=8 ! tensor_converter ! "
        "tee name=t  t. ! tensor_sink name=a  t. ! tensor_sink name=b",
        ["a", "b"])


def test_join_interleaves_matches_jax(cpu_device):
    """Two source threads: the arrival order differs run to run, so the
    payloads are compared as a multiset."""
    tp = _same_sinks(
        "videotestsrc num-buffers=2 width=8 height=8 ! tensor_converter ! "
        "j.  videotestsrc num-buffers=2 width=8 height=8 pattern=black ! "
        "tensor_converter ! j.  join name=j ! tensor_sink name=out",
        ["out"], order=False)
    assert len(tp.get("out").buffers) == 4
    assert tp.get("out").eos  # EOS once every sink pad ended


def test_join_reunites_tensor_if_branches_matches_jax(cpu_device):
    """One thread drives both branches: the order is the source's."""
    tp = _same_sinks(
        "videotestsrc num-buffers=6 width=8 height=8 pattern=ball ! "
        "tensor_converter ! tensor_if name=g "
        "compared-value=TENSOR_AVERAGE_VALUE compared-value-option=0 "
        "operator=gt supplied-value=8 then=PASSTHROUGH else=PASSTHROUGH "
        " g.src_true ! tensor_transform mode=typecast option=float32 "
        "acceleration=false ! j.  g.src_false ! tensor_transform "
        "mode=typecast option=float32 acceleration=false ! j.  "
        "join name=j ! tensor_sink name=out", ["out"])
    assert len(tp.get("out").buffers) == 6


# -- TestIf ------------------------------------------------------------------------
@pytest.mark.parametrize("pattern,n", [("black", 0), ("smpte", 4)])
def test_if_average_branch_matches_jax(cpu_device, pattern, n):
    tp = _same_sinks(
        f"videotestsrc num-buffers=4 width=8 height=8 pattern={pattern} ! "
        "tensor_converter ! "
        "tensor_if name=i compared-value=TENSOR_AVERAGE_VALUE "
        "compared-value-option=0 operator=gt supplied-value=10 "
        "then=PASSTHROUGH else=SKIP ! tensor_sink name=bright", ["bright"])
    assert len(tp.get("bright").buffers) == n


def test_if_custom_condition_matches_jax(cpu_device):
    from nnstreamer_tpu.elements.cond import (
        register_if_condition as jax_register,
    )
    from nnstreamer_tpu_torch.elements.cond import register_if_condition

    for reg in (jax_register, register_if_condition):
        reg("every_other", lambda buf: (buf.pts or 0) % 2 == 0)
    tp = _same_sinks(
        "videotestsrc num-buffers=4 width=4 height=4 ! tensor_converter ! "
        "tensor_if compared-value=CUSTOM compared-value-option=every_other "
        "then=PASSTHROUGH else=SKIP ! tensor_sink name=out", ["out"])
    assert len(tp.get("out").buffers) == 2


@pytest.mark.parametrize("op,value", [
    ("eq", "0"), ("ne", "0"), ("ge", "255"), ("le", "0"), ("lt", "128"),
    ("range_inclusive", "0:127"), ("range_exclusive", "0:255"),
    ("not_in_range_inclusive", "1:254"), ("not_in_range_exclusive", "0:128")])
def test_if_operators_on_a_value_match_jax(cpu_device, op, value):
    """``A_VALUE`` at coordinate (ch 0, x 5, y 0, frame 0) of the gradient
    frame, each operator, both branches to their own sinks."""
    _same_sinks(
        "videotestsrc num-buffers=2 width=8 height=4 pattern=gradient ! "
        "tensor_converter ! tensor_if name=g compared-value=A_VALUE "
        f"compared-value-option=0:5:0:0,0 operator={op} "
        f"supplied-value={value} then=PASSTHROUGH else=PASSTHROUGH  "
        "g.src_true ! tensor_sink name=t  g.src_false ! tensor_sink name=f",
        ["t", "f"])


def test_if_tensorpick_matches_jax(cpu_device):
    tp = _same_sinks(
        "tensor_mux name=m sync-mode=nosync ! tensor_if name=g "
        "compared-value=TENSOR_AVERAGE_VALUE compared-value-option=1 "
        "operator=lt supplied-value=1 then=TENSORPICK then-option=0 "
        "else=SKIP ! tensor_sink name=out  "
        "videotestsrc num-buffers=3 width=4 height=4 pattern=smpte ! "
        "tensor_converter ! m.  videotestsrc num-buffers=3 width=4 "
        "height=4 pattern=black ! tensor_converter ! m.", ["out"])
    assert tp.get("out").buffers[0].num_tensors == 1


def test_if_takes_host_torch_tensors():
    """A CPU ``torch.Tensor`` payload (``bfloat16`` included) is read
    through ``tensors/data.py`` as the numpy one."""
    from nnstreamer_tpu_torch.elements.cond import TensorIf
    from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

    g = TensorIf(compared_value="TENSOR_AVERAGE_VALUE",
                 compared_value_option="0", operator="gt",
                 supplied_value="1.5")
    for dt in (torch.float32, torch.bfloat16, torch.int16):
        x = torch.tensor([1, 2, 3, 4], dtype=dt)
        assert g._evaluate(TensorBuffer([x])) is True
    g = TensorIf(compared_value="A_VALUE", compared_value_option="2,0",
                 operator="eq", supplied_value="3")
    assert g._evaluate(TensorBuffer([torch.tensor([1.0, 2.0, 3.0],
                                                  dtype=torch.bfloat16)]))


def test_data_helpers_match_jax():
    from nnstreamer_tpu.tensors import data as jdata
    from nnstreamer_tpu_torch.tensors import data

    rng = np.random.default_rng(3)
    x = rng.normal(0, 300, (5, 7)).astype(np.float32)
    for dst in ("uint8", "int8", "int16", "float16", "int32"):
        np.testing.assert_array_equal(data.typecast(x, dst),
                                      jdata.typecast(x, dst))
    assert data.average(x) == jdata.average(x)
    assert data.scalar_at(x, 11) == jdata.scalar_at(x, 11)
    assert data.average(torch.from_numpy(x)) == jdata.average(x)
    with pytest.raises(ValueError, match="host arrays"):
        data.average(torch.zeros(2, device="meta"))


# -- TestCrop -------------------------------------------------------------------
def _crop_pipe(pkg, **props):
    """appsrc img → crop.raw, appsrc info → crop.info, crop → sink."""
    if pkg is jnt:
        from nnstreamer_tpu.elements.crop import TensorCrop
        from nnstreamer_tpu.elements.sink import TensorSink
        from nnstreamer_tpu.elements.source import AppSrc
        from nnstreamer_tpu.pipeline.pipeline import Pipeline
    else:
        from nnstreamer_tpu_torch.elements.crop import TensorCrop
        from nnstreamer_tpu_torch.elements.sink import TensorSink
        from nnstreamer_tpu_torch.elements.source import AppSrc
        from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

    img_src, info_src = AppSrc(name="img"), AppSrc(name="info")
    crop, sink = TensorCrop(**props), TensorSink()
    pipe = Pipeline().add(img_src, info_src, crop, sink)
    img_src.srcpad.link(crop.raw_pad)
    info_src.srcpad.link(crop.info_pad)
    crop.link(sink)
    return pipe, img_src, info_src, sink


def _crop_both(pushes, **props):
    """``pushes``: (pad, arrays, pts) in order. Returns (port, jax) sink
    buffers."""
    out = []
    for pkg in (tnt, jnt):
        pipe, img_src, info_src, sink = _crop_pipe(pkg, **props)
        pipe.start()
        for pad, arrays, pts in pushes:
            (img_src if pad == "img" else info_src).push(arrays, pts=pts)
        img_src.end_of_stream()
        info_src.end_of_stream()
        pipe.wait(timeout=15)
        pipe.stop()
        out.append(list(sink.buffers))
    got, want = out
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.num_tensors == b.num_tensors
        for x, y in zip(a.tensors, b.tensors):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert a.meta["crop_regions"] == b.meta["crop_regions"]
        assert a.meta["crop_num_tensors"] == b.meta["crop_num_tensors"]
    return got


def test_crop_regions_match_jax():
    img = np.arange(16 * 16 * 3, dtype=np.uint8).reshape(1, 16, 16, 3)
    regions = np.array([[2, 3, 4, 5], [0, 0, 8, 8]], np.int32)
    (out,) = _crop_both([("img", [img], 0), ("info", [regions], 0)])
    assert out.num_tensors == 2
    assert out[0].shape == (5, 4, 3)
    assert out[1].shape == (8, 8, 3)
    np.testing.assert_array_equal(out[1], img[0, :8, :8])


def test_crop_multi_tensor_frames_match_jax():
    a = np.arange(16 * 16 * 3, dtype=np.uint8).reshape(1, 16, 16, 3)
    b = np.arange(16 * 16, dtype=np.float32).reshape(16, 16)
    regions = np.array([[0, 0, 4, 4], [8, 8, 2, 2]], np.int32)
    (out,) = _crop_both([("img", [a, b], 0), ("info", [regions], 0)])
    assert out.num_tensors == 4  # region-major: r0(a, b), r1(a, b)
    assert out[0].shape == (4, 4, 3) and out[1].shape == (4, 4)
    np.testing.assert_array_equal(out[3], b[8:10, 8:10])
    assert out.meta["crop_num_tensors"] == 2


def test_crop_lateness_drops_old_info_as_jax():
    img = np.zeros((1, 8, 8, 3), np.uint8)
    r = np.array([[0, 0, 2, 2]], np.int32)
    got = _crop_both([("info", [r], 0), ("img", [img], 1_000_000_000),
                      ("info", [np.array([[0, 0, 3, 3]], np.int32)],
                       1_000_000_000)], lateness=10)
    assert len(got) == 1
    assert got[0][0].shape == (3, 3, 3)  # the newer info won


def test_crop_lateness_disabled_by_default_as_jax():
    img = np.zeros((1, 8, 8, 3), np.uint8)
    got = _crop_both([("info", [np.array([[0, 0, 2, 2]], np.int32)], 0),
                      ("img", [img], 5_000_000_000)])
    assert len(got) == 1 and got[0][0].shape == (2, 2, 3)


def test_crop_takes_host_torch_tensors():
    """A CPU tensor frame and a tensor of regions crop as the numpy ones."""
    img = np.arange(10 * 12 * 3, dtype=np.uint8).reshape(1, 10, 12, 3)
    regions = np.array([[1, 2, 5, 4]], np.int32)
    pipe, img_src, info_src, sink = _crop_pipe(tnt)
    pipe.start()
    img_src.push([torch.from_numpy(img)], pts=0)
    info_src.push([torch.from_numpy(regions)], pts=0)
    img_src.end_of_stream()
    info_src.end_of_stream()
    pipe.wait(timeout=15)
    pipe.stop()
    np.testing.assert_array_equal(sink.buffers[0][0], img[0, 2:6, 1:6])


# -- the custom filters (tests/test_elements.py::TestFilterCustomEasy) -------------
def _register_scale2x():
    from nnstreamer_tpu.filters import register_custom_easy as jax_register
    from nnstreamer_tpu.tensors.types import TensorsInfo as JaxInfo
    from nnstreamer_tpu_torch.filters import register_custom_easy
    from nnstreamer_tpu_torch.tensors.types import TensorsInfo

    def fn(ins):
        return [np.asarray(ins[0]) * 2.0]

    jax_register("scale2x", fn, JaxInfo.from_str("3:8:8:1", "float32"),
                 JaxInfo.from_str("3:8:8:1", "float32"))
    register_custom_easy("scale2x", fn,
                         TensorsInfo.from_str("3:8:8:1", "float32"),
                         TensorsInfo.from_str("3:8:8:1", "float32"))


def test_custom_easy_invoke_matches_jax(cpu_device):
    _register_scale2x()
    tp = _same_sinks(
        "videotestsrc num-buffers=3 width=8 height=8 ! tensor_converter ! "
        "tensor_transform mode=typecast option=float32 ! "
        "tensor_filter framework=custom-easy model=scale2x name=f ! "
        "tensor_sink name=out", ["out"])
    f = tp.get("f")
    assert f.stats.total_invokes == 3
    assert f.get_property("latency") >= 0
    assert not tp._regions  # a host backend is not fusible


def test_custom_easy_shape_mismatch_rejected(cpu_device):
    from nnstreamer_tpu_torch.pipeline.element import FlowError

    _register_scale2x()
    pipe = tnt.parse_launch(
        "videotestsrc num-buffers=1 width=16 height=16 ! tensor_converter ! "
        "tensor_transform mode=typecast option=float32 ! "
        "tensor_filter framework=custom-easy model=scale2x ! tensor_sink")
    with pytest.raises(FlowError, match="do not match model input"):
        pipe.run(timeout=15)


def test_custom_easy_receives_host_arrays_and_raises_through(cpu_device):
    """The callable gets numpy arrays; an exception it raises fails the
    run (no retry elsewhere)."""
    from nnstreamer_tpu_torch.filters import register_custom_easy
    from nnstreamer_tpu_torch.filters.custom import unregister_custom_easy
    from nnstreamer_tpu_torch.pipeline.element import FlowError
    from nnstreamer_tpu_torch.tensors.types import TensorsInfo

    seen = []

    def fn(ins):
        seen.append(type(ins[0]))
        raise RuntimeError("boom in the callable")

    info = TensorsInfo.from_str("3:4:4:1", "uint8")
    register_custom_easy("boom", fn, info, info)
    try:
        pipe = tnt.parse_launch(
            "appsrc name=src ! tensor_filter framework=custom-easy "
            "model=boom ! tensor_sink")
        pipe.get("src").push([torch.zeros(1, 4, 4, 3, dtype=torch.uint8)])
        pipe.get("src").end_of_stream()
        with pytest.raises(FlowError, match="boom in the callable"):
            pipe.run(timeout=15)
    finally:
        assert unregister_custom_easy("boom")
    assert seen == [np.ndarray]


def test_custom_class_filter_matches_jax(cpu_device):
    """``framework=custom``: a registered FilterFramework subclass with
    dynamic shapes (``set_input_info``)."""
    from nnstreamer_tpu.filters.custom import (
        CustomFilterBase as JaxBase,
        register_custom as jax_register,
    )
    from nnstreamer_tpu_torch.filters.custom import (
        CustomFilterBase,
        register_custom,
    )

    def make(base):
        class Negate(base):
            def set_input_info(self, in_info):
                return in_info

            def invoke(self, inputs):
                return [255 - np.asarray(inputs[0])]
        return Negate

    jax_register("negate", make(JaxBase))
    register_custom("negate", make(CustomFilterBase))
    tp = _same_sinks(
        "videotestsrc num-buffers=2 width=6 height=4 ! tensor_converter ! "
        "tensor_filter framework=custom model=negate ! tensor_sink name=out",
        ["out"])
    assert tp.get("out").buffers[0][0].dtype == np.uint8


def test_unknown_custom_models_raise():
    from nnstreamer_tpu_torch.filters.api import FilterProperties
    from nnstreamer_tpu_torch.filters.custom import (
        CustomEasyFilter,
        CustomFilter,
    )

    with pytest.raises(ValueError, match="register_custom_easy"):
        CustomEasyFilter().open(FilterProperties(model="nope"))
    with pytest.raises(ValueError, match="no registered class"):
        CustomFilter().open(FilterProperties(model="nope"))


# -- appsrc's max-buffers from a launch string (ROADMAP C.31) ----------------------
def test_appsrc_max_buffers_from_a_launch_string():
    """A launch string sets ``max-buffers`` after the element is built:
    the port's queue takes the bound (the JAX package's keeps its default
    of 64, a fault the port does not reproduce)."""
    pipe = tnt.parse_launch("appsrc name=src max-buffers=3 block=false ! "
                            "fakesink")
    src = pipe.get("src")
    assert [src.push([np.zeros(2)]) for _ in range(4)] == \
        [True, True, True, False]
    jsrc = jnt.parse_launch("appsrc name=src max-buffers=3 block=false ! "
                            "fakesink").get("src")
    assert all(jsrc.push([np.zeros(2)]) for _ in range(4))  # still 64
    with pytest.raises(ValueError, match="queued"):
        src.set_property("max-buffers", 8)


@pytest.mark.parametrize("seg,dim", [("4,4", 1), ("1,2", 0)])
def test_split_views_into_the_normalize_chain_match_jax(cpu_device, seg,
                                                        dim):
    """A part cut along an inner dimension is not contiguous; the
    transform's kernel B1 path (its plain version on the CPU) takes it."""
    _same_sinks(
        "videotestsrc num-buffers=2 width=8 height=8 pattern=ball ! "
        f"tensor_converter ! tensor_split name=s tensorseg={seg} "
        f"dimension={dim}  s. ! tensor_transform mode=arithmetic "
        "option=typecast:float32,add:-127.5,div:127.5 ! "
        "tensor_sink name=a  s. ! tensor_sink name=b", ["a", "b"])
