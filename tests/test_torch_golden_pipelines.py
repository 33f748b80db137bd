"""The SSAT-style golden pipelines of ``tests/test_golden_pipelines.py`` on
the port: each launch string ends in ``filesink``, runs through both
packages on the CPU, and the two dumps must be byte-identical and equal
to the numpy golden. The sparse round trip waits for ROADMAP 26d
(``tensor_sparse_enc``/``dec``).
"""

import numpy as np
import pytest

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt


@pytest.fixture
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


def _src_frames(n, w, h, pattern="gradient"):
    """Reference frames exactly as videotestsrc produces them."""
    pipe = jnt.parse_launch(
        f"videotestsrc num-buffers={n} width={w} height={h} "
        f"pattern={pattern} ! tensor_converter ! tensor_sink name=out")
    msg = pipe.run(timeout=60)
    assert msg.kind == "eos"
    return [np.asarray(b[0]) for b in pipe.get("out").buffers]


def _quant_golden():
    from nnstreamer_tpu.elements.quant import quant_decode, quant_encode

    return b"".join(
        quant_decode(quant_encode(f.astype(np.float32)))[0].tobytes()
        for f in _src_frames(2, 8, 8))


def _random_files(d):
    rng = np.random.default_rng(7)
    frames = [rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)
              for _ in range(3)]
    for i, f in enumerate(frames):
        (d / f"img_{i:03d}.raw").write_bytes(f.tobytes())
    return b"".join(f.tobytes() for f in frames)


def _register_half():
    from nnstreamer_tpu.filters import register_custom_easy as jax_register
    from nnstreamer_tpu.tensors.types import TensorsInfo as JaxInfo
    from nnstreamer_tpu_torch.filters import register_custom_easy
    from nnstreamer_tpu_torch.tensors.types import TensorsInfo

    def half(ins):
        return [(np.asarray(ins[0]) // 2).astype(np.uint8)]

    jax_register("golden_half", half, JaxInfo.from_str("3:16:16:1", "uint8"),
                 JaxInfo.from_str("3:16:16:1", "uint8"))
    register_custom_easy("golden_half", half,
                         TensorsInfo.from_str("3:16:16:1", "uint8"),
                         TensorsInfo.from_str("3:16:16:1", "uint8"))


_GRAD = "videotestsrc num-buffers={n} width={w} height={h} pattern=gradient"

# name → (launch string, golden bytes; both may take the temp directory)
CASES = {
    "typecast_arith": (
        _GRAD.format(n=6, w=16, h=16) + " ! tensor_converter ! "
        "tensor_transform mode=arithmetic "
        "option=typecast:float32,add:-127.5,div:128 ! "
        "filesink location={out}",
        lambda d: b"".join(((f.astype(np.float32) - 127.5) / 128.0).tobytes()
                           for f in _src_frames(6, 16, 16))),
    "transpose": (
        _GRAD.format(n=4, w=12, h=8) + " ! tensor_converter ! "
        "tensor_transform mode=transpose option=0:2:1:3 ! "
        "filesink location={out}",
        lambda d: b"".join(np.ascontiguousarray(
            f.transpose(0, 2, 1, 3)).tobytes()
            for f in _src_frames(4, 12, 8))),
    "clamp": (
        _GRAD.format(n=4, w=16, h=16) + " ! tensor_converter ! "
        "tensor_transform mode=clamp option=64:192 ! "
        "filesink location={out}",
        lambda d: b"".join(np.clip(f, 64, 192).tobytes()
                           for f in _src_frames(4, 16, 16))),
    "mux_two_sources": (
        "tensor_mux name=m sync-mode=nosync ! filesink location={out} "
        "videotestsrc num-buffers=5 width=8 height=8 pattern=gradient ! "
        "tensor_converter ! m. "
        "videotestsrc num-buffers=5 width=8 height=8 pattern=black ! "
        "tensor_converter ! m.",
        lambda d: b"".join(x.tobytes() + y.tobytes() for x, y in zip(
            _src_frames(5, 8, 8, "gradient"), _src_frames(5, 8, 8, "black")))),
    "aggregator": (
        _GRAD.format(n=8, w=8, h=8) + " ! tensor_converter ! "
        "tensor_aggregator frames-in=1 frames-out=4 frames-flush=4 "
        "frames-dim=3 concat=true ! filesink location={out}",
        lambda d: b"".join(np.concatenate(
            _src_frames(8, 8, 8)[i:i + 4], axis=0).tobytes()
            for i in (0, 4))),
    "demux_pick": (
        "tensor_mux name=m sync-mode=nosync ! tensor_demux tensorpick=1 ! "
        "filesink location={out} "
        "videotestsrc num-buffers=5 width=8 height=8 pattern=gradient ! "
        "tensor_converter ! m. "
        "videotestsrc num-buffers=5 width=8 height=8 pattern=black ! "
        "tensor_converter ! m.",
        lambda d: b"".join(y.tobytes() for y in
                           _src_frames(5, 8, 8, "black"))),
    "filter_custom_easy": (
        _GRAD.format(n=5, w=16, h=16) + " ! tensor_converter ! "
        "tensor_filter framework=custom-easy model=golden_half ! "
        "filesink location={out}",
        lambda d: b"".join((f // 2).astype(np.uint8).tobytes()
                           for f in _src_frames(5, 16, 16))),
    "multifilesrc_roundtrip": (
        "multifilesrc location={dir}/img_%03d.raw ! "
        "tensor_converter input-dim=3:8:8:1 input-type=uint8 ! "
        "filesink location={out}",
        _random_files),
    "clamp_out_of_range_bounds": (
        _GRAD.format(n=2, w=8, h=8) + " ! tensor_converter ! "
        "tensor_transform mode=clamp option=-1:300 ! "
        "filesink location={out}",
        lambda d: b"".join(f.tobytes() for f in _src_frames(2, 8, 8))),
    "dimchg": (
        _GRAD.format(n=3, w=8, h=6) + " ! tensor_converter ! "
        "tensor_transform mode=dimchg option=0:2 ! "
        "filesink location={out}",
        lambda d: b"".join(np.moveaxis(f, 3, 1).tobytes()
                           for f in _src_frames(3, 8, 6))),
    "split_seg": (
        _GRAD.format(n=3, w=8, h=8) + " ! tensor_converter ! "
        "tensor_split name=s tensorseg=1,2 dimension=0  "
        "s. ! filesink location={out}  s. ! fakesink",
        lambda d: b"".join(f[..., :1].tobytes()
                           for f in _src_frames(3, 8, 8))),
    "merge_linear": (
        "tensor_merge name=m mode=linear option=0 sync-mode=slowest ! "
        "filesink location={out}  "
        "videotestsrc num-buffers=3 width=8 height=8 pattern=gradient ! "
        "tensor_converter ! m.  "
        "videotestsrc num-buffers=3 width=8 height=8 pattern=gradient ! "
        "tensor_converter ! m.",
        lambda d: b"".join(np.concatenate([f, f], axis=-1).tobytes()
                           for f in _src_frames(3, 8, 8))),
    "tensor_if_skip": (
        _GRAD.format(n=3, w=8, h=8) + " ! tensor_converter ! "
        "tensor_if compared-value=TENSOR_AVERAGE_VALUE "
        "compared-value-option=0 operator=lt supplied-value=200 "
        "then=SKIP else=PASSTHROUGH ! filesink location={out}",
        lambda d: b""),
    "tensor_if_passthrough": (
        _GRAD.format(n=2, w=8, h=8) + " ! tensor_converter ! "
        "tensor_if compared-value=TENSOR_AVERAGE_VALUE "
        "compared-value-option=0 operator=lt supplied-value=200 "
        "then=PASSTHROUGH else=SKIP ! filesink location={out}",
        lambda d: b"".join(f.tobytes() for f in _src_frames(2, 8, 8))),
    "quant_roundtrip_exact_on_integers": (
        _GRAD.format(n=2, w=8, h=8) + " ! tensor_converter ! "
        "tensor_transform mode=typecast option=float32 ! "
        "tensor_quant_enc ! tensor_quant_dec ! filesink location={out}",
        lambda d: _quant_golden()),
    "named_pad_references": (
        _GRAD.format(n=3, w=8, h=8) + " ! tensor_converter ! "
        "tensor_split name=s tensorseg=1,2 dimension=0  "
        "s.src_1 ! filesink location={out}  s.src_0 ! fakesink",
        lambda d: b"".join(f[..., 1:].tobytes()
                           for f in _src_frames(3, 8, 8))),
    "named_sink_pads_fix_mux_order": (
        "tensor_mux name=m sync-mode=nosync ! filesink location={out} "
        "videotestsrc num-buffers=3 width=8 height=8 pattern=black ! "
        "tensor_converter ! m.sink_1 "
        "videotestsrc num-buffers=3 width=8 height=8 pattern=gradient ! "
        "tensor_converter ! m.sink_0",
        lambda d: b"".join(x.tobytes() + y.tobytes() for x, y in zip(
            _src_frames(3, 8, 8, "gradient"), _src_frames(3, 8, 8, "black")))),
    "named_sink_with_growing_src_side": (
        _GRAD.format(n=2, w=8, h=8) + " ! tensor_converter ! tee name=t  "
        "t. ! m.sink_0  t. ! m.sink_1  "
        "tensor_mux name=m sync-mode=nosync ! filesink location={out}",
        lambda d: b"".join(f.tobytes() + f.tobytes()
                           for f in _src_frames(2, 8, 8))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden_dump_matches_jax(cpu_device, tmp_path, name):
    desc, golden = CASES[name]
    if name == "filter_custom_easy":
        _register_half()
    want = golden(tmp_path)
    dumps = {}
    for tag, pkg in (("jax", jnt), ("port", tnt)):
        out = tmp_path / f"{tag}.raw"
        pipe = pkg.parse_launch(desc.format(out=out, dir=tmp_path))
        msg = pipe.run(timeout=120)
        assert msg is not None and msg.kind == "eos", (tag, msg)
        dumps[tag] = out.read_bytes()
    assert dumps["port"] == dumps["jax"]  # the two packages, byte for byte
    assert dumps["port"] == want          # and the SSAT golden


def test_filesink_append_and_device_fetch(cpu_device, tmp_path):
    """``append=true`` keeps what the file held; a ``bfloat16`` host
    tensor is dumped as its raw bytes."""
    import torch

    out = tmp_path / "dump.raw"
    out.write_bytes(b"head")
    pipe = tnt.parse_launch(f"appsrc name=src ! filesink location={out} "
                            "append=true")
    x = torch.arange(6, dtype=torch.bfloat16)
    pipe.start()
    pipe.get("src").push([x])
    pipe.get("src").end_of_stream()
    pipe.wait(timeout=30)
    pipe.stop()
    assert out.read_bytes() == b"head" + x.view(torch.int16).numpy().tobytes()


def test_filesink_needs_a_location(cpu_device):
    pipe = tnt.parse_launch("videotestsrc num-buffers=1 ! tensor_converter "
                            "! filesink")
    with pytest.raises(ValueError, match="location"):
        pipe.start()
    pipe.stop()


@pytest.mark.parametrize("desc,match", [
    ("videotestsrc num-buffers=1 ! tensor_converter ! "
     "tensor_sink name=k  k.bogus ! fakesink", "no src pad"),
    ("videotestsrc num-buffers=1 ! tensor_converter ! "
     "tensor_split name=s tensorseg=1,2 dimension=0 "
     "s.src_-1 ! fakesink", "no src pad"),
    ("tensor_mux name=m sync-mode=nosync ! fakesink "
     "videotestsrc num-buffers=1 ! tensor_converter ! m.sink_1",
     "never linked"),
    ("videotestsrc num-buffers=1 ! tensor_converter ! "
     "tensor_sink name=k  k.src_3 ! fakesink", "cannot grow"),
])
def test_named_pad_reference_errors_match_jax(desc, match):
    """``tests/test_golden_pipelines.py::test_named_pad_reference_errors``:
    the same ValueError from both packages' parsers."""
    with pytest.raises(ValueError, match=match):
        jnt.parse_launch(desc)
    with pytest.raises(ValueError, match=match):
        tnt.parse_launch(desc)
