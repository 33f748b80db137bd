"""The port's audio path: ``audiotestsrc``, the converter's audio, octet
and text media, ``filesrc``, the ``direct_video`` decoder and the audio
classifier (``models/audio_classifier.py``), held to the JAX package's.

The classifier takes the JAX model's variables through
``params_from_jax``: float32 logits within 1e-4 (max abs), bfloat16
within a relative L2 of 2e-2, on seeded numpy windows. The launch strings
of ``tests/test_elements.py``'s audio, octet and direct-video cases run
through both packages on the CPU with the same weights; their tensors,
timestamps and labels must be equal. ``gpu``-marked tests at the end run
the keyword-spotting string and the file path on the card.
"""

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
from nnstreamer_tpu.models.audio_classifier import (
    audio_classifier as jax_audio_classifier,
)
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.models.audio_classifier import (
    AudioClassifier,
    audio_classifier,
    params_from_jax,
)
from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline

FP32_ATOL = 1e-4
BF16_REL_L2 = 2e-2


@pytest.fixture
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


def _windows(n, samples, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, (n, samples, 1)).astype(np.float32)


def _port_model(variables, num_classes, dtype):
    module = AudioClassifier(num_classes=num_classes)
    module.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, variables)))
    module = module.to(dtype).eval()
    module.dense1.float()
    return module


@pytest.mark.parametrize("seed", [0, 3])
def test_factory_weights_are_the_jax_models(seed):
    """The port's factory fills the JAX package's seeded weights."""
    _, variables, j_in, j_out = jax_audio_classifier(
        samples=1600, num_classes=4, seed=seed)
    module, t_in, t_out = audio_classifier(samples=1600, num_classes=4,
                                           dtype=torch.float32, seed=seed)
    want = params_from_jax(jax.tree.map(np.asarray, variables))
    got = module.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert (str(t_in), str(t_out)) == (str(j_in), str(j_out))


@pytest.mark.parametrize("batch", [1, 3])
def test_fp32_logits_match_jax(batch):
    apply_fn, variables, _, _ = jax_audio_classifier(
        samples=1600, num_classes=4, dtype=jnp.float32, seed=5)
    module = _port_model(variables, 4, torch.float32)
    x = _windows(batch, 1600, seed=batch)
    want = np.asarray(apply_fn(variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = module(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (batch, 4)
    assert np.abs(got - want).max() <= FP32_ATOL


def test_unbatched_window_takes_the_converter_layout():
    apply_fn, variables, _, _ = jax_audio_classifier(
        samples=1600, num_classes=4, dtype=jnp.float32, seed=2)
    module = _port_model(variables, 4, torch.float32)
    x = _windows(1, 1600, seed=9)[0]  # [samples, ch]
    want = np.asarray(apply_fn(variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = module(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 4)
    assert np.abs(got - want).max() <= FP32_ATOL


def test_bf16_logits_match_jax():
    apply_fn, variables, _, _ = jax_audio_classifier(
        samples=1600, num_classes=4, seed=7)  # bfloat16, as the JAX default
    module = _port_model(variables, 4, torch.bfloat16)
    assert module.convs[0].weight.dtype is torch.bfloat16
    assert module.dense1.weight.dtype is torch.float32
    x = _windows(4, 1600, seed=11)
    want = np.asarray(apply_fn(variables, jnp.asarray(x)), np.float32)
    with torch.inference_mode():
        got = module(torch.from_numpy(x))
    assert got.dtype is torch.float32
    got = got.numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= BF16_REL_L2, rel


@pytest.mark.parametrize("n", [1600, 1601, 16000])
def test_same_padding_lengths(n):
    """Odd and even lengths through the four strided convolutions: the
    output is [1, classes] whatever the SAME pads are."""
    apply_fn, variables, _, _ = jax_audio_classifier(
        samples=n, num_classes=3, dtype=jnp.float32, seed=1)
    module = _port_model(variables, 3, torch.float32)
    x = _windows(1, n, seed=n)
    want = np.asarray(apply_fn(variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = module(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= FP32_ATOL


# -- launch strings through both packages ---------------------------------------
def _run(pkg, desc, sink="out"):
    pipe = pkg.parse_launch(desc)
    msg = pipe.run(timeout=120)
    assert msg is not None and msg.kind == "eos", msg
    return pipe, list(pipe.get(sink).buffers)


def _host(t):
    return np.asarray(t)


def test_audio_to_tensor_matches_jax(cpu_device):
    """``tests/test_elements.py::test_audio_to_tensor``."""
    desc = ("audiotestsrc num-buffers=3 samplesperbuffer=160 ! "
            "tensor_converter ! tensor_sink name=out")
    jpipe, want = _run(jnt, desc)
    tpipe, got = _run(tnt, desc)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a[0].shape == (160, 1) and a[0].dtype == np.int16
        np.testing.assert_array_equal(_host(a[0]), _host(b[0]))
        assert (a.pts, a.duration) == (b.pts, b.duration)
    assert str(tpipe.get("out").sinkpad.caps) == \
        str(jpipe.get("out").sinkpad.caps)


@pytest.mark.parametrize("fmt,channels", [("S16LE", 1), ("F32LE", 2),
                                          ("S8", 1), ("U8", 3)])
def test_audiotestsrc_bytes_match_jax(cpu_device, fmt, channels):
    desc = (f"audiotestsrc num-buffers=4 samplesperbuffer=100 rate=8000 "
            f"format={fmt} channels={channels} freq=300 ! "
            "tensor_converter ! tensor_sink name=out")
    _, want = _run(jnt, desc)
    _, got = _run(tnt, desc)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a[0].tobytes() == _host(b[0]).tobytes()
        assert a.pts == b.pts


@pytest.mark.parametrize("fpt,spb", [(400, 300), (100, 160), (160, 160)])
def test_audio_rechunk_pts_match_jax(cpu_device, fpt, spb):
    """ROADMAP C.30 (both packages): every chunk the audio adapter emits
    carries the pts of the first buffer it held, the chunks cut from a
    carried-over remainder included, instead of the pts of its own first
    sample."""
    desc = (f"audiotestsrc num-buffers=5 samplesperbuffer={spb} "
            f"rate=16000 ! tensor_converter frames-per-tensor={fpt} ! "
            "tensor_sink name=out")
    _, want = _run(jnt, desc)
    _, got = _run(tnt, desc)
    assert len(got) == len(want) == 5 * spb // fpt
    assert [b.pts for b in got] == [b.pts for b in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_host(a[0]), _host(b[0]))
    if spb % fpt:
        # the shared fault, pinned: a chunk that starts past the first
        # buffer still carries that buffer's pts
        assert got[1].pts == got[0].pts == 0


def test_octet_rechunk_matches_jax(cpu_device, tmp_path):
    """``tests/test_elements.py::test_octet_rechunk``."""
    raw = np.arange(64, dtype=np.uint8).tobytes()
    f = tmp_path / "data.raw"
    f.write_bytes(raw)
    desc = (f"filesrc location={f} blocksize=10 ! "
            "tensor_converter input-dim=16 input-type=uint8 ! "
            "tensor_sink name=out")
    _, want = _run(jnt, desc)
    _, got = _run(tnt, desc)
    assert len(got) == len(want) == 4
    np.testing.assert_array_equal(
        np.concatenate([b[0].reshape(-1) for b in got]),
        np.frombuffer(raw, np.uint8))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_host(a[0]), _host(b[0]))


@pytest.mark.parametrize("dim,typ,block", [
    ("4:3", "float32", 7), ("2:2", "int16", 5), ("5", "uint8", -1)])
def test_octet_types_and_blocks_match_jax(cpu_device, tmp_path, dim, typ,
                                          block):
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 256, 480, dtype=np.uint8).tobytes()
    f = tmp_path / "data.raw"
    f.write_bytes(raw)
    desc = (f"filesrc location={f} blocksize={block} ! tensor_converter "
            f"input-dim={dim} input-type={typ} ! tensor_sink name=out")
    jpipe, want = _run(jnt, desc)
    tpipe, got = _run(tnt, desc)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a[0].dtype == np.dtype(typ)
        assert a[0].tobytes() == _host(b[0]).tobytes()
    assert str(tpipe.get("out").sinkpad.caps) == \
        str(jpipe.get("out").sinkpad.caps)


def test_text_needs_input_dim(cpu_device, tmp_path):
    from nnstreamer_tpu_torch.elements.converter import TensorConverter
    from nnstreamer_tpu_torch.pipeline.caps import Caps

    conv = TensorConverter()
    with pytest.raises(ValueError, match="input-dim"):
        conv.transform_caps(conv.sinkpad, Caps("text/x-raw",
                                               {"format": "utf8"}))
    conv = TensorConverter(input_dim="8", input_type="uint8")
    caps = conv.transform_caps(conv.sinkpad, Caps("text/x-raw",
                                                  {"format": "utf8"}))
    assert caps["dimensions"] == "8"


def test_octet_without_input_dim_is_one_tensor_a_buffer(cpu_device,
                                                        tmp_path):
    f = tmp_path / "data.raw"
    f.write_bytes(bytes(range(30)))
    desc = (f"filesrc location={f} blocksize=12 ! tensor_converter "
            "format=flexible ! tensor_sink name=out")
    tpipe, got = _run(tnt, desc)
    jpipe, want = _run(jnt, desc)
    assert [b[0].tobytes() for b in got] == \
        [_host(b[0]).tobytes() for b in want]
    assert [len(b[0]) for b in got] == [12, 12, 6]
    assert tpipe.get("out").sinkpad.caps["format"] == "flexible"


@pytest.mark.parametrize("props,safe", [
    ("", True), ("input-dim=3:4:4:1", False),
    ("mode=custom-code:python3", False), ("frames-per-tensor=4", False)])
def test_reorder_safe_follows_jax(props, safe):
    from nnstreamer_tpu.elements.converter import (
        TensorConverter as JaxConverter,
    )
    from nnstreamer_tpu_torch.elements.converter import TensorConverter

    kw = dict(p.split("=", 1) for p in props.split()) if props else {}
    kw = {k.replace("-", "_"): v for k, v in kw.items()}
    assert TensorConverter(**kw).reorder_safe() is safe
    assert JaxConverter(**kw).reorder_safe() is safe


def test_direct_video_roundtrip_matches_jax(cpu_device):
    """``tests/test_elements.py::test_direct_video_roundtrip``."""
    desc = ("videotestsrc num-buffers=2 width=16 height=8 ! "
            "tensor_converter ! tensor_decoder mode=direct_video ! "
            "tensor_sink name=out")
    jpipe, want = _run(jnt, desc)
    tpipe, got = _run(tnt, desc)
    assert got[0][0].shape == (8, 16, 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_host(a[0]), _host(b[0]))
    caps = tpipe.get("out").sinkpad.caps
    assert caps.name == "video/x-raw"
    assert caps["width"] == 16 and caps["height"] == 8
    assert str(caps) == str(jpipe.get("out").sinkpad.caps)


def test_direct_video_takes_a_bf16_host_tensor():
    from nnstreamer_tpu_torch.decoders.direct_video import DirectVideo
    from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

    x = torch.arange(24, dtype=torch.bfloat16).reshape(1, 2, 4, 3)
    out = DirectVideo().decode(TensorBuffer([x]), None, {})
    np.testing.assert_array_equal(out[0], np.arange(24).reshape(2, 4, 3))


def _models(name, samples, classes, seed):
    apply_fn, variables, in_info, out_info = jax_audio_classifier(
        samples=samples, num_classes=classes, dtype=jnp.float32, seed=seed)
    register_jax_model(name, apply_fn, variables, in_info=in_info,
                       out_info=out_info)
    module = _port_model(variables, classes, torch.float32)
    register_torch_model(name, module, *audio_classifier(
        samples=samples, num_classes=classes)[1:])


def test_audio_classifier_pipeline_matches_jax(cpu_device):
    """``tests/test_elements.py::TestAudioModelPipeline::
    test_audio_classifier_pipeline``, through both packages with the same
    float32 weights: equal labels, scores within 1e-4."""
    samples = 1600
    _models("kws_test", samples, 4, seed=0)
    desc = (f"audiotestsrc num-buffers=3 samplesperbuffer={samples} ! "
            f"tensor_converter frames-per-tensor={samples} ! "
            "tensor_transform mode=arithmetic "
            "option=typecast:float32,div:32768 ! "
            "tensor_filter framework=jax model=kws_test ! "
            "tensor_decoder mode=image_labeling ! "
            "tensor_sink name=out to-host=true")
    try:
        _, want = _run(jnt, desc)
        tpipe, got = _run(tnt, desc)
    finally:
        unregister_jax_model("kws_test")
        unregister_torch_model("kws_test")
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert 0 <= int(a.meta["label_index"]) < 4
        assert a.meta["label_index"] == b.meta["label_index"]
        assert bytes(a[0]).decode() == str(a.meta["label_index"])
        assert abs(a.meta["score"] - b.meta["score"]) <= FP32_ATOL
    (region,) = tpipe._regions  # transform ! filter ! decoder, fused
    assert [m.ELEMENT_NAME for m in region.members] == [
        "tensor_transform", "tensor_filter", "tensor_decoder"]


def test_audio_windowed_aggregation_matches_jax(cpu_device):
    """``tests/test_elements.py::TestAudioModelPipeline::
    test_audio_windowed_aggregation``: the aggregator windows 200-sample
    chunks into the model's 800; the logits of both packages agree."""
    _models("kws_win", 800, 3, seed=1)
    desc = ("audiotestsrc num-buffers=8 samplesperbuffer=200 ! "
            "tensor_converter ! "
            "tensor_aggregator frames-in=200 frames-out=800 "
            "frames-dim=1 concat=true ! "
            "tensor_transform mode=arithmetic "
            "option=typecast:float32,div:32768 ! "
            "tensor_filter framework=jax model=kws_win ! "
            "tensor_sink name=out to-host=true")
    try:
        _, want = _run(jnt, desc)
        _, got = _run(tnt, desc)
    finally:
        unregister_jax_model("kws_win")
        unregister_torch_model("kws_win")
    assert len(got) == len(want) == 2  # 8 × 200 samples → 2 × 800 windows
    for a, b in zip(got, want):
        assert np.asarray(a[0]).reshape(-1).shape == (3,)
        assert np.abs(np.asarray(a[0]) - np.asarray(b[0])).max() <= \
            FP32_ATOL


def test_kws_string_with_hop_matches_jax(cpu_device):
    """The keyword-spotting string of the card's ``audio`` phase at a tenth
    of its rate: 100 ms chunks into 1 s windows with a 0.5 s hop."""
    _models("kws_hop", 1600, 4, seed=2)
    desc = ("audiotestsrc num-buffers=40 samplesperbuffer=160 rate=1600 "
            "format=S16LE ! tensor_converter ! tensor_aggregator "
            "frames-in=160 frames-out=1600 frames-flush=800 frames-dim=1 "
            "concat=true ! tensor_transform mode=arithmetic "
            "option=typecast:float32,div:32768 ! "
            "tensor_filter framework=jax model=kws_hop ! "
            "tensor_decoder mode=image_labeling ! tensor_sink name=out")
    try:
        _, want = _run(jnt, desc)
        _, got = _run(tnt, desc)
    finally:
        unregister_jax_model("kws_hop")
        unregister_torch_model("kws_hop")
    assert len(got) == len(want) == (40 * 160 - 1600) // 800 + 1
    assert [b.meta["label_index"] for b in got] == \
        [b.meta["label_index"] for b in want]
    assert [b.pts for b in got] == [b.pts for b in want]


# -- on the card -----------------------------------------------------------------
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the path runs on the card")
    tnt.set_device(None)


def _rows(desc, name, fuse=True):
    pipe = tnt.parse_launch(desc, pipeline=Pipeline(fuse=fuse, name=name))
    msg = pipe.run(timeout=300)
    assert msg is not None and msg.kind == "eos", msg
    return pipe, [(b.meta["label_index"], b.meta["score"])
                  for b in pipe.get("out").buffers]


@pytest.mark.gpu
def test_kws_fused_equals_unfused_on_the_card():
    _needs_card()
    from nnstreamer_tpu_torch.ops import preprocess as pp

    module, in_info, out_info = audio_classifier(samples=16000, seed=0)
    register_torch_model("kws_card", module, in_info, out_info)
    desc = ("audiotestsrc num-buffers=100 samplesperbuffer=1600 rate=16000 "
            "format=S16LE ! tensor_converter ! tensor_aggregator "
            "frames-in=1600 frames-out=16000 frames-flush=8000 frames-dim=1 "
            "concat=true ! tensor_transform mode=arithmetic "
            "option=typecast:float32,div:32768 ! "
            "tensor_filter framework=jax model=kws_card ! "
            "tensor_decoder mode=image_labeling ! tensor_sink name=out")
    try:
        pp.reset_launches()
        pipe, fused = _rows(desc, "kws_card_fused")
        launches = pp.LAUNCHES.get("normalize_chain", 0)
        _, unfused = _rows(desc, "kws_card_unfused", fuse=False)
    finally:
        unregister_torch_model("kws_card")
    windows = (100 * 1600 - 16000) // 8000 + 1
    assert len(fused) == len(unfused) == windows
    assert fused == unfused
    (region,) = pipe._regions
    assert region.captures == 1 and launches == windows


@pytest.mark.gpu
def test_files_label_as_videotestsrc_on_the_card(tmp_path):
    _needs_card()
    from nnstreamer_tpu_torch.models.mobilenet_v2 import mobilenet_v2

    n, size = 16, 64
    module, in_info, out_info = mobilenet_v2(num_classes=10,
                                             image_size=size, seed=0)
    register_torch_model("files_card", module, in_info, out_info)
    _, frames = _run(tnt, f"videotestsrc num-buffers=1 width={size} "
                          f"height={size} pattern=gradient ! "
                          "tensor_converter ! tensor_sink name=out")
    frame = np.asarray(frames[0][0]).tobytes()
    for i in range(n):
        (tmp_path / f"f_{i:04d}.raw").write_bytes(frame)
    (tmp_path / "all.raw").write_bytes(frame * n)
    tail = ("tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! "
            "tensor_filter framework=jax model=files_card ! "
            "tensor_decoder mode=image_labeling ! tensor_sink name=out")
    conv = f"tensor_converter input-dim=3:{size}:{size}:1 input-type=uint8"
    try:
        _, want = _rows(f"videotestsrc num-buffers={n} width={size} "
                        f"height={size} pattern=gradient ! "
                        f"tensor_converter ! {tail}", "files_vts")
        _, multi = _rows(f"multifilesrc location={tmp_path}/f_%04d.raw ! "
                         f"{conv} ! {tail}", "files_multi")
        _, whole = _rows(f"filesrc location={tmp_path}/all.raw "
                         f"blocksize=5000 ! {conv} ! {tail}", "files_whole")
    finally:
        unregister_torch_model("files_card")
    assert len(want) == n
    assert multi == want and whole == want
