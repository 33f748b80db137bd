"""The port's detection, pose and segmentation decoders, held to the JAX
package's on the cases of ``tests/test_fused_decoders.py``.

For each case the same numpy tensors go through

- the JAX decoder's ``decode()`` (the reference),
- the port's host ``decode()``,
- the port's device half on CPU tensors followed by ``host_finalize()``,

and the detection sets (or keypoints, or label maps) must be equal, their
floats within 1e-5. The device halves' padded row tensors are held to the
JAX device halves' (run by ``jax.jit`` on the CPU) row for row, padding
rows included, which shows the tie order of the stable top-k. The port's
fused and unfused pipelines (``appsrc ! tensor_transform ! tensor_filter !
tensor_decoder``) give the same bytes. ``gpu``-marked tests at the end hold
the device halves on the card to the same halves on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.decoders.bounding_boxes import BoundingBoxes as JaxBoxes
from nnstreamer_tpu.decoders.image_segment import ImageSegment as JaxSegment
from nnstreamer_tpu.decoders.pose_estimation import PoseEstimation as JaxPose
from nnstreamer_tpu.tensors.buffer import TensorBuffer as JaxBuffer
from nnstreamer_tpu_torch.decoders.bounding_boxes import (
    DEVICE_K_PER_CLASS,
    DEVICE_K_TOTAL,
    PAD_SCORE,
    BoundingBoxes,
)
from nnstreamer_tpu_torch.decoders.image_segment import ImageSegment
from nnstreamer_tpu_torch.decoders.pose_estimation import PoseEstimation
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.models.ssd_mobilenet import anchor_grid
from nnstreamer_tpu_torch.pipeline.pipeline import Pipeline
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

FLOAT_TOL = 1e-5


def _opts(text):
    return dict(kv.split("=", 1) for kv in text.split())


def _det_key(d):
    return (d["class"], round(d["score"], 5),
            tuple(round(v, 4) for v in d["box"]))


def _assert_dets_equal(got, want, ordered=False):
    assert len(got) == len(want)
    if not ordered:
        got = sorted(got, key=lambda d: (d["class"], -d["score"], d["box"]))
        want = sorted(want, key=lambda d: (d["class"], -d["score"], d["box"]))
    for a, b in zip(got, want):
        assert a["class"] == b["class"]
        np.testing.assert_allclose(a["score"], b["score"], atol=FLOAT_TOL)
        np.testing.assert_allclose(a["box"], b["box"], atol=FLOAT_TOL)
        assert a.get("label") == b.get("label")


def _halves(dec, arrays, options):
    """The port decoder's host decode() and device half + host_finalize()
    on the same arrays; also the device half's raw rows."""
    host = dec.decode(TensorBuffer([a.copy() for a in arrays]), None, options)
    consts, fn = dec.device_kernel(options)
    rows = fn(consts, [torch.from_numpy(a.copy()) for a in arrays])
    dev = dec.host_finalize(TensorBuffer([r.numpy() for r in rows]), None,
                            options)
    return host, dev, [r.numpy() for r in rows]


def _jax_device_rows(dec, arrays, options):
    consts, fn = dec.device_kernel(options)
    return [np.asarray(r) for r in jax.jit(fn)(
        consts, [jnp.asarray(a) for a in arrays])]


# -- the toy tensors of tests/test_fused_decoders.py ---------------------------
def _ssd_tensors():
    A = anchor_grid(300).shape[0]  # the JAX grid's (test_torch_detection_models)
    rng = np.random.default_rng(3)
    box_enc = rng.normal(0, 0.5, (A, 4)).astype(np.float32)
    logits = np.full((A, 5), -6.0, np.float32)
    for a, c in ((10, 1), (500, 2), (1200, 3), (11, 1)):
        logits[a, c] = 4.0
    return [box_enc, logits]


def _postproc_tensors():
    return [np.asarray([[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9],
                        [0.2, 0.2, 0.3, 0.3]], np.float32),
            np.asarray([0.9, 0.2, 0.7], np.float32),
            np.asarray([1, 2, 3], np.float32)]


def _zero_score_tensors():
    return [np.asarray([[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9]],
                       np.float32),
            np.asarray([0.0, 0.6], np.float32),
            np.asarray([1, 2], np.float32)]


def _yolo_tensors():
    rng = np.random.default_rng(5)
    pred = np.full((40, 9), -6.0, np.float32)  # 4 box + obj + 4 classes
    pred[:, :4] = rng.uniform(0.2, 0.8, (40, 4)).astype(np.float32)
    for a, c in ((3, 0), (17, 2), (30, 3)):
        pred[a, 4] = 5.0
        pred[a, 5 + c] = 5.0
    return [pred]


def _pose_tensors():
    rng = np.random.default_rng(9)
    H = W = 9
    K = 5
    heat = rng.uniform(0, 0.2, (H, W, K)).astype(np.float32)
    for k in range(K):
        heat[1 + k, 2 + k, k] = 0.9
    offs = rng.uniform(-0.4, 0.4, (H, W, 2 * K)).astype(np.float32)
    return [heat, offs]


def _seg_tensors():
    rng = np.random.default_rng(11)
    return [rng.normal(0, 1, (1, 12, 10, 6)).astype(np.float32)]


def _dense_ssd_tensors(image=64, classes=6):
    """More strong boxes than the device caps hold, with tied scores:
    every anchor scores the same in classes 1-4, so the greedy NMS keeps
    the 32 lowest-index survivors a class and the top 100 of 128 tied
    rows is decided by index alone."""
    A = anchor_grid(image).shape[0]
    box_enc = np.zeros((A, 4), np.float32)
    logits = np.full((A, classes), -6.0, np.float32)
    logits[:, 1:5] = 3.0
    return [box_enc, logits], f"option4={image}:{image}"


BOX_CASES = {
    # anchors 10 and 11 overlap in class 1: NMS keeps one
    "ssd": (_ssd_tensors, "option1=mobilenet-ssd option3=0.5 option7=meta",
            3),
    "postprocess": (_postproc_tensors, "option1=mobilenet-ssd-postprocess "
                    "option3=0.5 option7=meta", 2),
    "zero_score": (_zero_score_tensors, "option1=mobilenet-ssd-postprocess "
                   "option3=0 option7=meta", 2),
    "yolov5": (_yolo_tensors, "option1=yolov5 option3=0.5 option7=meta", 3),
}


@pytest.mark.parametrize("case", sorted(BOX_CASES))
def test_box_decoder_halves_match_jax(case):
    make, text, n = BOX_CASES[case]
    arrays, options = make(), _opts(text)
    ref = JaxBoxes().decode(JaxBuffer(list(arrays)), None, options)
    host, dev, rows = _halves(BoundingBoxes(), arrays, options)
    assert len(ref.meta["detections"]) == n
    # the postprocess modes keep anchor order on both paths
    ordered = case in ("postprocess", "zero_score")
    _assert_dets_equal(host.meta["detections"], ref.meta["detections"],
                       ordered)
    _assert_dets_equal(dev.meta["detections"], ref.meta["detections"],
                       ordered)
    np.testing.assert_allclose(np.asarray(host[0]), np.asarray(ref[0]),
                               atol=FLOAT_TOL)
    # the padded device rows, row for row, against the JAX device half
    (jrows,) = _jax_device_rows(JaxBoxes(), arrays, options)
    (prow,) = rows
    assert prow.shape == jrows.shape
    np.testing.assert_array_equal(prow[:, 4], jrows[:, 4])
    np.testing.assert_allclose(prow, jrows, atol=FLOAT_TOL)


def test_box_overlay_with_labels_matches_jax(tmp_path):
    """option2 names a labels file: each detection gets its label, drawn
    by ``overlay.draw_text`` into the RGBA overlay."""
    labels = tmp_path / "labels.txt"
    labels.write_text("".join(f"obj{i}\n" for i in range(5)))
    arrays = _ssd_tensors()
    options = _opts(f"option1=mobilenet-ssd option2={labels}")
    ref = JaxBoxes().decode(JaxBuffer(list(arrays)), None, options)
    host, dev, _ = _halves(BoundingBoxes(), arrays, options)
    assert all(d["label"].startswith("obj") for d in ref.meta["detections"])
    for out in (host, dev):
        _assert_dets_equal(out.meta["detections"], ref.meta["detections"])
        assert np.asarray(out[0]).shape == (300, 300, 4)
        np.testing.assert_array_equal(np.asarray(out[0]), np.asarray(ref[0]))


def test_dense_scene_saturates_caps_in_jax_tie_order():
    arrays, size = _dense_ssd_tensors()
    options = _opts(f"option1=mobilenet-ssd option3=0.5 option7=meta {size}")
    ref = JaxBoxes().decode(JaxBuffer(list(arrays)), None, options)
    host, dev, (prow,) = _halves(BoundingBoxes(), arrays, options)
    # the host path is unbounded, the device path keeps 32 a class and 100
    per_class = {c: sum(d["class"] == c for d in ref.meta["detections"])
                 for c in range(1, 5)}
    assert min(per_class.values()) > DEVICE_K_PER_CLASS
    _assert_dets_equal(host.meta["detections"], ref.meta["detections"])
    assert len(dev.meta["detections"]) == DEVICE_K_TOTAL
    (jrows,) = _jax_device_rows(JaxBoxes(), arrays, options)
    np.testing.assert_array_equal(prow[:, 4], jrows[:, 4])
    np.testing.assert_allclose(prow, jrows, atol=FLOAT_TOL)
    assert (prow[:, 5] > PAD_SCORE / 2).all()


def test_padding_rows_match_jax_tie_order():
    """Fewer detections than rows: the padding rows (score PAD_SCORE, tied)
    come out in lax.top_k's order, lower index first, boxes and classes
    included."""
    arrays = _ssd_tensors()
    options = _opts("option1=mobilenet-ssd option3=0.5 option7=meta")
    _, _, (prow,) = _halves(BoundingBoxes(), arrays, options)
    (jrows,) = _jax_device_rows(JaxBoxes(), arrays, options)
    pad = prow[:, 5] == PAD_SCORE
    assert pad.sum() == DEVICE_K_TOTAL - 3
    np.testing.assert_array_equal(pad, jrows[:, 5] == PAD_SCORE)
    np.testing.assert_allclose(prow[pad], jrows[pad], atol=FLOAT_TOL)


def test_ov_person_detection_is_host_only_as_in_jax():
    rows = np.asarray([[0, 1, 0.95, 0.1, 0.2, 0.3, 0.4],
                       [0, 1, 0.5, 0.1, 0.2, 0.3, 0.4],
                       [0, 2, 0.85, 0.5, 0.5, 0.6, 0.7],
                       [-1, 0, 0.99, 0, 0, 1, 1],
                       [0, 3, 0.99, 0, 0, 1, 1]], np.float32)[None, None]
    for name in ("ov-person-detection", "ov-face-detection"):
        options = _opts(f"option1={name} option7=meta")
        ref = JaxBoxes().decode(JaxBuffer([rows]), None, options)
        dec = BoundingBoxes()
        out = dec.decode(TensorBuffer([rows]), None, options)
        assert len(ref.meta["detections"]) == 2
        _assert_dets_equal(out.meta["detections"], ref.meta["detections"],
                           ordered=True)
        assert dec.device_kernel(options) is None


@pytest.mark.parametrize("old,new,make", [
    ("tf-ssd", "mobilenet-ssd-postprocess", _postproc_tensors),
    ("tflite-ssd", "mobilenet-ssd", _ssd_tensors),
])
def test_mode_aliases_match_jax(old, new, make):
    arrays = make()
    got = BoundingBoxes().decode(TensorBuffer(list(arrays)), None,
                                 _opts(f"option1={old} option7=meta"))
    want = JaxBoxes().decode(JaxBuffer(list(arrays)), None,
                             _opts(f"option1={new} option7=meta"))
    assert [_det_key(d) for d in got.meta["detections"]] == \
        [_det_key(d) for d in want.meta["detections"]]


def _assert_kps_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["keypoint"] == b["keypoint"] and a["visible"] == b["visible"]
        np.testing.assert_allclose([a["y"], a["x"], a["score"]],
                                   [b["y"], b["x"], b["score"]],
                                   atol=FLOAT_TOL)


@pytest.mark.parametrize("text", ["option2=meta option3=0.3",
                                  "option1=64:64 option3=0.3"])
def test_pose_halves_match_jax(text):
    arrays, options = _pose_tensors(), _opts(text)
    ref = JaxPose().decode(JaxBuffer(list(arrays)), None, options)
    host, dev, _ = _halves(PoseEstimation(), arrays, options)
    for out in (host, dev):
        _assert_kps_equal(out.meta["keypoints"], ref.meta["keypoints"])
        if "option2" in options:
            np.testing.assert_allclose(np.asarray(out[0]), np.asarray(ref[0]),
                                       atol=FLOAT_TOL)
        else:  # the overlay
            np.testing.assert_array_equal(np.asarray(out[0]),
                                          np.asarray(ref[0]))


def test_batched_pose_decodes_every_frame_as_jax():
    B, H, W, K = 3, 8, 8, 2
    heat = np.zeros((B, H, W, K), np.float32)
    for b, (y, x) in enumerate([(1, 2), (4, 5), (6, 0)]):
        heat[b, y, x, :] = 5.0
    offs = np.random.default_rng(2).uniform(
        -0.4, 0.4, (B, H, W, 2 * K)).astype(np.float32)
    options = {"option2": "meta"}
    for arrays in ([heat], [heat, offs]):
        ref = JaxPose().decode(JaxBuffer(list(arrays)), None, options)
        host, dev, (rows,) = _halves(PoseEstimation(), arrays, options)
        assert rows.shape == (B, K, 3)
        for out in (host, dev):
            kps = out.meta["keypoints"]
            assert len(kps) == B
            for got, want in zip(kps, ref.meta["keypoints"]):
                _assert_kps_equal(got, want)
            np.testing.assert_allclose(np.asarray(out[0]), np.asarray(ref[0]),
                                       atol=FLOAT_TOL)
    with pytest.raises(ValueError, match="option2=meta"):
        PoseEstimation().decode(TensorBuffer([heat]), None, {})


def test_segment_halves_match_jax():
    arrays = _seg_tensors()
    ref = JaxSegment().decode(JaxBuffer(list(arrays)), None, {})
    host, dev, (labels,) = _halves(ImageSegment(), arrays, {})
    assert labels.dtype == np.int32 and labels.shape == (12, 10)
    for out in (host, dev):
        np.testing.assert_array_equal(out.meta["segment_labels"],
                                      ref.meta["segment_labels"])
        np.testing.assert_array_equal(np.asarray(out[0]), np.asarray(ref[0]))
        assert np.asarray(out[0]).shape == (12, 10, 4)


# -- the port's fused and unfused pipelines ------------------------------------
class _Const(torch.nn.Module):
    """A model whose outputs are fixed tensors (tests/test_fused_decoders.py
    registers ``fn(x) -> constants``)."""

    def __init__(self, arrays):
        super().__init__()
        for i, a in enumerate(arrays):
            self.register_buffer(f"out{i}", torch.from_numpy(a.copy()))
        self.n = len(arrays)

    def forward(self, x):
        outs = tuple(getattr(self, f"out{i}") + 0 * x.sum()
                     for i in range(self.n))
        return outs if self.n > 1 else outs[0]


@pytest.fixture
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


def _run_port(model, dec_opts, fuse, name):
    pipe = tnt.parse_launch(
        "appsrc name=src ! tensor_transform mode=typecast option=float32 ! "
        f"tensor_filter framework=jax model={model} ! "
        f"tensor_decoder mode={dec_opts} ! tensor_sink name=sink to-host=true",
        pipeline=Pipeline(fuse=fuse, name=name))
    src, sink = pipe.get("src"), pipe.get("sink")
    pipe.start()
    try:
        src.push([np.zeros((4,), np.uint8)])
        src.end_of_stream()
        msg = pipe.wait(timeout=60)
        assert msg is not None and msg.kind == "eos", msg
    finally:
        pipe.stop()
    if fuse:
        (region,) = pipe._regions
        assert [m.ELEMENT_NAME for m in region.members][-1] == \
            "tensor_decoder"
        assert not region._dead
    else:
        assert not pipe._regions
    return sink.buffers[0]


PIPE_CASES = {
    "ssd": (_ssd_tensors,
            "bounding_boxes option1=mobilenet-ssd option3=0.5 option7=meta"),
    "postprocess": (_postproc_tensors, "bounding_boxes "
                    "option1=mobilenet-ssd-postprocess option3=0.5 "
                    "option7=meta"),
    "zero_score": (_zero_score_tensors, "bounding_boxes "
                   "option1=mobilenet-ssd-postprocess option3=0 "
                   "option7=meta"),
    "yolov5": (_yolo_tensors,
               "bounding_boxes option1=yolov5 option3=0.5 option7=meta"),
    "pose": (_pose_tensors, "pose_estimation option2=meta option3=0.3"),
    "pose_overlay": (_pose_tensors, "pose_estimation option1=64:64 "
                     "option3=0.3"),
    "segment": (_seg_tensors, "image_segment"),
}


@pytest.mark.parametrize("case", sorted(PIPE_CASES))
def test_port_fused_pipeline_matches_unfused(cpu_device, case):
    make, dec_opts = PIPE_CASES[case]
    name = f"dec_toy_{case}"
    register_torch_model(name, _Const(make()))
    try:
        f = _run_port(name, dec_opts, True, f"{name}_f")
        u = _run_port(name, dec_opts, False, f"{name}_u")
    finally:
        unregister_torch_model(name)
    for key in ("detections", "keypoints", "segment_labels"):
        if key in u.meta:
            if key == "segment_labels":
                np.testing.assert_array_equal(f.meta[key], u.meta[key])
            else:
                assert f.meta[key] == u.meta[key]
    assert np.asarray(f[0]).tobytes() == np.asarray(u[0]).tobytes()


# -- on the card ---------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device halves run on the card")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ssd", "yolov5", "postprocess", "dense"])
def test_device_nms_on_the_card_matches_the_cpu(case):
    dev = _card()
    if case == "dense":
        arrays, size = _dense_ssd_tensors()
        options = _opts(f"option1=mobilenet-ssd option3=0.5 option7=meta "
                        f"{size}")
    else:
        make, text, _ = BOX_CASES[case]
        arrays, options = make(), _opts(text)
    dec = BoundingBoxes()
    consts, fn = dec.device_kernel(options)
    (cpu,) = fn(consts, [torch.from_numpy(a.copy()) for a in arrays])
    (card,) = fn(consts, [torch.from_numpy(a.copy()).to(dev) for a in arrays])
    card = card.cpu()
    assert torch.equal(cpu[:, 4], card[:, 4])
    torch.testing.assert_close(card, cpu, atol=FLOAT_TOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(PIPE_CASES))
def test_fused_decoder_on_the_card_matches_unfused(case):
    _card()
    tnt.set_device(None)
    make, dec_opts = PIPE_CASES[case]
    name = f"dec_gpu_{case}"
    register_torch_model(name, _Const(make()))
    try:
        f = _run_port(name, dec_opts, True, f"{name}_f")
        u = _run_port(name, dec_opts, False, f"{name}_u")
    finally:
        unregister_torch_model(name)
    assert np.asarray(f[0]).tobytes() == np.asarray(u[0]).tobytes()
    arrays = make()
    host = {"bounding_boxes": BoundingBoxes, "pose_estimation": PoseEstimation,
            "image_segment": ImageSegment}[dec_opts.split()[0]]().decode(
        TensorBuffer([a.copy() for a in arrays]), None,
        _opts(" ".join(dec_opts.split()[1:])))
    if "detections" in host.meta:
        _assert_dets_equal(f.meta["detections"], host.meta["detections"])
    if "keypoints" in host.meta:
        _assert_kps_equal(f.meta["keypoints"], host.meta["keypoints"])
    if "segment_labels" in host.meta:
        np.testing.assert_array_equal(f.meta["segment_labels"],
                                      host.meta["segment_labels"])
