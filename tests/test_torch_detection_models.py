"""The detection, pose, segmentation and recurrent models of the PyTorch
port, on weights converted from the JAX package's flax models
(``params_from_jax``), held to the flax models; and bench.py's ``ssd`` and
``pose4`` launch strings at small sizes through both packages.

Everything runs in float32 on the CPU. Convolutions sum in another order
in the two frameworks, so outputs agree to rtol 1e-4 and atol 1e-4 ×
max|out|, as ``tests/test_torch_mobilenet_v2.py`` holds MobileNetV2; the
LSTM cell, a single dense layer, agrees to atol 1e-6 over 20 recurrent
steps. Per-frame detections and keypoints of the launch strings agree as
sets, their floats within 1e-5.
"""

import importlib

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
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.models.mobilenet_v2 import same_pads
from nnstreamer_tpu_torch.models.segmenter import upsample2


def _pair(name):
    return (importlib.import_module(f"nnstreamer_tpu.models.{name}"),
            importlib.import_module(f"nnstreamer_tpu_torch.models.{name}"))


J_SSD, T_SSD = _pair("ssd_mobilenet")
J_YOLO, T_YOLO = _pair("yolo")
J_POSE, T_POSE = _pair("posenet")
J_SEG, T_SEG = _pair("segmenter")
J_LSTM, T_LSTM = _pair("lstm")


def _np_vars(variables):
    return jax.tree.map(np.asarray, variables)


def _assert_close(out, ref):
    assert out.shape == ref.shape and out.dtype == np.float32
    atol = 1e-4 * float(np.abs(ref).max())
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=atol)


def _port_ssd(variables, classes):
    module = T_SSD.SSDMobileNet(num_classes=classes)
    module.load_state_dict(T_SSD.params_from_jax(_np_vars(variables)),
                           strict=True)
    return module.eval()


def _port_yolo(variables, classes):
    module = T_YOLO.YoloDetector(num_classes=classes)
    module.load_state_dict(T_YOLO.params_from_jax(_np_vars(variables)),
                           strict=True)
    return module.eval()


def _port_pose(variables):
    module = T_POSE.PoseNet()
    module.load_state_dict(T_POSE.params_from_jax(_np_vars(variables)),
                           strict=True)
    return module.eval()


def _port_seg(variables, base):
    module = T_SEG.Segmenter(base=base)
    module.load_state_dict(T_SEG.params_from_jax(_np_vars(variables)),
                           strict=True)
    return module.eval()


# (JAX factory and keywords, port module from the variables, image size)
MODELS = {
    "ssd": (lambda: J_SSD.ssd_mobilenet(num_classes=5, image_size=64,
                                        dtype=jnp.float32, seed=3),
            lambda v: _port_ssd(v, 5), 64),
    "yolo": (lambda: J_YOLO.yolo_detector(num_classes=4, image_size=64,
                                          dtype=jnp.float32, seed=3),
             lambda v: _port_yolo(v, 4), 64),
    "posenet": (lambda: J_POSE.posenet(image_size=65, dtype=jnp.float32,
                                       seed=3),
                _port_pose, 65),
    "segmenter": (lambda: J_SEG.segmenter(image_size=32, base=8,
                                          dtype=jnp.float32, seed=3),
                  lambda v: _port_seg(v, 8), 32),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_flax(name):
    make_jax, make_port, size = MODELS[name]
    apply_fn, variables, _, out_info = make_jax()
    module = make_port(variables)
    x = np.random.default_rng(size).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    ref = apply_fn(variables, jnp.asarray(x))
    ref = ref if isinstance(ref, tuple) else (ref,)
    with torch.inference_mode():
        out = module(torch.from_numpy(x))
    out = out if isinstance(out, tuple) else (out,)
    assert len(out) == len(ref) == len(out_info)
    for o, r in zip(out, ref):
        _assert_close(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("name,factory,kw", [
    ("ssd", T_SSD.ssd_mobilenet, dict(num_classes=5, image_size=64)),
    ("yolo", T_YOLO.yolo_detector, dict(num_classes=4, image_size=64)),
    ("posenet", T_POSE.posenet, dict(image_size=65)),
    ("segmenter", T_SEG.segmenter, dict(image_size=32, base=8)),
])
def test_factory_infos_match_jax(name, factory, kw):
    """The port's factories declare the JAX factories' tensor infos, and
    their seeded weights are the same from call to call (bf16 = the fp32
    weights rounded)."""
    _, _, j_in, j_out = MODELS[name][0]()
    module, t_in, t_out = factory(dtype=torch.float32, seed=5, **kw)
    assert [i.dim for i in t_in] == [i.dim for i in j_in]
    assert [i.dim for i in t_out] == [i.dim for i in j_out]
    again, _, _ = factory(dtype=torch.bfloat16, seed=5, **kw)
    for a, b in zip(module.state_dict().values(),
                    again.state_dict().values()):
        if a.is_floating_point():
            assert torch.equal(a.to(torch.bfloat16), b)


def test_segmenter_rejects_sizes_not_divisible_by_8():
    with pytest.raises(ValueError, match="divisible by 8"):
        T_SEG.segmenter(image_size=30)


def test_upsampling_picks_jax_nearest_pixel():
    """``jax.image.resize(..., "nearest")`` by exactly 2 reads input pixel
    ``i // 2``; ``upsample2`` picks the same one."""
    x = np.random.default_rng(1).standard_normal((1, 5, 7, 3)).astype(
        np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, 10, 14, 3),
                                      "nearest"))
    np.testing.assert_array_equal(ref, x[:, np.arange(10) // 2][
        :, :, np.arange(14) // 2])
    got = upsample2(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


@pytest.mark.parametrize("size,pads", [(300, (0, 1)), (320, (0, 1)),
                                       (257, (1, 1)), (129, (1, 1))])
def test_stride2_same_pads_of_the_slice_inputs(size, pads):
    assert same_pads(size, 3, 2) == pads


def test_lstm_cell_matches_flax_over_20_steps():
    apply_fn, variables, _, _ = J_LSTM.lstm_cell(input_dim=6, hidden=8,
                                                 batch=2, seed=3)
    module = T_LSTM.LSTMCellModel(input_dim=6, hidden=8)
    module.load_state_dict(T_LSTM.params_from_jax(_np_vars(variables)),
                           strict=True)
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((20, 2, 6)).astype(np.float32)
    h = c = np.zeros((2, 8), np.float32)
    th, tc = torch.from_numpy(h), torch.from_numpy(c)
    for x in xs:
        y, h, c = apply_fn(variables, jnp.asarray(x), h, c)
        with torch.inference_mode():
            ty, th, tc = module(torch.from_numpy(x), th, tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(y), atol=1e-6)
        np.testing.assert_allclose(th.numpy(), np.asarray(h), atol=1e-6)
        np.testing.assert_allclose(tc.numpy(), np.asarray(c), atol=1e-6)


def test_lstm_gate_order_and_forget_bias():
    """Gates split ``i, f, g, o`` and the forget gate gets +1.0: with zero
    weights and bias and a saturated output gate, c' = sigmoid(1)·c and
    h' = tanh(c')."""
    module, _, _ = T_LSTM.lstm_cell(input_dim=3, hidden=4)
    with torch.no_grad():
        module.dense.weight.zero_()
        module.dense.bias.zero_()
        module.dense.bias[12:].fill_(100.0)  # o saturates: h' = tanh(c')
    c = torch.full((1, 4), 2.0)
    y, h, c2 = module(torch.zeros(1, 3), torch.zeros(1, 4), c)
    torch.testing.assert_close(c2, torch.sigmoid(torch.tensor(1.0)) * c)
    torch.testing.assert_close(h, torch.tanh(c2))
    assert torch.equal(y, h)


@pytest.mark.parametrize("size", [300, 64, 65])
def test_anchor_grid_equals_jax(size):
    got = T_SSD.anchor_grid(size)
    want = J_SSD.anchor_grid(size)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_ssd_anchor_order_is_the_jax_package_pairing():
    """ROADMAP.md queue C: the model flattens its heads cell-major with the
    anchor innermost (row ``(h·W + w)·k + a``) while ``anchor_grid`` lists
    anchor-major with the cell innermost (row ``a·cells² + cell``); the
    decoder pairs row r of one with row r of the other. The port does what
    the JAX package does: this pins both orders."""
    k, size = 6, 64
    apply_fn, variables, _, _ = J_SSD.ssd_mobilenet(
        num_classes=3, image_size=size, dtype=jnp.float32, seed=0)
    v = _np_vars(variables)
    # box heads emit their bias only: row r's values name its anchor slot
    for name in ("Conv_1", "Conv_3"):
        v["params"][name]["kernel"] = np.zeros_like(
            v["params"][name]["kernel"])
        v["params"][name]["bias"] = np.repeat(
            np.arange(k, dtype=np.float32), 4)
    x = np.zeros((1, size, size, 3), np.float32)
    jboxes, _ = apply_fn(v, jnp.asarray(x))
    module = _port_ssd(v, 3)
    with torch.inference_mode():
        tboxes, _ = module(torch.from_numpy(x))
    cells0 = (-(-size // 16)) ** 2  # stride-16 cells
    rows = np.arange(jboxes.shape[1])
    model_anchor = np.where(rows < cells0 * k, rows % k,
                            (rows - cells0 * k) % k)
    for boxes in (np.asarray(jboxes), tboxes.numpy()):
        np.testing.assert_array_equal(boxes[0, :, 0], model_anchor)
    grid = T_SSD.anchor_grid(size)
    grid_anchor = np.where(rows < cells0 * k, rows // cells0,
                           (rows - cells0 * k) // (cells0 // 4))
    # the grid's anchor slot of each row is anchor-major: rows 0..cells-1
    # are all anchor 0 (one height), where the model's cycle through 0..5
    assert len(set(grid[:cells0, 2])) == 1
    assert (grid_anchor[:cells0] == 0).all()
    assert not np.array_equal(grid_anchor, model_anchor)


# -- bench.py's ssd and pose4 strings, small, through both packages ------------
def _run(pkg, desc):
    pipe = pkg.parse_launch(desc)
    bufs = []
    pipe.get("sink").connect(bufs.append)
    msg = pipe.run(timeout=300)
    assert msg is not None and msg.kind == "eos", msg
    return bufs


def _ssd_desc(model, n, size):
    # bench.py's string (measure_ssd) at a small size, with the frame-
    # dependent ball pattern so frames differ
    return (f"videotestsrc num-buffers={n} width={size} height={size} "
            "pattern=ball ! tensor_converter ! queue max-size-buffers=8 ! "
            "tensor_transform mode=arithmetic "
            "option=typecast:float32,add:-127.5,div:127.5 ! "
            f"tensor_filter framework=jax model={model} name=filter ! "
            "tensor_decoder mode=bounding_boxes option1=mobilenet-ssd "
            f"option4={size}:{size} option7=meta ! "
            "queue max-size-buffers=64 materialize-host=true ! "
            "tensor_sink name=sink to-host=true")


@pytest.fixture
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


def test_bench_ssd_string_matches_jax(cpu_device):
    size, n, classes = 64, 4, 5
    apply_fn, variables, in_info, out_info = J_SSD.ssd_mobilenet(
        num_classes=classes, image_size=size, dtype=jnp.float32, seed=3)
    register_jax_model("ssd_slice", apply_fn, variables, in_info=in_info,
                       out_info=out_info)
    module, t_in, t_out = T_SSD.ssd_mobilenet(
        num_classes=classes, image_size=size, dtype=torch.float32)
    module.load_state_dict(T_SSD.params_from_jax(_np_vars(variables)))
    register_torch_model("ssd_slice", module, t_in, t_out)
    try:
        want = _run(jnt, _ssd_desc("ssd_slice", n, size))
        got = _run(tnt, _ssd_desc("ssd_slice", n, size))
    finally:
        unregister_jax_model("ssd_slice")
        unregister_torch_model("ssd_slice")
    assert len(got) == len(want) == n
    assert sum(len(b.meta["detections"]) for b in want) > 0
    for g, w in zip(got, want):
        dg = sorted(g.meta["detections"], key=lambda d: (d["class"], d["box"]))
        dw = sorted(w.meta["detections"], key=lambda d: (d["class"], d["box"]))
        assert [d["class"] for d in dg] == [d["class"] for d in dw]
        for a, b in zip(dg, dw):
            np.testing.assert_allclose(a["score"], b["score"], atol=1e-5)
            np.testing.assert_allclose(a["box"], b["box"], atol=1e-5)
        assert np.asarray(g[0]).shape[1] == 6


class Batched4(torch.nn.Module):
    """bench.py's ``batched4``: four uint8 frames concatenated along the
    batch, normalized, through PoseNet."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, a, b, c, d):
        x = torch.cat([a, b, c, d], dim=0).float()
        return self.net((x - 127.5) / 127.5)


def _pose4_desc(model, n, size):
    srcs = " ".join(
        f"videotestsrc num-buffers={n} width={size} height={size} "
        f"pattern={p} ! tensor_converter ! mux. "
        for p in ("ball", "gradient", "smpte", "ball"))
    return ("tensor_mux name=mux sync-mode=slowest ! "
            f"tensor_filter framework=jax model={model} name=filter ! "
            "tensor_decoder mode=pose_estimation option2=meta ! "
            "queue max-size-buffers=64 materialize-host=true ! "
            "tensor_sink name=sink to-host=true " + srcs)


def test_bench_pose4_string_matches_jax(cpu_device):
    size, n = 65, 3
    apply_fn, variables, _, _ = J_POSE.posenet(image_size=size, batch=4,
                                               dtype=jnp.float32, seed=3)

    def batched4(p, a, b, c, d):
        x = jnp.concatenate([a, b, c, d], axis=0).astype(jnp.float32)
        return apply_fn(p, (x - 127.5) / 127.5)

    register_jax_model("pose4_slice", batched4, variables)
    register_torch_model("pose4_slice", Batched4(_port_pose(variables)))
    try:
        want = _run(jnt, _pose4_desc("pose4_slice", n, size))
        got = _run(tnt, _pose4_desc("pose4_slice", n, size))
    finally:
        unregister_jax_model("pose4_slice")
        unregister_torch_model("pose4_slice")
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert np.asarray(g[0]).shape == (4, 17, 3)
        np.testing.assert_allclose(np.asarray(g[0]), np.asarray(w[0]),
                                   atol=1e-5)
        for fg, fw in zip(g.meta["keypoints"], w.meta["keypoints"]):
            assert [k["visible"] for k in fg] == [k["visible"] for k in fw]
