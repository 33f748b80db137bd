"""Each plain reference against the port's module at a small size on
seeded float32 weights (the CPU): the same logits, boxes and NMS rows."""

from __future__ import annotations

import torch

from h100bench import weights
from h100bench.conftest import PAIRS, tiny_cell

SEED = 2 ** 31 + 77


def _setup(cell_name, frames=6):
    cell = tiny_cell(*PAIRS[cell_name])
    cfg, prog, ref = cell.config.data, cell.config.program, \
        cell.config.reference
    w = weights.make(ref.specs(cfg), SEED, "cpu", torch.float32)
    x = weights.frames(SEED, frames, cfg["image_size"], cfg["image_size"],
                       cfg["channels"], "cpu")
    return cfg, prog, ref, w, x


def _port_input(cfg, x):
    pre = cfg["preprocess"]
    return (x.to(torch.float32) + pre["add"]) / pre["div"]


def test_mobilenet_v2_reference_is_the_ports_module():
    cfg, prog, ref, w, x = _setup("mnv2.b8_saturated")
    with torch.no_grad():
        port = prog.module(cfg, w, "cpu")(_port_input(cfg, x))
    want = ref.logits(cfg, w, x)
    assert port.shape == want.shape == (6, cfg["num_classes"])
    torch.testing.assert_close(port, want, rtol=1e-4, atol=1e-5)


def test_mobilenet_v2_specs_cover_every_parameter_of_the_port():
    cfg, prog, ref, w, _ = _setup("mnv2.b8_saturated")
    names = set(prog.module(cfg, w, "cpu").state_dict())
    assert names == {n for n, _, _ in ref.specs(cfg)}


def test_ssd_reference_is_the_ports_module_and_decoder():
    from nnstreamer_tpu_torch.decoders.bounding_boxes import BoundingBoxes

    cfg, prog, ref, w, x = _setup("ssd.b1_saturated")
    module = prog.module(cfg, w, "cpu")
    assert set(module.state_dict()) == {n for n, _, _ in ref.specs(cfg)}
    with torch.no_grad():
        enc, logits = module(_port_input(cfg, x))
    want_enc, want_logits = ref.forward(cfg, w, x)
    torch.testing.assert_close(enc, want_enc, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(logits, want_logits, rtol=1e-4, atol=1e-5)
    size = cfg["image_size"]
    options = {"option1": "mobilenet-ssd",
               "option3": str(cfg["score_threshold"]),
               "option4": f"{size}:{size}",
               "option5": str(cfg["iou_threshold"]), "option7": "meta"}
    consts, fn = BoundingBoxes().device_kernel(options)
    boxes, probs = ref.decode(cfg, want_enc, want_logits)
    rows = ref.nms(cfg, boxes, probs)
    for i in range(x.shape[0]):
        got = fn(consts, [enc[i:i + 1], logits[i:i + 1]])[0]
        got = got[got[:, 5] > -0.5]
        assert got.shape == rows[i].shape
        torch.testing.assert_close(got, rows[i], rtol=1e-5, atol=1e-6)
    # the judge reads the port's own rows as the reference's
    served = {"index": torch.arange(x.shape[0]), "rows": rows}
    got = ref.gaps(cfg, boxes, probs, served)
    assert got["box_gap"] == got["score_gap"] == got["top_gap"] == 0.0
    assert got["nms_iou"] <= cfg["iou_threshold"]


def test_the_weights_and_frames_follow_the_seed():
    cfg, _, ref, w, x = _setup("mnv2.b8_saturated")
    w2 = weights.make(ref.specs(cfg), SEED, "cpu", torch.float32)
    assert all(torch.equal(w[k], w2[k]) for k in w)
    w3 = weights.make(ref.specs(cfg), SEED + 1, "cpu", torch.float32)
    assert not torch.equal(w["stem.weight"], w3["stem.weight"])
    x2 = weights.frames(SEED, 6, cfg["image_size"], cfg["image_size"], 3,
                        "cpu")
    assert torch.equal(x, x2)
