"""The port's ``tensor_src_iio`` (``elements/source.py``: ``IIOChannel``,
the sysfs probe, the scan demux and mock mode) against the JAX package's,
on the mock sysfs trees of ``tests/test_iio.py`` (the reference's
dummy-device pattern, unittest_src_iio.cc). Each capture runs through both
packages on a fresh copy of the same tree: the tensors, timestamps and the
sysfs writes must be equal; each malformed tree fails at ``start()`` in
both.
"""

import os
import shutil
import struct

import numpy as np
import pytest

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.elements.source import IIOChannel as JaxIIOChannel
from nnstreamer_tpu_torch.elements.source import IIOChannel

def _mock_tree(tmp_path, scans, payload=None):
    """Build iio:device0 with two channels: accel_x le:s16/16>>0 scale=0.01
    and accel_y le:s16/16>>0 scale=0.02; device node holds packed scans
    (``payload`` overrides — the kernel packs only *enabled* channels)."""
    base = tmp_path / "sys"
    dev = base / "iio:device0"
    scan = dev / "scan_elements"
    os.makedirs(scan)
    os.makedirs(dev / "buffer")
    (dev / "name").write_text("mock_accel\n")
    (dev / "sampling_frequency").write_text("100\n")
    (dev / "buffer" / "length").write_text("1\n")
    (dev / "buffer" / "enable").write_text("0\n")
    for i, ch in enumerate(("accel_x", "accel_y")):
        (scan / f"in_{ch}_en").write_text("0\n")
        (scan / f"in_{ch}_index").write_text(f"{i}\n")
        (scan / f"in_{ch}_type").write_text("le:s16/16>>0\n")
    (dev / "in_accel_x_scale").write_text("0.01\n")
    (dev / "in_accel_y_scale").write_text("0.02\n")
    node_dir = tmp_path / "dev"
    os.makedirs(node_dir)
    if payload is None:
        payload = b"".join(struct.pack("<hh", x, y) for x, y in scans)
    (node_dir / "iio:device0").write_bytes(payload)
    return str(base), str(node_dir)


def _sysfs_state(base):
    """Every file under the tree and its text (the probe's writes)."""
    state = {}
    for root, _, names in os.walk(base):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                state[os.path.relpath(p, base)] = f.read()
    return state


def _capture_both(tmp_path, make_tree, desc):
    """``make_tree(dir) -> (base, dev)``; ``desc`` takes ``{base}`` and
    ``{dev}``. Runs both packages on their own copy of the tree; returns
    the port's buffers after holding them to the JAX package's."""
    results = {}
    for tag, pkg in (("jax", jnt), ("port", tnt)):
        d = tmp_path / tag
        d.mkdir()
        base, dev = make_tree(d)
        pipe = pkg.parse_launch(desc.format(base=base, dev=dev))
        out = []
        pipe.get("out").connect(lambda b, out=out: out.append(b))
        msg = pipe.run(timeout=30)
        assert msg is not None, tag  # completed, no hang
        results[tag] = (out, _sysfs_state(base))
    (got, got_fs), (want, want_fs) = results["port"], results["jax"]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        x, y = np.asarray(a.tensors[0]), np.asarray(b.tensors[0])
        assert x.dtype == y.dtype == np.float32 and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
        assert a.pts == b.pts
    assert got_fs == want_fs
    return got


@pytest.mark.parametrize("fmt,word,want", [
    ("le:s12/16>>4", struct.pack("<H", ((-3) & 0xFFF) << 4), (-3 + 1.0) * 0.5),
    ("be:u10/16>>0", struct.pack(">H", 1023), (1023 + 1.0) * 0.5),
    ("le:s64/64>>0", struct.pack("<q", -(10 ** 12)), (-(10 ** 12) + 1.0) * 0.5),
    ("le:u8/8>>0", struct.pack("<B", 200), (200 + 1.0) * 0.5),
    ("be:s20/32>>6", struct.pack(">I", ((-7) & 0xFFFFF) << 6),
     (-7 + 1.0) * 0.5),
])
def test_channel_extract_matches_jax(fmt, word, want):
    ch = IIOChannel("c", 0, fmt, scale=0.5, offset=1.0)
    ref = JaxIIOChannel("c", 0, fmt, scale=0.5, offset=1.0)
    raw = np.frombuffer(word, np.uint8)
    out = ch.extract(raw)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, ref.extract(raw))
    np.testing.assert_allclose(out, [want], rtol=1e-6)
    assert (ch.bits, ch.shift, ch.storage_bytes, ch.signed) == \
        (ref.bits, ref.shift, ref.storage_bytes, ref.signed)


@pytest.mark.parametrize("fmt", ["not-a-descriptor", "le:s12/12>>4",
                                 "le:x8/8>>0", "le:s8/24>>0"])
def test_malformed_descriptor_raises_as_jax(fmt):
    for cls in (IIOChannel, JaxIIOChannel):
        with pytest.raises(ValueError, match="iio"):
            cls("c", 0, fmt)


def test_iio_device_capture_matches_jax(tmp_path):
    scans = [(100, -200), (300, -400), (500, -600), (700, -800)]
    got = _capture_both(
        tmp_path, lambda d: _mock_tree(d, scans),
        "tensor_src_iio name=src mode=device device-number=0 "
        "base-dir={base} dev-dir={dev} buffer-capacity=2 num-buffers=2 ! "
        "tensor_sink name=out")
    assert len(got) == 2
    t0 = got[0].tensors[0]
    assert t0.shape == (2, 2)  # [capacity, channels]
    np.testing.assert_allclose(t0[:, 0], [1.0, 3.0])        # x * 0.01
    np.testing.assert_allclose(t0[:, 1], [-4.0, -8.0])      # y * 0.02
    base = tmp_path / "port" / "sys" / "iio:device0"
    assert (base / "scan_elements" / "in_accel_x_en").read_text() == "1"
    assert (base / "buffer" / "length").read_text() == "2"


def test_iio_device_by_name_and_channel_select_matches_jax(tmp_path):
    got = _capture_both(
        tmp_path, lambda d: _mock_tree(
            d, [], payload=struct.pack("<hhh", 20, 20, 20)),
        "tensor_src_iio name=src mode=device device=mock_accel "
        "base-dir={base} dev-dir={dev} channels=accel_y "
        "buffer-capacity=1 num-buffers=3 ! tensor_sink name=out")
    assert len(got) == 3
    np.testing.assert_allclose(got[0].tensors[0], [[0.4]])


def _mixed_tree(d):
    base = d / "sys"
    dev = base / "iio:device0"
    scan = dev / "scan_elements"
    os.makedirs(scan)
    os.makedirs(dev / "buffer")
    (dev / "name").write_text("mixed\n")
    for i, (ch, fmt) in enumerate((("accel_x", "le:s16/16>>0"),
                                   ("accel_y", "le:s16/16>>0"),
                                   ("timestamp", "le:s64/64>>0"))):
        (scan / f"in_{ch}_en").write_text("0\n")
        (scan / f"in_{ch}_index").write_text(f"{i}\n")
        (scan / f"in_{ch}_type").write_text(f"{fmt}\n")
    node_dir = d / "dev"
    os.makedirs(node_dir)
    payload = b"".join(struct.pack("<hh4xq", 10 * i, -10 * i, 10 ** 12 + i)
                       for i in range(3))
    (node_dir / "iio:device0").write_bytes(payload)
    return str(base), str(node_dir)


def test_iio_kernel_scan_alignment_matches_jax(tmp_path):
    got = _capture_both(
        tmp_path, _mixed_tree,
        "tensor_src_iio mode=device device-number=0 base-dir={base} "
        "dev-dir={dev} buffer-capacity=3 num-buffers=1 ! "
        "tensor_sink name=out")
    t = got[0].tensors[0]
    assert t.shape == (3, 3)
    np.testing.assert_allclose(t[:, 2], [1e12, 1e12 + 1, 1e12 + 2])


def test_iio_numeric_channel_count_matches_jax(tmp_path):
    got = _capture_both(
        tmp_path, lambda d: _mock_tree(d, [],
                                       payload=struct.pack("<hh", 5, 7)),
        "tensor_src_iio mode=device device-number=0 base-dir={base} "
        "dev-dir={dev} channels=1 buffer-capacity=1 num-buffers=1 ! "
        "tensor_sink name=out")
    np.testing.assert_allclose(got[0].tensors[0], [[0.05]])


def test_iio_truncated_device_node_matches_jax(tmp_path):
    full = (struct.pack("<hh", 100, -200) + struct.pack("<hh", 300, -400))
    got = _capture_both(
        tmp_path, lambda d: _mock_tree(d, [], payload=full + full[:3]),
        "tensor_src_iio mode=device device-number=0 base-dir={base} "
        "dev-dir={dev} buffer-capacity=2 num-buffers=2 ! "
        "tensor_sink name=out")
    assert len(got) == 1  # the fragment never became a tensor


@pytest.mark.parametrize("channels,cap", [(3, 4), (1, 2)])
def test_iio_mock_mode_matches_jax(tmp_path, channels, cap):
    got = _capture_both(
        tmp_path, lambda d: (str(d), str(d)),
        f"tensor_src_iio mode=mock channels={channels} "
        f"buffer-capacity={cap} num-buffers=2 ! tensor_sink name=out")
    assert got[0].tensors[0].shape == (cap, channels)


def test_iio_caps_match_jax(tmp_path):
    desc = ("tensor_src_iio mode=mock channels=2 buffer-capacity=5 "
            "frequency=50 num-buffers=1 ! tensor_sink name=out")
    caps = []
    for pkg in (jnt, tnt):
        pipe = pkg.parse_launch(desc)
        assert pipe.run(timeout=30).kind == "eos"
        caps.append(str(pipe.get("out").sinkpad.caps))
    assert caps[0] == caps[1]


def test_iio_reorder_safe_only_in_mock_mode():
    from nnstreamer_tpu_torch.elements.source import TensorSrcIIO

    assert TensorSrcIIO(mode="mock").reorder_safe()
    assert not TensorSrcIIO(mode="device").reorder_safe()


def _break_type(base):
    scan = os.path.join(base, "iio:device0", "scan_elements")
    with open(os.path.join(scan, "in_accel_x_type"), "w") as f:
        f.write("not-a-descriptor\n")


def _break_index(base):
    scan = os.path.join(base, "iio:device0", "scan_elements")
    with open(os.path.join(scan, "in_accel_y_index"), "w") as f:
        f.write("banana\n")


def _break_scale(base):
    with open(os.path.join(base, "iio:device0", "in_accel_x_scale"),
              "w") as f:
        f.write("abc\n")


def _drop_scan(base):
    shutil.rmtree(os.path.join(base, "iio:device0", "scan_elements"))


@pytest.mark.parametrize("breaker,extra,match", [
    (_break_type, "", "type|descriptor|format"),
    (_break_index, "", "banana|invalid literal|index"),
    (_break_scale, "", "abc|could not convert|scale"),
    (_drop_scan, "", "no scan channels"),
    (None, "channels=gyro_z", "no scan channels"),
    (None, "device-number=3", "iio:device3|not found"),
])
def test_malformed_sysfs_fails_at_start_as_jax(tmp_path, breaker, extra,
                                              match):
    """``tests/test_iio.py::TestMalformedSysfs``: a pointed error at
    ``start()``, never a hang or a wrong tensor, in both packages."""
    for tag, pkg in (("jax", jnt), ("port", tnt)):
        d = tmp_path / tag
        d.mkdir()
        base, dev = _mock_tree(d, [(1, 2)])
        if breaker is not None:
            breaker(base)
        num = "" if "device-number" in extra else "device-number=0 "
        pipe = pkg.parse_launch(
            f"tensor_src_iio mode=device {num}{extra} base-dir={base} "
            f"dev-dir={dev} buffer-capacity=2 num-buffers=2 ! "
            "tensor_sink name=out")
        with pytest.raises(Exception, match=match):
            pipe.start()
        pipe.stop()
