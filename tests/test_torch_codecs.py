"""The port's script codecs — the ``python3`` converter
(``converters/python3.py``, ``tensor_converter mode=custom-code:<name>``)
and the ``python3`` decoder (``decoders/python3.py``) — held to the JAX
package's: the same user scripts through both packages on the CPU give
equal tensors and caps. The flexbuf, flatbuf and protobuf codecs wait for
ROADMAP 26d.
"""

import numpy as np
import pytest

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt

CONVERTER = (
    "import numpy as np\n"
    "class Converter:\n"
    "    def convert(self, buf, in_caps):\n"
    "        return buf.with_tensors("
    "[np.asarray(t).astype(np.float32) * 2 for t in buf.tensors])\n")

DECODER = (
    "import numpy as np\n"
    "class Decoder:\n"
    "    def out_caps(self, config, options):\n"
    "        return None\n"
    "    def decode(self, buf, config, options):\n"
    "        x = np.asarray(buf[0])\n"
    "        s = np.array([x.min(), x.max(), x.sum()], np.int64)\n"
    "        return buf.with_tensors([s]).replace(\n"
    "            meta={**buf.meta, 'sum': int(s[2])})\n")


@pytest.fixture
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


def _both(desc):
    outs = []
    for pkg in (jnt, tnt):
        pipe = pkg.parse_launch(desc)
        msg = pipe.run(timeout=30)
        assert msg is not None and msg.kind == "eos", msg
        outs.append(pipe)
    return outs


def _refresh_confs():
    from nnstreamer_tpu.config import get_conf as jax_conf
    from nnstreamer_tpu_torch.config import get_conf

    jax_conf(refresh=True)
    get_conf(refresh=True)


def test_python3_converter_conf_driven_matches_jax(cpu_device, tmp_path,
                                                   monkeypatch):
    """``tests/test_codecs.py::test_python3_converter_conf_driven``:
    ``mode=custom-code:python3`` resolves its script from the config
    system (``NNSTREAMER_TPU_CONVERTER_PYTHON3_SCRIPT``)."""
    script = tmp_path / "conv.py"
    script.write_text(CONVERTER)
    monkeypatch.setenv("NNSTREAMER_TPU_CONVERTER_PYTHON3_SCRIPT",
                       str(script))
    _refresh_confs()
    try:
        jp, tp = _both(
            "videotestsrc num-buffers=2 width=4 height=4 ! "
            "tensor_converter mode=custom-code:python3 ! "
            "tensor_sink name=out")
    finally:
        monkeypatch.delenv("NNSTREAMER_TPU_CONVERTER_PYTHON3_SCRIPT")
        _refresh_confs()
    got, want = tp.get("out").buffers, jp.get("out").buffers
    assert len(got) == len(want) == 2
    out = np.asarray(got[0][0])
    assert out.dtype == np.float32 and out.max() > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    assert str(tp.get("out").sinkpad.caps) == \
        str(jp.get("out").sinkpad.caps)


def test_python3_converter_reloads_an_edited_script(tmp_path, monkeypatch):
    from nnstreamer_tpu_torch.converters.python3 import Python3Converter
    from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

    script = tmp_path / "conv.py"
    script.write_text(CONVERTER)
    monkeypatch.setenv("NNSTREAMER_TPU_CONVERTER_PYTHON3_SCRIPT",
                       str(script))
    _refresh_confs()
    try:
        conv = Python3Converter()
        buf = TensorBuffer([np.ones(3, np.uint8)])
        assert conv.convert(buf, None)[0].tolist() == [2.0, 2.0, 2.0]
        script.write_text(CONVERTER.replace("* 2", "* 3"))
        st = script.stat()
        import os

        os.utime(script, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
        assert conv.convert(buf, None)[0].tolist() == [3.0, 3.0, 3.0]
    finally:
        monkeypatch.delenv("NNSTREAMER_TPU_CONVERTER_PYTHON3_SCRIPT")
        _refresh_confs()


def test_python3_converter_needs_a_script(monkeypatch):
    from nnstreamer_tpu_torch.converters.python3 import Python3Converter

    monkeypatch.delenv("NNSTREAMER_TPU_CONVERTER_PYTHON3_SCRIPT",
                       raising=False)
    _refresh_confs()
    with pytest.raises(ValueError, match="python3_script"):
        Python3Converter().convert(None, None)


def test_registered_script_converter_matches_jax(cpu_device, tmp_path):
    """App registration: ``load_python_converter(name, path)``, then
    ``mode=custom-code:<name>``."""
    from nnstreamer_tpu.converters.python3 import (
        load_python_converter as jax_load,
    )
    from nnstreamer_tpu_torch.converters.python3 import load_python_converter

    script = tmp_path / "dbl.py"
    script.write_text(CONVERTER)
    jax_load("doubler", str(script))
    load_python_converter("doubler", str(script))
    jp, tp = _both("videotestsrc num-buffers=3 width=4 height=2 "
                   "pattern=smpte ! tensor_converter mode=custom-code:doubler "
                   "! tensor_sink name=out")
    for a, b in zip(tp.get("out").buffers, jp.get("out").buffers):
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    assert len(tp.get("out").buffers) == 3


def test_unknown_converter_subplugin_raises(cpu_device):
    from nnstreamer_tpu_torch.pipeline.element import FlowError

    pipe = tnt.parse_launch("videotestsrc num-buffers=1 ! tensor_converter "
                            "mode=custom-code:nope ! tensor_sink")
    with pytest.raises(FlowError, match="no converter subplugin 'nope'"):
        pipe.run(timeout=15)


def test_python3_decoder_matches_jax(cpu_device, tmp_path):
    script = tmp_path / "dec.py"
    script.write_text(DECODER)
    jp, tp = _both(
        "videotestsrc num-buffers=3 width=6 height=4 pattern=gradient ! "
        "tensor_converter ! tensor_decoder mode=python3 "
        f"option1={script} ! tensor_sink name=out")
    got, want = tp.get("out").buffers, jp.get("out").buffers
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
        assert a.meta["sum"] == b.meta["sum"] > 0
    assert str(tp.get("out").sinkpad.caps) == \
        str(jp.get("out").sinkpad.caps)


def test_python3_decoder_script_errors(tmp_path):
    from nnstreamer_tpu_torch.decoders.python3 import Python3Decoder

    with pytest.raises(ValueError, match="option1"):
        Python3Decoder().out_caps(None, {})
    with pytest.raises(FileNotFoundError):
        Python3Decoder().out_caps(None, {"option1": str(tmp_path / "x.py")})
    bad = tmp_path / "bad.py"
    bad.write_text("class NotADecoder:\n    pass\n")
    with pytest.raises(ValueError, match="class Decoder"):
        Python3Decoder().out_caps(None, {"option1": str(bad)})


def test_registered_converter_script_without_the_class(tmp_path):
    """The converter and the decoder share one script loader: a converter
    script without ``class Converter`` is refused as the decoder's is."""
    from nnstreamer_tpu_torch.converters.python3 import load_python_converter

    bad = tmp_path / "bad.py"
    bad.write_text("class Decoder:\n    pass\n")
    with pytest.raises(ValueError, match="class Converter"):
        load_python_converter("no_converter_class", str(bad))
    with pytest.raises(FileNotFoundError):
        load_python_converter("no_converter_file", str(tmp_path / "x.py"))
