"""The port's codecs held to the JAX package's on the CPU.

- The script codecs — the ``python3`` converter (``converters/python3.py``,
  ``tensor_converter mode=custom-code:<name>``) and the ``python3`` decoder
  (``decoders/python3.py``): the same user scripts through both packages
  give equal tensors and caps.
- The serialization codecs — ``flexbuf``, ``nnstpu-flex``, ``protobuf``
  and ``flatbuf`` (``decoders/flexbuf.py``, ``decoders/protobuf_codec.py``,
  ``decoders/flatbuf_codec.py`` and their converters): the cases of
  ``tests/test_codecs.py`` on the port, each also holding the port's
  bytes, tensors and errors to the JAX package's. The cases that read the
  reference's own ``.proto``/``.fbs`` files use ``tests/test_codecs.py``'s
  fixtures, so they skip exactly where the JAX cases skip.
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


# -- the serialization codecs (tests/test_codecs.py) ---------------------------
from nnstreamer_tpu.decoders import flatbuf_codec as jflatbuf  # noqa: E402
from nnstreamer_tpu.decoders import flexbuf as jflexbuf  # noqa: E402
from nnstreamer_tpu.decoders import protobuf_codec as jprotobuf  # noqa: E402
from nnstreamer_tpu.tensors.buffer import (  # noqa: E402
    TensorBuffer as JTensorBuffer,
)
from nnstreamer_tpu_torch.decoders import flatbuf_codec  # noqa: E402
from nnstreamer_tpu_torch.decoders.flexbuf import (  # noqa: E402
    decode_flex,
    decode_flexbuf,
    encode_flex,
    encode_flexbuf,
)
from nnstreamer_tpu_torch.decoders.protobuf_codec import (  # noqa: E402
    decode_protobuf,
    encode_protobuf,
)
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer  # noqa: E402
from tests.test_codecs import (  # noqa: E402,F401 (fixtures)
    _REF_FBS,
    _fb_read_table,
    _ref_peer_encode,
    ref_fbs,
    ref_pb2,
)

#: name → (port encode, port decode, JAX encode, JAX decode)
CODECS = {
    "flexbuf": (encode_flexbuf, decode_flexbuf, jflexbuf.encode_flexbuf,
                jflexbuf.decode_flexbuf),
    "nnstpu-flex": (encode_flex, decode_flex, jflexbuf.encode_flex,
                    jflexbuf.decode_flex),
    "protobuf": (encode_protobuf, decode_protobuf,
                 jprotobuf.encode_protobuf, jprotobuf.decode_protobuf),
    "flatbuf": (flatbuf_codec.encode_flatbuf, flatbuf_codec.decode_flatbuf,
                jflatbuf.encode_flatbuf, jflatbuf.decode_flatbuf),
}


def _arrays():
    return [np.arange(24, dtype=np.float32).reshape(2, 3, 4),
            np.array([[1, 2], [3, 4]], np.uint8),
            np.array([7], np.int64)]


def _buf():
    return TensorBuffer(_arrays())


def _jbuf():
    return JTensorBuffer(_arrays())


def _same_tensors(port, jax_buf):
    assert port.num_tensors == jax_buf.num_tensors
    for a, b in zip(port.tensors, jax_buf.tensors):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", sorted(CODECS))
def test_codec_roundtrip(name):
    enc, dec, jenc, jdec = CODECS[name]
    blob = enc(_buf())
    jblob = jenc(_jbuf())
    assert blob == jblob
    out = dec(blob)
    assert out.num_tensors == 3
    for a, b in zip(_buf().tensors, out.tensors):
        assert a.dtype == b.dtype
        if name in ("protobuf", "flexbuf", "flatbuf"):
            # the reference's rank-4 format: shapes come back 1-padded
            assert b.shape == (1,) * (4 - a.ndim) + a.shape
        else:
            assert a.shape == b.shape
        np.testing.assert_array_equal(a.reshape(b.shape), b)
    _same_tensors(out, jdec(blob))


@pytest.mark.parametrize("name", sorted(CODECS))
def test_codec_pipeline_loop(cpu_device, name):
    """tensor_decoder mode=<codec> ! tensor_converter mode=<codec> is an
    identity over the wire format, in both packages alike."""
    desc = (f"videotestsrc num-buffers=3 width=4 height=4 ! "
            f"tensor_converter ! tensor_decoder mode={name} ! "
            f"tensor_converter mode={name} ! tensor_sink name=out")
    jp, tp = _both(desc)
    out, jout = tp.get("out").buffers, jp.get("out").buffers
    assert len(out) == len(jout) == 3
    assert out[0].tensors[0].shape == (1, 4, 4, 3)
    assert out[0].tensors[0].dtype == np.uint8
    for a, b in zip(out, jout):
        _same_tensors(a, b)


def test_flatbuf_rate_field():
    from fractions import Fraction

    blob = flatbuf_codec.encode_flatbuf(_buf(), rate=Fraction(30, 1))
    assert blob == jflatbuf.encode_flatbuf(_jbuf(), rate=Fraction(30, 1))
    out = flatbuf_codec.decode_flatbuf(blob)
    assert out.num_tensors == 3
    assert str(out.meta["framerate"]) == "30/1"
    np.testing.assert_array_equal(out.tensors[0].reshape(2, 3, 4),
                                  _buf().tensors[0])


def _refused_as_jax(port_call, jax_call, match):
    with pytest.raises(ValueError, match=match) as port_err:
        port_call()
    with pytest.raises(ValueError, match=match) as jax_err:
        jax_call()
    assert str(port_err.value) == str(jax_err.value)


class TestProtobufWireCompat:
    def test_reference_parses_our_payload(self, ref_pb2):
        from nnstreamer_tpu_torch.tensors.types import Fraction

        blob = encode_protobuf(_buf(), rate=Fraction(30, 1))
        msg = ref_pb2.Tensors.FromString(blob)
        assert msg.num_tensor == 3
        assert (msg.fr.rate_n, msg.fr.rate_d) == (30, 1)
        assert msg.format == ref_pb2.Tensors.NNS_TENSOR_FORAMT_STATIC
        t0 = msg.tensor[0]
        assert t0.type == ref_pb2.Tensor.NNS_FLOAT32
        assert list(t0.dimension) == [4, 3, 2, 1]
        np.testing.assert_array_equal(
            np.frombuffer(t0.data, np.float32).reshape(2, 3, 4),
            _buf().tensors[0])
        assert msg.tensor[1].type == ref_pb2.Tensor.NNS_UINT8
        assert msg.tensor[2].type == ref_pb2.Tensor.NNS_INT64

    def test_we_parse_reference_payload(self, ref_pb2):
        msg = ref_pb2.Tensors(num_tensor=2)
        msg.fr.rate_n = 25
        msg.fr.rate_d = 1
        msg.format = ref_pb2.Tensors.NNS_TENSOR_FORAMT_STATIC
        a = np.arange(12, dtype=np.int16).reshape(3, 4)
        t = msg.tensor.add()
        t.name = "scores"
        t.type = ref_pb2.Tensor.NNS_INT16
        t.dimension.extend([4, 3, 1, 1])
        t.data = a.tobytes()
        b = np.array([1.5, -2.5], np.float64)
        t = msg.tensor.add()
        t.type = ref_pb2.Tensor.NNS_FLOAT64
        t.dimension.extend([2, 1, 1, 1])
        t.data = b.tobytes()

        out = decode_protobuf(msg.SerializeToString())
        assert out.num_tensors == 2
        assert out.tensors[0].shape == (1, 1, 3, 4)
        np.testing.assert_array_equal(out.tensors[0].reshape(3, 4), a)
        assert out.tensors[1].dtype == np.float64
        np.testing.assert_array_equal(out.tensors[1].reshape(2), b)
        assert str(out.meta["framerate"]) == "25/1"
        assert out.meta["format"] == "static"
        assert out.meta["tensor_names"] == ["scores", None]
        _same_tensors(out, jprotobuf.decode_protobuf(
            msg.SerializeToString()))

    def test_byte_identical_serialization(self, ref_pb2):
        from nnstreamer_tpu_torch.tensors.types import Fraction

        ours = encode_protobuf(_buf(), rate=Fraction(15, 2))
        theirs = ref_pb2.Tensors.FromString(ours).SerializeToString()
        assert ours == theirs

    def test_fp16_refused(self):
        _refused_as_jax(
            lambda: encode_protobuf(
                TensorBuffer([np.zeros((2, 2), np.float16)])),
            lambda: jprotobuf.encode_protobuf(
                JTensorBuffer([np.zeros((2, 2), np.float16)])),
            "tensor_type")

    def test_rank5_refused(self):
        _refused_as_jax(
            lambda: encode_protobuf(
                TensorBuffer([np.zeros((1, 2, 3, 4, 5), np.float32)])),
            lambda: jprotobuf.encode_protobuf(
                JTensorBuffer([np.zeros((1, 2, 3, 4, 5), np.float32)])),
            "nnstpu-flex")

    def test_bad_wire_values_refused(self, ref_pb2):
        msg = ref_pb2.Tensors(num_tensor=1)
        t = msg.tensor.add()
        t.type = -1
        t.dimension.extend([1, 1, 1, 1])
        t.data = b"\x00\x00"
        blob = msg.SerializeToString()
        _refused_as_jax(lambda: decode_protobuf(blob),
                        lambda: jprotobuf.decode_protobuf(blob),
                        "tensor_type")
        msg.tensor[0].type = ref_pb2.Tensor.NNS_INT16
        msg.format = -1
        blob = msg.SerializeToString()
        _refused_as_jax(lambda: decode_protobuf(blob),
                        lambda: jprotobuf.decode_protobuf(blob),
                        "tensor_format")

    def test_converter_keeps_wire_meta(self, ref_pb2):
        msg = ref_pb2.Tensors(num_tensor=1)
        msg.fr.rate_n = 10
        msg.fr.rate_d = 1
        t = msg.tensor.add()
        t.name = "probs"
        t.type = ref_pb2.Tensor.NNS_FLOAT32
        t.dimension.extend([2, 1, 1, 1])
        t.data = np.zeros(2, np.float32).tobytes()
        blob = np.frombuffer(msg.SerializeToString(), np.uint8)

        from nnstreamer_tpu_torch.converters.protobuf_codec import (
            ProtobufConverter,
        )

        out = ProtobufConverter().convert(TensorBuffer([blob]), None)
        assert str(out.meta["framerate"]) == "10/1"
        assert out.meta["tensor_names"] == ["probs"]


class TestFlexbufWireCompat:
    def test_reference_parses_our_payload(self):
        from flatbuffers import flexbuffers

        from nnstreamer_tpu_torch.tensors.types import Fraction

        blob = encode_flexbuf(_buf(), rate=Fraction(30, 1))
        m = flexbuffers.GetRoot(blob).AsMap
        assert m["num_tensors"].AsInt == 3
        assert (m["rate_n"].AsInt, m["rate_d"].AsInt) == (30, 1)
        assert m["format"].AsInt == 0
        t0 = m["tensor_0"].AsVector
        assert t0[0].AsString == ""
        assert t0[1].AsInt == 7  # _NNS_FLOAT32
        assert [d.AsInt for d in t0[2].AsTypedVector] == [4, 3, 2, 1]
        np.testing.assert_array_equal(
            np.frombuffer(bytes(t0[3].AsBlob), np.float32).reshape(2, 3, 4),
            _buf().tensors[0])
        assert m["tensor_1"].AsVector[1].AsInt == 5  # _NNS_UINT8
        assert m["tensor_2"].AsVector[1].AsInt == 8  # _NNS_INT64

    def test_we_parse_reference_payload(self):
        a = np.arange(12, dtype=np.int16).reshape(3, 4)
        b = np.array([1.5, -2.5], np.float64)
        blob = _ref_peer_encode([a, b], names=["scores", None],
                                rate=(25, 1))
        out = decode_flexbuf(blob)
        assert out.num_tensors == 2
        assert out.tensors[0].shape == (1, 1, 3, 4)
        np.testing.assert_array_equal(out.tensors[0].reshape(3, 4), a)
        assert out.tensors[1].dtype == np.float64
        np.testing.assert_array_equal(out.tensors[1].reshape(2), b)
        assert str(out.meta["framerate"]) == "25/1"
        assert out.meta["format"] == "static"
        assert out.meta["tensor_names"] == ["scores", None]
        _same_tensors(out, jflexbuf.decode_flexbuf(blob))

    def test_byte_identical_serialization(self):
        from nnstreamer_tpu_torch.tensors.types import Fraction

        frame = _buf()
        ours = encode_flexbuf(frame, rate=Fraction(15, 2))
        theirs = _ref_peer_encode(list(frame.tensors), rate=(15, 2))
        assert ours == theirs

    def test_fp16_refused(self):
        _refused_as_jax(
            lambda: encode_flexbuf(
                TensorBuffer([np.zeros((2, 2), np.float16)])),
            lambda: jflexbuf.encode_flexbuf(
                JTensorBuffer([np.zeros((2, 2), np.float16)])),
            "tensor_type")

    def test_rank5_goes_to_native_framing(self):
        arr = np.zeros((1, 2, 3, 4, 5), np.float32)
        _refused_as_jax(lambda: encode_flexbuf(TensorBuffer([arr])),
                        lambda: jflexbuf.encode_flexbuf(
                            JTensorBuffer([arr])), "nnstpu-flex")
        blob = encode_flex(TensorBuffer([arr]))
        assert blob == jflexbuf.encode_flex(JTensorBuffer([arr]))
        out = decode_flex(blob)  # native framing handles it
        assert out.tensors[0].shape == (1, 2, 3, 4, 5)

    def test_bad_wire_values_refused(self):
        a = np.zeros((2,), np.float32)
        blob = _ref_peer_encode([a], fmt=9)
        _refused_as_jax(lambda: decode_flexbuf(blob),
                        lambda: jflexbuf.decode_flexbuf(blob),
                        "tensor_format")
        from flatbuffers import flexbuffers

        fbb = flexbuffers.Builder()
        with fbb.Map():
            fbb.Key("num_tensors")
            fbb.UInt(1)
            fbb.Key("rate_n")
            fbb.Int(0)
            fbb.Key("rate_d")
            fbb.Int(1)
            fbb.Key("format")
            fbb.Int(0)
            fbb.Key("tensor_0")
            with fbb.Vector():
                fbb.String("")
                fbb.Int(99)  # not a tensor_type
                fbb.TypedVectorFromElements([1, 1, 1, 1])
                fbb.Blob(b"\x00")
        blob = bytes(fbb.Finish())
        _refused_as_jax(lambda: decode_flexbuf(blob),
                        lambda: jflexbuf.decode_flexbuf(blob),
                        "tensor_type")

    def test_converter_keeps_wire_meta(self):
        from nnstreamer_tpu_torch.converters.flexbuf import FlexBufConverter

        blob = _ref_peer_encode([np.zeros(2, np.float32)], names=["probs"],
                                rate=(10, 1))
        out = FlexBufConverter().convert(
            TensorBuffer([np.frombuffer(blob, np.uint8)]), None)
        assert str(out.meta["framerate"]) == "10/1"
        assert out.meta["tensor_names"] == ["probs"]


class TestFlatbufWireCompat:
    def test_schema_layout_matches_codec_constants(self, ref_fbs):
        from nnstreamer_tpu_torch.tensors import wire

        assert [f[0] for f in ref_fbs["tables"]["Tensors"]] == \
            ["num_tensor", "fr", "tensor", "format"]
        assert [f[0] for f in ref_fbs["tables"]["Tensor"]] == \
            ["name", "type", "dimension", "data"]
        ref_types = ref_fbs["enums"]["Tensor_type"]
        assert ref_types[-1] == "NNS_END"
        assert len(ref_types) - 1 == wire.REF_TYPE_COUNT
        ours = [t.value for t in wire.TYPE_ORDER[:wire.REF_TYPE_COUNT]]
        theirs = [n.replace("NNS_", "").lower() for n in ref_types[:-1]]
        assert ours == theirs
        fmts = ref_fbs["enums"]["Tensor_format"][:3]
        assert [f.split("_")[-1].lower() for f in fmts] == \
            [f.value for f in wire.FORMAT_ORDER]

    def test_reference_parses_our_payload(self, ref_fbs):
        import struct as _s

        from nnstreamer_tpu_torch.tensors.types import Fraction

        slots = {f[0]: i
                 for i, f in enumerate(ref_fbs["tables"]["Tensors"])}
        tslots = {f[0]: i
                  for i, f in enumerate(ref_fbs["tables"]["Tensor"])}
        blob = flatbuf_codec.encode_flatbuf(_buf(), rate=Fraction(30, 1))
        root = _s.unpack_from("<I", blob, 0)[0]
        field = _fb_read_table(blob, root)
        assert _s.unpack_from("<i", blob, field(slots["num_tensor"]))[0] == 3
        assert _s.unpack_from("<ii", blob, field(slots["fr"])) == (30, 1)
        assert field(slots["format"]) == 0
        vec_off = field(slots["tensor"])
        vec = vec_off + _s.unpack_from("<I", blob, vec_off)[0]
        assert _s.unpack_from("<I", blob, vec)[0] == 3
        t0 = vec + 4 + _s.unpack_from("<I", blob, vec + 4)[0]
        tf = _fb_read_table(blob, t0)
        assert _s.unpack_from("<i", blob, tf(tslots["type"]))[0] == 7
        d_off = tf(tslots["dimension"])
        dvec = d_off + _s.unpack_from("<I", blob, d_off)[0]
        dn = _s.unpack_from("<I", blob, dvec)[0]
        assert _s.unpack_from(f"<{dn}I", blob, dvec + 4) == (4, 3, 2, 1)
        assert tf(tslots["name"]) != 0

    def test_we_parse_reference_payload(self):
        import flatbuffers as fb

        a = np.arange(12, dtype=np.int16).reshape(3, 4)
        b = fb.Builder(256)
        data_off = b.CreateByteVector(a.tobytes())
        b.StartVector(4, 4, 4)
        for d in reversed([4, 3, 1, 1]):
            b.PrependUint32(d)
        dim_off = b.EndVector()
        name_off = b.CreateString("scores")
        b.StartObject(4)
        b.PrependUOffsetTRelativeSlot(0, name_off, 0)
        b.PrependInt32Slot(1, 2, 10)  # NNS_INT16, default NNS_END
        b.PrependUOffsetTRelativeSlot(2, dim_off, 0)
        b.PrependUOffsetTRelativeSlot(3, data_off, 0)
        t_off = b.EndObject()
        b.StartVector(4, 1, 4)
        b.PrependUOffsetTRelative(t_off)
        vec_off = b.EndVector()
        b.StartObject(4)
        b.PrependInt32Slot(0, 1, 0)
        b.Prep(4, 8)
        b.PrependInt32(1)   # rate_d
        b.PrependInt32(25)  # rate_n
        b.PrependStructSlot(1, b.Offset(), 0)
        b.PrependUOffsetTRelativeSlot(2, vec_off, 0)
        b.Finish(b.EndObject())

        blob = bytes(b.Output())
        out = flatbuf_codec.decode_flatbuf(blob)
        assert out.num_tensors == 1
        assert out.tensors[0].shape == (1, 1, 3, 4)
        np.testing.assert_array_equal(out.tensors[0].reshape(3, 4), a)
        assert str(out.meta["framerate"]) == "25/1"
        assert out.meta["format"] == "static"
        assert out.meta["tensor_names"] == ["scores"]
        _same_tensors(out, jflatbuf.decode_flatbuf(blob))

    def test_fp16_refused(self):
        _refused_as_jax(
            lambda: flatbuf_codec.encode_flatbuf(
                TensorBuffer([np.zeros((2, 2), np.float16)])),
            lambda: jflatbuf.encode_flatbuf(
                JTensorBuffer([np.zeros((2, 2), np.float16)])),
            "tensor_type")

    def test_rank5_refused(self):
        arr = np.zeros((1, 2, 3, 4, 5), np.float32)
        _refused_as_jax(
            lambda: flatbuf_codec.encode_flatbuf(TensorBuffer([arr])),
            lambda: jflatbuf.encode_flatbuf(JTensorBuffer([arr])),
            "nnstpu-flex")

    def test_flatc_generated_cross_proof(self, tmp_path):
        import shutil
        import subprocess
        import sys

        if shutil.which("flatc") is None:
            pytest.skip("flatc unavailable")
        subprocess.run(["flatc", "--python", "-o", str(tmp_path), _REF_FBS],
                       check=True, capture_output=True)
        sys.path.insert(0, str(tmp_path))
        try:
            from nnstreamer.flatbuf.Tensors import Tensors

            from nnstreamer_tpu_torch.tensors.types import Fraction

            blob = flatbuf_codec.encode_flatbuf(_buf(),
                                                rate=Fraction(30, 1))
            msg = Tensors.GetRootAs(blob, 0)
            assert msg.NumTensor() == 3
            assert (msg.Fr().RateN(), msg.Fr().RateD()) == (30, 1)
            t0 = msg.Tensor(0)
            assert t0.Type() == 7  # NNS_FLOAT32
            assert [t0.Dimension(j) for j in range(4)] == [4, 3, 2, 1]
        finally:
            sys.path.remove(str(tmp_path))


_NO_CODEC_PACKAGES = (
    "import sys\n"
    "for name in ('flatbuffers', 'google.protobuf', 'tensorflow'):\n"
    "    sys.modules[name] = None\n"
    "import importlib, pkgutil\n"
    "import numpy as np\n"
    "import nnstreamer_tpu_torch as p\n"
    "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
    "    importlib.import_module(m.name)\n"
    "from nnstreamer_tpu_torch.decoders import flatbuf_codec, flexbuf, "
    "protobuf_codec\n"
    "from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer\n"
    "buf = TensorBuffer([np.zeros(2, np.float32)])\n"
    "for fn, package in ((flexbuf.encode_flexbuf, 'flatbuffers'),\n"
    "                    (flatbuf_codec.encode_flatbuf, 'flatbuffers'),\n"
    "                    (protobuf_codec.encode_protobuf, 'protobuf')):\n"
    "    try:\n"
    "        fn(buf)\n"
    "    except ImportError as e:\n"
    "        assert repr(package) in str(e), e\n"
    "    else:\n"
    "        raise SystemExit(f'{fn.__name__} ran without {package}')\n"
    "flexbuf.encode_flex(buf)  # the native framing needs no package\n"
    "print('ok')\n")


def test_port_imports_without_the_codec_packages():
    """Every port module imports with ``flatbuffers``, ``google.protobuf``
    and ``tensorflow`` absent; a codec that needs one raises an
    ImportError naming its package at first use."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", _NO_CODEC_PACKAGES],
                          cwd=repo, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and "ok" in proc.stdout, \
        proc.stdout + proc.stderr
