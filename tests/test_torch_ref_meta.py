"""The reference ``GstTensorMetaInfo`` header layout and the sparse wire of
the port (``tensors/meta.py``, ``elements/sparse.py``) held to the JAX
package's: the fifteen cases of ``tests/test_ref_meta.py`` run on the
port, against the same hand-derived golden bytes, and each also compares
the port's bytes, parses and errors with the JAX package's on the same
inputs (made with numpy).
"""

import struct

import numpy as np
import pytest

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.elements import sparse as jsparse
from nnstreamer_tpu.tensors import meta as jmeta
from nnstreamer_tpu_torch.elements.sparse import sparse_decode, sparse_encode
from nnstreamer_tpu_torch.pipeline.pipeline import FlowError
from nnstreamer_tpu_torch.tensors.meta import (
    REF_HEADER_SIZE,
    TensorMetaInfo,
    is_ref_header,
    pack_tensor,
    parse_header,
    unpack_tensor,
)
from nnstreamer_tpu_torch.tensors.types import TensorFormat

REF_VERSION = 0xDE001000  # GST_TENSOR_META_MAKE_VERSION(1, 0)


@pytest.fixture
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


def golden_header(type_idx, dims, fmt=0, media=4, nnz=0):
    """The 128-byte header as the C struct memcpy lays it out: u32
    version, u32 type, u32 dim[16] zero-terminated, u32 format, u32
    media_type, u32 nnz, zero padding."""
    words = [REF_VERSION, type_idx] + list(dims) + \
        [0] * (16 - len(dims)) + [fmt, media, nnz]
    hdr = struct.pack("<21I", *words)
    return hdr + b"\x00" * (REF_HEADER_SIZE - len(hdr))


def _same_meta(port, jax_meta):
    """A port header equals the JAX package's field by field."""
    assert port.type.value == jax_meta.type.value
    assert port.dim == jax_meta.dim
    assert port.format.value == jax_meta.format.value
    assert port.sparse_nnz == jax_meta.sparse_nnz


def _raises_as_jax(port_call, jax_call, match):
    with pytest.raises(ValueError, match=match) as port_err:
        port_call()
    with pytest.raises(ValueError, match=match) as jax_err:
        jax_call()
    assert str(port_err.value) == str(jax_err.value)


class TestRefHeader:
    def test_pack_matches_golden_flexible(self):
        meta = TensorMetaInfo(type="float32", dim=(4, 3, 2),
                              format=TensorFormat.FLEXIBLE)
        jax_meta = jmeta.TensorMetaInfo(type="float32", dim=(4, 3, 2),
                                        format="flexible")
        assert meta.pack_ref() == golden_header(7, [4, 3, 2], fmt=1)
        assert meta.pack_ref() == jax_meta.pack_ref()

    def test_unpack_golden(self):
        hdr = golden_header(2, [10, 5], fmt=0)  # int16 [10:5] static
        meta = TensorMetaInfo.unpack_ref(hdr)
        assert meta.type.value == "int16"
        assert meta.dim == (10, 5)
        assert meta.format is TensorFormat.STATIC
        assert meta.sparse_nnz == 0
        _same_meta(meta, jmeta.TensorMetaInfo.unpack_ref(hdr))

    def test_roundtrip_sparse_header(self):
        meta = TensorMetaInfo(type="uint8", dim=(8, 8),
                              format=TensorFormat.SPARSE, sparse_nnz=5)
        back = TensorMetaInfo.unpack_ref(meta.pack_ref())
        assert back == meta
        assert meta.pack_ref() == golden_header(5, [8, 8], fmt=2, nnz=5)
        jax_meta = jmeta.TensorMetaInfo(type="uint8", dim=(8, 8),
                                        format="sparse", sparse_nnz=5)
        assert meta.pack_ref() == jax_meta.pack_ref()
        assert meta.pack() == jax_meta.pack()

    def test_sniffing(self):
        ref = golden_header(7, [2], fmt=1)
        assert is_ref_header(ref)
        native = TensorMetaInfo(type="float32", dim=(2,),
                                format=TensorFormat.FLEXIBLE).pack()
        assert not is_ref_header(native)
        m1, h1 = parse_header(ref)
        m2, h2 = parse_header(native)
        assert m1.dim == m2.dim == (2,)
        assert h1 == REF_HEADER_SIZE and h2 != REF_HEADER_SIZE
        for blob, (m, h) in ((ref, (m1, h1)), (native, (m2, h2))):
            assert jmeta.is_ref_header(blob) == is_ref_header(blob)
            jm, jh = jmeta.parse_header(blob)
            _same_meta(m, jm)
            assert h == jh

    def test_bad_version_refused(self):
        hdr = bytearray(golden_header(7, [2]))
        hdr[3] = 0x00  # break the 0xDE magic byte
        _raises_as_jax(lambda: TensorMetaInfo.unpack_ref(bytes(hdr)),
                       lambda: jmeta.TensorMetaInfo.unpack_ref(bytes(hdr)),
                       "version")

    @pytest.mark.parametrize("hdr,match", [
        (golden_header(10, [2]), "tensor_type"),  # _NNS_END
        (golden_header(7, []), "dimension"),
        (golden_header(7, [2], fmt=3), "tensor_format"),
        (golden_header(7, [2], media=9), "media_type"),
    ], ids=["type", "dimension", "format", "media"])
    def test_validate_like_reference(self, hdr, match):
        """gst_tensor_meta_info_validate's rejections, each with the JAX
        package's message."""
        _raises_as_jax(lambda: TensorMetaInfo.unpack_ref(hdr),
                       lambda: jmeta.TensorMetaInfo.unpack_ref(hdr), match)

    def test_fp16_refused_in_ref_layout(self):
        meta = TensorMetaInfo(type="float16", dim=(2,),
                              format=TensorFormat.FLEXIBLE)
        jax_meta = jmeta.TensorMetaInfo(type="float16", dim=(2,),
                                        format="flexible")
        _raises_as_jax(meta.pack_ref, jax_meta.pack_ref, "tensor_type")
        assert TensorMetaInfo.unpack(meta.pack()) == meta  # native is fine
        assert meta.pack() == jax_meta.pack()


class TestFlexibleStream:
    def test_pack_tensor_reference_layout(self):
        a = np.arange(6, dtype=np.float32).reshape(2, 3)
        blob = pack_tensor(a, layout="reference")
        assert blob[:REF_HEADER_SIZE] == golden_header(7, [3, 2], fmt=1)
        assert blob[REF_HEADER_SIZE:] == a.tobytes()
        assert blob == jmeta.pack_tensor(a, layout="reference")
        out, end = unpack_tensor(blob)
        np.testing.assert_array_equal(out, a)
        assert end == len(blob)

    def test_unpack_accepts_reference_peer_payload(self):
        a = np.arange(12, dtype=np.int32).reshape(3, 4)
        blob = golden_header(0, [4, 3], fmt=1) + a.tobytes()
        out, end = unpack_tensor(blob)
        np.testing.assert_array_equal(out, a)
        jout, jend = jmeta.unpack_tensor(blob)
        assert out.dtype == jout.dtype and out.tobytes() == jout.tobytes()
        assert end == jend

    def test_native_layout_unchanged(self):
        a = np.arange(4, dtype=np.float16)
        blob = pack_tensor(a)
        assert blob == jmeta.pack_tensor(a)
        out, _ = unpack_tensor(blob)
        np.testing.assert_array_equal(out, a)


class TestSparseWire:
    def _dense(self):
        d = np.zeros((4, 4), np.float32)
        d[0, 1] = 1.5
        d[2, 3] = -2.0
        d[3, 0] = 7.0
        return d

    def _golden(self):
        flat = self._dense().reshape(-1)
        nz = np.flatnonzero(flat).astype(np.uint32)
        return (golden_header(7, [4, 4], fmt=2, nnz=len(nz))
                + flat[nz].astype(np.float32).tobytes() + nz.tobytes())

    def test_encode_matches_reference_golden(self):
        """header || values || uint32 flat indices
        (tensor_sparse_util.c:236-240)."""
        d = self._dense()
        assert sparse_encode(d, layout="reference") == self._golden()
        assert sparse_encode(d, layout="reference") == \
            jsparse.sparse_encode(d, layout="reference")

    def test_decode_reference_peer_payload(self):
        golden = self._golden()
        out, end = sparse_decode(golden)
        np.testing.assert_array_equal(out, self._dense())
        assert end == len(golden)
        jout, jend = jsparse.sparse_decode(golden)
        assert out.tobytes() == jout.tobytes() and end == jend

    def test_native_layout_roundtrip(self):
        d = self._dense()
        blob = sparse_encode(d, layout="native")
        assert blob == jsparse.sparse_encode(d, layout="native")
        out, _ = sparse_decode(blob)
        np.testing.assert_array_equal(out, d)

    @pytest.mark.parametrize("layout", ["reference", "native"])
    def test_pipeline_enc_dec_loop(self, cpu_device, layout):
        desc = ("videotestsrc num-buffers=2 width=4 height=4 ! "
                "tensor_converter ! "
                f"tensor_sparse_enc layout={layout} ! tensor_sparse_dec ! "
                "tensor_sink name=out")
        got = {}
        for tag, pkg in (("jax", jnt), ("port", tnt)):
            pipe = pkg.parse_launch(desc)
            outs = []
            pipe.get("out").connect(lambda buf: outs.append(buf))
            msg = pipe.run(timeout=30)
            assert msg is not None and msg.kind == "eos", msg
            assert len(outs) == 2
            assert np.asarray(outs[0].tensors[0]).shape == (1, 4, 4, 3)
            got[tag] = [np.asarray(b.tensors[0]).tobytes() for b in outs]
        assert got["port"] == got["jax"]

    def test_bad_layout_refused(self, cpu_device):
        desc = ("videotestsrc num-buffers=1 width=4 height=4 ! "
                "tensor_converter ! tensor_sparse_enc layout=bogus ! "
                "tensor_sink name=out")
        with pytest.raises(FlowError, match="unknown layout"):
            tnt.parse_launch(desc).run(timeout=30)
        from nnstreamer_tpu.pipeline.pipeline import FlowError as JFlowError

        with pytest.raises(JFlowError, match="unknown layout"):
            jnt.parse_launch(desc).run(timeout=30)
