"""The port's sparse codec (``elements/sparse.py``: ``sparse_encode``,
``sparse_decode``, ``tensor_sparse_enc``/``dec``) held to the JAX
package's, byte for byte: both layouts for every numeric type, all-zero
and all-non-zero tensors, ``-0.0`` and NaN (the JAX package scans with its
C++ library, which compares bytes), rank 5 in the native layout, each
package decoding the other's blobs, and garbage or truncated payloads
refused. Inputs are made with numpy from a seed.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu import native as jnative
from nnstreamer_tpu.elements import sparse as jsparse
from nnstreamer_tpu_torch.elements.sparse import sparse_decode, sparse_encode

REF_TYPES = ["int32", "uint32", "int16", "uint16", "int8", "uint8",
             "float64", "float32", "int64", "uint64"]
ALL_TYPES = REF_TYPES + ["float16", "bfloat16"]
SHAPE = (3, 5, 7)


@pytest.fixture(scope="module", autouse=True)
def jax_scans_with_the_library():
    """The JAX encoder keeps -0.0 and NaN only through ``libnnstpu.so``
    (its numpy fallback drops -0.0): these cases hold the port to the
    library's scan, so the library must have loaded."""
    assert jnative.get_lib() is not None, "libnnstpu.so did not load"


@pytest.fixture
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


def _bits(dtype: str, values: np.ndarray):
    """The same elements for both packages: (port input, JAX input). A
    bfloat16 tensor is a torch tensor in the port and an ml_dtypes array
    in the JAX package, with the same 16-bit patterns."""
    if dtype == "bfloat16":
        u16 = values.astype(np.float32).view(np.uint32) >> 16
        u16 = u16.astype(np.uint16)
        port = torch.from_numpy(u16.view(np.int16).copy()).view(
            torch.bfloat16)
        return port, u16.view(ml_dtypes.bfloat16)
    arr = values.astype(dtype)
    return arr, arr


def _mostly_zero(dtype: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    vals = rng.integers(1, 100, size=SHAPE).astype(np.float64)
    return np.where(rng.random(SHAPE) < 0.7, 0.0, vals)


def _dense_bytes(out) -> bytes:
    if isinstance(out, torch.Tensor):
        return out.contiguous().view(torch.int16).numpy().tobytes()
    return np.ascontiguousarray(out).tobytes()


def _jax_bytes(out) -> bytes:
    return np.ascontiguousarray(out).tobytes()


@pytest.mark.parametrize("dtype", REF_TYPES)
def test_reference_layout_matches_jax_for_every_type(dtype):
    port, jax_in = _bits(dtype, _mostly_zero(dtype))
    blob = sparse_encode(port, layout="reference")
    assert blob == jsparse.sparse_encode(jax_in, layout="reference")
    out, end = sparse_decode(blob)
    assert end == len(blob)
    assert _dense_bytes(out) == _jax_bytes(jax_in)
    assert out.dtype == np.dtype(dtype)


@pytest.mark.parametrize("dtype", ALL_TYPES)
def test_native_layout_matches_jax_for_every_type(dtype):
    port, jax_in = _bits(dtype, _mostly_zero(dtype, seed=1))
    blob = sparse_encode(port, layout="native")
    assert blob == jsparse.sparse_encode(jax_in, layout="native")
    out, end = sparse_decode(blob)
    assert end == len(blob)
    assert _dense_bytes(out) == _jax_bytes(jax_in)
    if dtype == "bfloat16":
        assert out.dtype == torch.bfloat16
    else:
        assert out.dtype == np.dtype(dtype)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_half_types_refused_in_the_reference_layout(dtype):
    port, jax_in = _bits(dtype, _mostly_zero(dtype))
    with pytest.raises(ValueError, match="tensor_type") as port_err:
        sparse_encode(port, layout="reference")
    with pytest.raises(ValueError, match="tensor_type") as jax_err:
        jsparse.sparse_encode(jax_in, layout="reference")
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("layout", ["reference", "native"])
@pytest.mark.parametrize("fill", ["zeros", "nonzero"])
def test_all_zero_and_all_nonzero(layout, fill):
    rng = np.random.default_rng(2)
    if fill == "zeros":
        a = np.zeros(SHAPE, np.float32)
    else:
        a = rng.uniform(1.0, 2.0, SHAPE).astype(np.float32)
    blob = sparse_encode(a, layout=layout)
    assert blob == jsparse.sparse_encode(a, layout=layout)
    out, _ = sparse_decode(blob)
    assert out.tobytes() == a.tobytes()
    nnz = 0 if fill == "zeros" else a.size
    meta, _ = jnt.tensors.meta.parse_header(blob)
    assert meta.sparse_nnz == nnz


@pytest.mark.parametrize("layout,dtype", [
    ("reference", "float32"), ("reference", "float64"),
    ("native", "float16"), ("native", "float32"), ("native", "float64"),
    ("native", "bfloat16")])
def test_negative_zero_and_nan_are_kept_as_the_library_keeps_them(layout,
                                                                  dtype):
    """-0.0 and every NaN have non-zero bytes, so the library's scan keeps
    them; so does the port's. Bytes come back exactly (NaN payloads too).
    The reference layout has no half types (refused above)."""
    vals = np.array([0.0, -0.0, np.nan, 1.0, 0.0, -np.nan, -0.0, 0.0])
    port, jax_in = _bits(dtype, vals)
    blob = sparse_encode(port, layout=layout)
    assert blob == jsparse.sparse_encode(jax_in, layout=layout)
    meta, _ = jnt.tensors.meta.parse_header(blob)
    assert meta.sparse_nnz == 5  # -0.0, NaN, 1.0, -NaN, -0.0
    out, _ = sparse_decode(blob)
    assert _dense_bytes(out) == _jax_bytes(jax_in)


@pytest.mark.parametrize("layout,dtype", [
    ("reference", "float32"), ("reference", "float64"),
    ("native", "float16"), ("native", "float32"), ("native", "bfloat16")])
def test_negative_zero_and_nan_are_kept_without_the_port_library(
        layout, dtype, monkeypatch):
    """C.34 on the port's numpy path: with its native library unloaded the
    scan still reads each element's bytes, so the blob is the library's
    (the JAX package's, which has its library loaded)."""
    from nnstreamer_tpu_torch import native as tnative

    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", True)
    vals = np.array([0.0, -0.0, np.nan, 1.0, 0.0, -np.nan, -0.0, 0.0])
    port, jax_in = _bits(dtype, vals)
    blob = sparse_encode(port, layout=layout)
    assert blob == jsparse.sparse_encode(jax_in, layout=layout)
    out, _ = sparse_decode(blob)
    assert _dense_bytes(out) == _jax_bytes(jax_in)


def test_rank5_in_the_native_layout():
    a = _mostly_zero("int16").astype(np.int16).reshape(1, 3, 1, 5, 7)
    blob = sparse_encode(a, layout="native")
    assert blob == jsparse.sparse_encode(a, layout="native")
    out, _ = sparse_decode(blob)
    assert out.shape == a.shape and out.tobytes() == a.tobytes()
    # the reference header holds rank 5 too, and each package parses it
    ref = sparse_encode(a, layout="reference")
    assert ref == jsparse.sparse_encode(a, layout="reference")
    out, _ = sparse_decode(ref)
    assert out.shape == a.shape and out.tobytes() == a.tobytes()


@pytest.mark.parametrize("layout", ["reference", "native"])
@pytest.mark.parametrize("dtype", ["uint8", "float32", "int64"])
def test_each_package_decodes_the_others_blobs(layout, dtype):
    a = _mostly_zero(dtype, seed=3).astype(dtype)
    jax_blob = jsparse.sparse_encode(a, layout=layout)
    port_blob = sparse_encode(a, layout=layout)
    port_out, port_end = sparse_decode(jax_blob)
    jax_out, jax_end = jsparse.sparse_decode(port_blob)
    assert port_out.tobytes() == jax_out.tobytes() == a.tobytes()
    assert port_end == jax_end == len(jax_blob)


def test_decode_at_an_offset_as_jax():
    a = _mostly_zero("float32").astype(np.float32)
    blob = b"\x00" * 13 + sparse_encode(a, layout="reference")
    out, end = sparse_decode(blob, offset=13)
    jout, jend = jsparse.sparse_decode(blob, offset=13)
    assert out.tobytes() == jout.tobytes() and end == jend == len(blob)


@pytest.mark.parametrize("blob", [
    b"\x01\x02\x03",
    b"",
    b"\xff" * 200,
], ids=["short", "empty", "ff"])
def test_garbage_refused(blob):
    """tests/test_negative.py's garbage case, and two more: both
    packages refuse with ValueError or IndexError."""
    with pytest.raises((ValueError, IndexError)):
        sparse_decode(blob)
    with pytest.raises((ValueError, IndexError)):
        jsparse.sparse_decode(blob)


@pytest.mark.parametrize("layout", ["reference", "native"])
def test_truncated_payload_refused_as_jax(layout):
    a = _mostly_zero("float32").astype(np.float32)
    blob = sparse_encode(a, layout=layout)[:-3]
    with pytest.raises(ValueError, match="truncated") as port_err:
        sparse_decode(blob)
    with pytest.raises(ValueError, match="truncated") as jax_err:
        jsparse.sparse_decode(blob)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("layout", ["reference", "native"])
def test_index_past_the_dense_size_refused(layout):
    a = np.zeros((2, 2), np.float32)
    a[1, 1] = 5.0
    blob = bytearray(sparse_encode(a, layout=layout))
    # the one index sits last in the reference layout, first after the
    # header in the native one
    at = len(blob) - 4 if layout == "reference" else \
        jnt.tensors.meta.HEADER_SIZE
    blob[at:at + 4] = (9).to_bytes(4, "little")
    with pytest.raises(ValueError, match="outside"):
        sparse_decode(bytes(blob))
    with pytest.raises(ValueError, match="outside"):
        jsparse.sparse_decode(bytes(blob))


def test_not_a_sparse_payload_refused():
    from nnstreamer_tpu_torch.tensors.meta import pack_tensor

    blob = pack_tensor(np.ones(4, np.float32), layout="reference")
    with pytest.raises(ValueError, match="not a sparse payload"):
        sparse_decode(blob)
    with pytest.raises(ValueError, match="not a sparse payload"):
        jsparse.sparse_decode(blob)


@pytest.mark.parametrize("layout", ["reference", "native"])
def test_element_pair_on_ball_frames_matches_jax(cpu_device, layout):
    """tensor_sparse_enc ! tensor_sparse_dec on the golden string's
    mostly-zero frames: the encoded blobs and the decoded frames equal
    the JAX package's, and the frames come back unchanged."""
    src = ("videotestsrc num-buffers=4 width=16 height=16 pattern=ball ! "
           "tensor_converter ! ")
    got = {}
    for tag, pkg in (("jax", jnt), ("port", tnt)):
        pipe = pkg.parse_launch(
            src + "tee name=t  t. ! tensor_sink name=dense  "
            f"t. ! tensor_sparse_enc layout={layout} ! tee name=e  "
            "e. ! tensor_sink name=blobs  "
            "e. ! tensor_sparse_dec ! tensor_sink name=out")
        msg = pipe.run(timeout=60)
        assert msg is not None and msg.kind == "eos", msg
        got[tag] = {name: [np.asarray(b[0]).tobytes()
                           for b in pipe.get(name).buffers]
                    for name in ("dense", "blobs", "out")}
    assert got["port"] == got["jax"]
    assert got["port"]["out"] == got["port"]["dense"]
    assert all(len(b) < len(d) for b, d in zip(got["port"]["blobs"],
                                               got["port"]["dense"]))
