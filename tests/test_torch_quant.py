"""tensor_quant_enc / tensor_quant_dec in the PyTorch port, held to the
JAX package (``nnstreamer_tpu/elements/quant.py``).

The codec's blobs are byte-identical between the packages for every
dtype, and the port's copies of ``TestQuantEncDec``
(``tests/test_stream_algebra.py:429-553``) run on the port's elements.
The card path (a CUDA payload quantized by kernel B3) is held to the host
encoding by ``chip_smoke.py`` and by the ``gpu``-marked test at the end.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.elements.quant import quant_decode as jax_decode
from nnstreamer_tpu.elements.quant import quant_encode as jax_encode
from nnstreamer_tpu_torch.elements.quant import (
    TensorQuantEnc,
    quant_decode,
    quant_encode,
)
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.elements.source import AppSrc
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensors.meta import pack_tensor

NP_DTYPES = [np.float32, np.float64, np.float16, np.uint8, np.int8,
             np.int16, np.int32, np.int64, np.uint16, np.uint32]


@pytest.fixture
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


def _values(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind in "iu":
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, shape, dtype=dtype,
                            endpoint=True)
    return (rng.standard_normal(shape) * 37.0).astype(dtype)


def _run(description, timeout=60):
    pipe = tnt.parse_launch(description)
    msg = pipe.run(timeout=timeout)
    assert msg is not None and msg.kind == "eos", f"pipeline failed: {msg}"
    return pipe


@pytest.mark.parametrize("dtype", NP_DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", [(4, 5, 3), (1,), (0,), (2, 0, 3)])
def test_blobs_byte_identical_to_jax(dtype, shape):
    x = _values(dtype, shape, seed=sum(shape) + 1)
    blob = quant_encode(x)
    assert blob == jax_encode(x)
    back, end = quant_decode(blob)
    want, jend = jax_decode(blob)
    assert end == jend == len(blob)
    assert back.dtype == want.dtype and back.shape == want.shape
    assert back.tobytes() == np.asarray(want).tobytes()


def test_bfloat16_blob_and_round_trip_match_jax():
    x = (np.random.default_rng(3).standard_normal((6, 7)) * 9).astype(
        np.float32)
    jx = x.astype(ml_dtypes.bfloat16)
    t = torch.from_numpy(jx.astype(np.float32)).to(torch.bfloat16)
    blob = quant_encode(t)
    assert blob == jax_encode(jx)
    back, _ = quant_decode(blob)
    want, _ = jax_decode(blob)
    assert back.dtype == torch.bfloat16 and tuple(back.shape) == want.shape
    assert back.view(torch.int16).numpy().tobytes() == \
        np.asarray(want).view(np.int16).tobytes()


NON_FINITE = {
    "nan": [1.5, np.nan, -3.0, 2.0],
    "inf": [1.5, np.inf, -3.0, 2.0],
    "nan_and_inf": [np.inf, 1.5, np.nan, -np.inf],
}


@pytest.mark.parametrize("case", list(NON_FINITE))
def test_non_finite_blob_matches_jax(case):
    """A NaN or an inf in the payload: the same scale and all-zero q as
    the JAX codec ships."""
    x = np.asarray(NON_FINITE[case], np.float32)
    with np.errstate(invalid="ignore"):
        blob = quant_encode(x)
        assert blob == jax_encode(x)
        assert quant_encode(torch.from_numpy(x)) == blob
    assert blob[-x.size:] == bytes(x.size)


def test_cpu_tensor_encodes_like_its_numpy_values():
    x = _values(np.float32, (3, 8), seed=4)
    assert quant_encode(torch.from_numpy(x)) == quant_encode(x)


def test_roundtrip_accuracy_and_size():
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (64, 32)).astype(np.float32)
    blob = quant_encode(x)
    assert len(blob) < x.nbytes / 2  # ~4x smaller than float32
    back, _ = quant_decode(blob)
    assert back.shape == x.shape and back.dtype == x.dtype
    # absmax int8: error bounded by scale/2
    scale = np.abs(x).max() / 127.0
    assert np.abs(back - x).max() <= scale * 0.5 + 1e-6


def test_pipeline_roundtrip(cpu_device):
    head = ("videotestsrc num-buffers=3 width=8 height=8 pattern=gradient ! "
            "tensor_converter ! tensor_transform mode=arithmetic "
            "option=typecast:float32,div:255 ! ")
    pipe = _run(head + "tensor_quant_enc ! tensor_quant_dec ! "
                "tensor_sink name=out")
    ref = _run(head + "tensor_sink name=out")
    outs = pipe.get("out").buffers
    refs = ref.get("out").buffers
    assert len(outs) == len(refs) == 3
    for o, r in zip(outs, refs):
        a, b = np.asarray(o[0]), np.asarray(r[0])
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= (np.abs(b).max() / 127.0) * 0.5 + 1e-6


def test_offload_with_quant_transport(cpu_device):
    """query offload with int8-compressed payloads: enc on the client,
    dec server-side before the filter."""

    class Plus1(torch.nn.Module):
        def forward(self, x):
            return x + 1.0

    info = tnt.TensorsInfo.from_str("4", "float32")
    register_torch_model("qpass_t", Plus1(), info, info)
    server = tnt.parse_launch(
        "tensor_query_serversrc name=ss port=0 id=41 ! tensor_quant_dec ! "
        "tensor_filter framework=torch model=qpass_t ! "
        "tensor_query_serversink id=41")
    server.start()
    client = None
    try:
        port = server.get("ss").port
        client = tnt.parse_launch(
            f"tensor_quant_enc name=enc ! tensor_query_client name=qc "
            f"dest-host=127.0.0.1 dest-port={port} timeout=10")
        src, sink = AppSrc(name="src"), TensorSink(name="out")
        client.add(src, sink)
        src.link(client.get("enc"))
        client.get("qc").link(sink)
        client.start()
        src.push([np.array([1.0, -2.0, 3.0, 0.5], np.float32)], pts=0)
        src.end_of_stream()
        msg = client.wait(timeout=60)
        assert msg is not None and msg.kind == "eos", msg
        out = np.asarray(sink.buffers[0][0])
        np.testing.assert_allclose(out, [2.0, -1.0, 4.0, 1.5],
                                   atol=3 / 127.0)
    finally:
        if client is not None:
            client.stop()
        server.stop()
        unregister_torch_model("qpass_t")


def test_enc_consumes_deferred_finalize_once():
    """A buffer carrying a deferred finalize (fused-decoder output) must
    have it applied exactly once on its way through the transcoder, never
    leaked downstream. The element's pad entry applies it, as an upstream
    pad's push delivers the buffer."""
    calls = []

    def finalize(host_buf):
        calls.append(1)
        return host_buf.with_tensors([np.asarray(host_buf[0]) * 2.0])

    enc = TensorQuantEnc()
    got = []
    enc.srcpad.push = lambda b: got.append(b)  # capture output
    buf = TensorBuffer([np.ones(4, np.float32)], pts=0, finalize=finalize)
    enc._chain_entry(enc.sinkpads[0], buf)
    assert calls == [1]
    assert got[0].finalize is None  # not leaked downstream
    got[0].to_host()
    assert calls == [1]  # still once
    back, _ = quant_decode(np.asarray(got[0][0]).tobytes())
    np.testing.assert_array_equal(back, np.full(4, 2.0, np.float32))


def test_decode_rejects_non_quant_payload():
    """Mis-wired streams (another flexible payload, truncation) raise,
    not emit garbage."""
    with pytest.raises(ValueError, match="magic"):
        quant_decode(pack_tensor(np.zeros((4, 4), np.float32)))
    blob = quant_encode(np.ones((8,), np.float32))
    with pytest.raises(ValueError, match="truncated"):
        quant_decode(blob[:-3])


def test_integer_roundtrip_rounds_to_nearest():
    x = np.arange(0, 256, 1, dtype=np.uint8)
    back, _ = quant_decode(quant_encode(x))
    assert back.dtype == np.uint8
    scale = 255.0 / 127.0
    # nearest-rounding: error bounded by scale/2 + 0.5 cast rounding
    assert np.abs(back.astype(int) - x.astype(int)).max() <= \
        int(np.ceil(scale / 2 + 0.5))


@pytest.mark.gpu
def test_device_blob_matches_host_blob_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    for dtype in (np.float32, np.float16, np.uint8, np.int64):
        x = _values(dtype, (1, 224, 224, 3), seed=6)
        assert quant_encode(torch.from_numpy(x).to("cuda:0")) == \
            jax_encode(x)
    for values in NON_FINITE.values():
        x = np.asarray(values, np.float32)
        with np.errstate(invalid="ignore"):
            assert quant_encode(torch.from_numpy(x).to("cuda:0")) == \
                jax_encode(x)
