"""Kernel B3 (int8 quantize) in the PyTorch port, held to the JAX package.

On the CPU the port's wrapper runs its plain versions; the JAX side runs
its reference path, and its Pallas kernel in interpret mode with the
dither streamed in, as ``tests/test_ops.py`` runs it. The nearest path and
the shared-dither rounding are bit-identical; the two dithered functions
use different random bits (Philox here, the TPU's PRNG or ``jax.random``
there) and are held to the same error bound and the same mean. The CUDA
kernel is held to the plain versions on the card by ``chip_smoke.py`` and
by the ``gpu``-marked test at the end of this file.
"""

import ctypes
import re
import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from nnstreamer_tpu.ops import quantize as jq
from nnstreamer_tpu_torch.ops import LAUNCHES, _build, reset_launches
from nnstreamer_tpu_torch.ops import quantize as qz

#: numpy dtype of the JAX input → torch dtype of the port's input
DTYPES = {
    np.float32: torch.float32, np.float64: torch.float64,
    np.float16: torch.float16, ml_dtypes.bfloat16: torch.bfloat16,
    np.uint8: torch.uint8, np.int8: torch.int8, np.int16: torch.int16,
    np.int32: torch.int32, np.int64: torch.int64,
}
#: the bound of tests/test_ops.py:89 for the dithered path
DITHER_ERR_MAX = 1.01


def _inputs(np_dtype, shape, seed):
    """Seeded numpy input and the same values as a torch tensor."""
    rng = np.random.default_rng(seed)
    if np.dtype(np_dtype).kind in "iu":
        info = np.iinfo(np_dtype)
        x = rng.integers(info.min, info.max, shape, dtype=np_dtype,
                         endpoint=True)
        return x, torch.from_numpy(x)
    x = (rng.standard_normal(shape) * 200.0).astype(np.float32)
    x = x.astype(np_dtype)
    t = torch.from_numpy(x.astype(np.float32)).to(DTYPES[np_dtype])
    return x, t


@pytest.mark.parametrize("np_dtype", list(DTYPES), ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", [(224, 224, 3), (2, 17, 5), (1,), (1001,)])
def test_nearest_matches_jax_reference(np_dtype, shape):
    x, t = _inputs(np_dtype, shape, seed=len(shape) + 7)
    jq_, js = jq.quantize_int8(x, force="reference")
    q, s = qz.quantize_int8(t, force="reference")
    assert q.dtype == torch.int8 and q.shape == t.shape
    assert s.dtype == torch.float32 and s.shape == (1,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    assert s.numpy().tobytes() == np.asarray(js, np.float32).tobytes()


NON_FINITE = {
    "nan": [1.5, np.nan, -3.0, 2.0, 0.25],
    "inf": [1.5, np.inf, -3.0, 2.0, 0.25],
    "minus_inf": [1.5, -np.inf, -3.0, 2.0, 0.25],
    "nan_and_inf": [np.inf, 1.5, np.nan, -np.inf, 0.25],
}


@pytest.mark.parametrize("case", list(NON_FINITE))
def test_non_finite_input_matches_jax(case):
    """A NaN in x makes the scale NaN and every q 0; an inf makes the
    scale inf and the finite elements' q 0 — as the JAX reference gives
    them. The dithered path gives the same q."""
    x = np.asarray(NON_FINITE[case], np.float32)
    jq_, js = jq.quantize_int8(jnp.asarray(x), force="reference")
    q, s = qz.quantize_int8(torch.from_numpy(x), force="reference")
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js, np.float32))
    assert not q.any()
    qd, sd = qz.quantize_int8(torch.from_numpy(x), seed=3, force="dither")
    assert torch.equal(qd, q)
    np.testing.assert_array_equal(sd.numpy(), s.numpy())


def test_default_on_the_cpu_is_nearest():
    x, t = _inputs(np.float32, (64, 128), seed=1)
    q, s = qz.quantize_int8(t)
    jq_, js = jq.quantize_int8(jnp.asarray(x))  # the JAX CPU default
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    assert float(s[0]) == float(js[0])


def test_round_dithered_matches_jax():
    rng = np.random.default_rng(5)
    scaled = rng.uniform(-130.0, 130.0, 4096).astype(np.float32)
    dither = rng.uniform(-0.5, 0.5, 4096).astype(np.float32)
    # exact ties: k + 0.25 + 0.25 lands on k.5 — round half to even
    scaled[:256] = np.arange(-128, 128, dtype=np.float32) + 0.25
    dither[:256] = 0.25
    got = qz._round_dithered(torch.from_numpy(scaled),
                             torch.from_numpy(dither))
    want = jq._round_dithered(jnp.asarray(scaled), jnp.asarray(dither))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dither_error_bound_port_and_pallas():
    """The dithered functions of both packages stay within 1.01 × scale
    of the input (tests/test_ops.py:81-89)."""
    rng = np.random.default_rng(2)
    x = (rng.normal(scale=3.0, size=(64, 128))).astype(np.float32)
    for seed in (0, 1, 77):
        q, s = qz.quantize_int8(torch.from_numpy(x), seed=seed,
                                force="dither")
        err = (qz.dequantize_int8(q, s) - torch.from_numpy(x)).abs().max()
        assert float(err) <= float(s[0]) * DITHER_ERR_MAX
        jq_, js = jq.quantize_int8(jnp.asarray(x), seed=seed, force="pallas")
        jerr = np.abs(np.asarray(jq.dequantize_int8(jq_, js)) - x).max()
        assert jerr <= float(js[0]) * DITHER_ERR_MAX


@pytest.mark.parametrize("seed", [0, 3])
def test_dither_is_unbiased_in_both_packages(seed):
    """0.3 of a step: nearest rounds every element to 0; the dithered
    functions average 0.3."""
    n = 65536
    x = np.full(n + 1, 0.003, np.float32)
    x[0] = 1.27  # sets the scale to 0.01
    q, _ = qz.quantize_int8(torch.from_numpy(x), seed=seed, force="dither")
    assert abs(float(q[1:].double().mean()) - 0.3) <= 0.01
    jq_, _ = jq.quantize_int8(jnp.asarray(x), seed=seed, force="pallas")
    assert abs(float(np.asarray(jq_)[1:].mean()) - 0.3) <= 0.01
    qn, _ = qz.quantize_int8(torch.from_numpy(x), force="reference")
    assert int(qn[1:].abs().sum()) == 0


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    zero = torch.zeros(1, dtype=torch.int64)
    ones = torch.full((1,), 0xFFFFFFFF, dtype=torch.int64)
    got = qz.philox4x32_10((zero,) * 4, (0, 0))
    assert [int(w) for w in got] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                     0x9B00DBD8]
    got = qz.philox4x32_10((ones,) * 4, (0xFFFFFFFF, 0xFFFFFFFF))
    assert [int(w) for w in got] == [0x408F276D, 0x41C83B0E, 0xA20BC7C6,
                                     0x6D5451FD]


def test_dither_bits_follow_the_element_index():
    """Element i takes word i % 4 of Philox at counter i // 4, with the
    64-bit seed split into the key: the same words whatever the length."""
    seed = (7 << 32) | 9
    bits = qz.dither_bits(10, seed, "cpu")
    for i in (0, 3, 4, 9):
        g = torch.tensor([i // 4], dtype=torch.int64)
        zero = torch.zeros_like(g)
        words = qz.philox4x32_10((g, zero, zero, zero), (9, 7))
        assert int(bits[i]) == int(words[i % 4])
    assert torch.equal(qz.dither_bits(10, seed, "cpu"),
                       qz.dither_bits(13, seed, "cpu")[:10])
    values = qz.dither_values(4096, 5, "cpu")
    assert float(values.min()) >= -0.5 and float(values.max()) <= 0.5


def test_dither_depends_on_the_seed_only():
    x = torch.from_numpy(np.linspace(-3, 3, 999).astype(np.float32))
    a, _ = qz.quantize_int8(x, seed=11, force="dither")
    b, _ = qz.quantize_int8(x, seed=11, force="dither")
    c, _ = qz.quantize_int8(x, seed=12, force="dither")
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_empty_input_and_bad_force():
    reset_launches()
    q, s = qz.quantize_int8(torch.empty(0, 3))
    assert q.shape == (0, 3) and q.dtype == torch.int8
    assert s.numpy().tobytes() == np.float32(1e-30).tobytes()
    assert LAUNCHES["quantize_int8"] == 0  # the CPU never counts a launch
    with pytest.raises(ValueError, match="force"):
        qz.quantize_int8(torch.ones(3), force="pallas")


FRAME = 224 * 224 * 3
#: what the kernel keeps on chip on an H100's 132 SMs, in f32
ON_CHIP_F32 = 132 * qz.kept_per_block(4)


def test_plan_frame_fills_the_card_with_x_on_chip():
    plan = qz.quantize_plan(FRAME, 4)
    assert 128 <= plan.blocks <= 132
    assert plan.kept == plan.chunk  # x staged whole: read from HBM once
    assert plan.smem <= qz.SMEM_MAX


@pytest.mark.parametrize("n,size,kept_all", [
    (FRAME, 4, True), (FRAME, 8, True), (FRAME, 1, True),
    (ON_CHIP_F32, 4, True), (ON_CHIP_F32 + 16, 4, False),
    # by bytes, not elements: f32's capacity is past f64's and inside u8's
    (ON_CHIP_F32, 8, False), (ON_CHIP_F32, 1, True), (ON_CHIP_F32, 2, True),
    (132 * qz.kept_per_block(8), 8, True),
    (132 * qz.kept_per_block(1) + 16, 1, False),
    (2 ** 20 + 3, 4, True), (4096 * 4096, 4, False), (1, 4, True),
])
def test_plan_keeps_x_on_chip_by_bytes(n, size, kept_all):
    plan = qz.quantize_plan(n, size)
    assert plan.kept == (plan.chunk if kept_all else 0)


def test_plan_follows_the_dtype_size():
    """The device plan takes the dtype's element size: int64 and float64
    take twice the room of float32."""
    sizes = {d: torch.empty((), dtype=d).element_size() for d in qz.IN_CODES}
    assert sizes[torch.float64] == sizes[torch.int64] == 8
    kept = {d: qz.quantize_plan(ON_CHIP_F32, sizes[d]).kept > 0
            for d in qz.IN_CODES}
    assert kept[torch.float32] and kept[torch.int32]
    assert not kept[torch.float64] and not kept[torch.int64]
    assert kept[torch.uint8] and kept[torch.bfloat16]


@pytest.mark.parametrize("n,kept_all", [
    (2 ** 20 + 3, True), (ON_CHIP_F32, True), (ON_CHIP_F32 + 16, False),
    (4096 * 4096, False),
])
def test_plan_keeps_whole_slices_or_none(n, kept_all):
    """While every slice fits in shared memory x is kept on chip and read
    from HBM once; past that none of it is kept, x is read twice, and a
    block runs more threads to keep more loads in flight."""
    plan = qz.quantize_plan(n, 4)
    assert plan.kept == (plan.chunk if kept_all else 0)
    assert plan.kept <= qz.kept_per_block(4)
    assert plan.threads == (qz.THREADS if kept_all
                            else qz.THREADS_READ_TWICE)


@pytest.mark.parametrize("sms,smem_max", [(132, qz.SMEM_MAX),
                                          (114, 100 * 1024)])
@pytest.mark.parametrize("size", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1, 3, 15, 17, 4099, 16368, 16400, FRAME,
                               2 ** 20 + 3, "on-chip-16", "on-chip+16",
                               4096 * 4096])
def test_plan_slices_cover_every_element_once(n, size, sms, smem_max):
    on_chip = sms * qz.kept_per_block(size, smem_max)
    n = {"on-chip-16": on_chip - 16, "on-chip+16": on_chip + 16}.get(n, n)
    plan = qz.quantize_plan(n, size, sms, smem_max)
    slices = qz.block_slices(plan, n)
    assert len(slices) == plan.blocks <= sms
    end = 0
    for start, kept_end, stop in slices:
        assert start == end and start % 16 == 0  # 16-byte aligned slices
        assert start < stop and start <= kept_end <= stop
        assert kept_end == stop or (kept_end - start) % 16 == 0
        end = stop
    assert end == n
    # a block's shared memory holds what it keeps, shifted by at most 15
    # bytes to align the bulk copy of a misaligned view
    assert plan.kept * size + 15 < plan.smem <= smem_max
    assert plan.buffer >= qz.Q_OFFSET + n + 4 * plan.blocks
    assert plan.threads in (qz.THREADS, qz.THREADS_READ_TWICE)


_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "unsigned long long": ctypes.c_ulonglong}


def _declared_like_c(fn, source, name):
    """Whether ``fn.argtypes`` match the parameters of the C entry point
    ``name`` in ``csrc/<source>``, one by one (a pointer as any pointer
    type)."""
    text = (_build.SRC_DIR / source).read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', text).group(1)
    want = []
    for param in params.split(","):
        ctype = " ".join(param.replace("const", "").split()[:-1])
        want.append("ptr" if "*" in param else _C_TYPES[ctype])
    got = ["ptr" if t is ctypes.c_void_p or hasattr(t, "contents") else t
           for t in fn.argtypes]
    return got == want


@pytest.mark.parametrize("name", ["nns_quantize_prepare",
                                  "nns_quantize_int8"])
def test_entry_points_declare_the_c_parameters(monkeypatch, name):
    """The ctypes declarations follow csrc/quantize.cu: a missing or
    extra argument would shift every later one at the launch."""
    monkeypatch.setattr(_build, "load", lambda _: types.SimpleNamespace(
        **{name: types.SimpleNamespace()}))
    entry = {"nns_quantize_prepare": qz._prepare_entry,
             "nns_quantize_int8": qz._kernel_entry}[name]
    assert _declared_like_c(entry.__wrapped__(), "quantize.cu", name)


@pytest.mark.gpu
def test_kernel_matches_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    for np_dtype, dtype in DTYPES.items():
        x, t = _inputs(np_dtype, (3, 1001), seed=4)
        t = t.to("cuda:0")
        reset_launches()
        q, s = qz.quantize_int8(t, force="reference")
        rq, rs = qz.quantize_nearest_reference(t)
        assert LAUNCHES["quantize_int8"] == 1
        assert torch.equal(q, rq) and torch.equal(s, rs)
        q, _ = qz.quantize_int8(t, seed=9, force="dither")
        rq, _ = qz.quantize_dither_reference(t, 9)
        assert torch.equal(q, rq), dtype
    # either side of the on-chip capacity, and a misaligned view past it
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.float64):
        cap = sms * qz.kept_per_block(
            torch.empty((), dtype=dtype).element_size())
        for n in (cap - 16, cap, cap + 16):
            t = torch.randn(n, dtype=dtype, device="cuda:0") * 50
            q, s = qz.quantize_int8(t, force="reference")
            rq, rs = qz.quantize_nearest_reference(t)
            assert torch.equal(q, rq) and torch.equal(s, rs), (dtype, n)
            q, _ = qz.quantize_int8(t, seed=9, force="dither")
            assert torch.equal(q, qz.quantize_dither_reference(t, 9)[0])
    over = sms * qz.kept_per_block(4) + 16
    t = (torch.randn(over + 3, device="cuda:0") * 50)[3:]
    q, s = qz.quantize_int8(t, force="reference")
    rq, rs = qz.quantize_nearest_reference(t)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    for values in NON_FINITE.values():
        t = torch.tensor(values, dtype=torch.float32, device="cuda:0")
        for force in ("reference", "dither"):
            q, s = qz.quantize_int8(t, seed=9, force=force)
            rq, rs = qz.quantize_nearest_reference(t.cpu())
            assert torch.equal(q.cpu(), rq)
            assert s.cpu().numpy().tobytes() == rs.numpy().tobytes()
