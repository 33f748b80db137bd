"""Kernel B1 (the normalize chain) in the PyTorch port, held to the JAX
package.

On the CPU the port's wrapper runs its plain version; the JAX side runs the
Pallas kernel in interpret mode, as ``tests/test_ops.py`` runs it. The CUDA
kernel itself is held to the plain version on the card by
``chip_smoke.py`` and by the ``gpu``-marked test at the end of this file.
"""

import ctypes
import math
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.elements.transform import _TransformSpec as JaxSpec
from nnstreamer_tpu.ops import normalize_u8 as jax_normalize_u8
from nnstreamer_tpu_torch.elements import transform as port_transform
from nnstreamer_tpu_torch.elements.transform import _TransformSpec, kernel_chain
from nnstreamer_tpu_torch.ops import _build
from nnstreamer_tpu_torch.ops import preprocess as pp

FLAGSHIP = "typecast:float32,add:-127.5,div:127.5"


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 unit in the last place at each value of ``x``
    (8 significant bits)."""
    mag = np.maximum(np.abs(x.astype(np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _inputs(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return (rng.standard_normal(shape) * 200.0).astype(np.float32)


@pytest.mark.parametrize("in_dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shape", [(224, 224, 3), (2, 17, 5), (15,)])
def test_normalize_u8_f32_matches_pallas(in_dtype, shape):
    x = _inputs(in_dtype, shape, seed=0)
    ref = np.asarray(jax_normalize_u8(jnp.asarray(x), 127.5, 1 / 127.5,
                                      jnp.float32, force="pallas"))
    out = pp.normalize_u8(torch.from_numpy(x), 127.5, 1 / 127.5,
                          torch.float32)
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    # per-op rounding may differ from XLA's by an ulp
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)


@pytest.mark.parametrize("in_dtype", [np.uint8, np.float32])
def test_normalize_u8_bf16_matches_pallas(in_dtype):
    x = _inputs(in_dtype, (10, 30), seed=1)
    ref = np.asarray(jax_normalize_u8(jnp.asarray(x), force="pallas")
                     .astype(jnp.float32))
    out = pp.normalize_u8(torch.from_numpy(x))  # default: bfloat16 out
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (10, 30)
    diff = np.abs(out.float().numpy().astype(np.float64) - ref)
    assert np.all(diff <= _bf16_ulp(ref)), diff.max()


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_transform_chain_matches_jax_transform(dtype):
    x = _inputs(dtype, (1, 24, 24, 3), seed=2)
    ref = np.asarray(JaxSpec("arithmetic", FLAGSHIP, True)(jnp.asarray(x)))
    spec = _TransformSpec("arithmetic", FLAGSHIP)
    assert spec.chain == ([("add", -127.5), ("div", 127.5)], torch.float32)
    out = spec(torch.from_numpy(x))  # the kernel path's plain version
    assert out.dtype == torch.float32 and tuple(out.shape) == x.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)
    # the torch-ops form of the same transform agrees too
    np.testing.assert_allclose(spec.apply(torch.from_numpy(x)).numpy(),
                               ref, rtol=1e-6)


@pytest.mark.parametrize("option,expected", [
    (FLAGSHIP, ([("add", -127.5), ("div", 127.5)], torch.float32)),
    ("typecast:float32,sub:127.5,mul:0.5,typecast:bfloat16",
     ([("sub", 127.5), ("mul", 0.5)], torch.bfloat16)),
    ("typecast:float32,mul:2,typecast:float16",
     ([("mul", 2.0)], torch.float16)),
    ("typecast:float32", ([], torch.float32)),
    ("typecast:float32," + ",".join(["add:1"] * 8),
     ([("add", 1.0)] * 8, torch.float32)),
    ("typecast:float32," + ",".join(["add:1"] * 9), None),
    ("add:-127.5,div:127.5", None),
    ("typecast:float16,add:1", None),
    ("typecast:float32,add:1,typecast:int32", None),
    ("typecast:float32,add:1,typecast:bfloat16,add:1", None),
    ("typecast:float32,typecast:bfloat16,typecast:float16", None),
])
def test_kernel_chain_selector(option, expected):
    assert kernel_chain("arithmetic", option) == expected


@pytest.mark.parametrize("mode,option", [
    ("typecast", "float32"), ("clamp", "0:1"), ("transpose", "1:0:2:3"),
])
def test_kernel_chain_selector_other_modes(mode, option):
    assert kernel_chain(mode, option) is None


@pytest.mark.parametrize("np_dtype,kernel", [
    (np.uint8, True), (np.float32, True), (np.int16, True),
    (np.float64, True), (np.int64, True), (np.float16, True),
])
def test_transform_routes_only_kernel_inputs(monkeypatch, np_dtype, kernel):
    calls = []
    real = port_transform.normalize_chain

    def spy(x, ops, out_dtype):
        calls.append(x.dtype)
        return real(x, ops, out_dtype)

    monkeypatch.setattr(port_transform, "normalize_chain", spy)
    x = torch.from_numpy(np.arange(12).astype(np_dtype).reshape(3, 4))
    out = _TransformSpec("arithmetic", FLAGSHIP)(x)
    assert out.dtype == torch.float32
    assert calls == ([x.dtype] if kernel else [])
    np.testing.assert_allclose(out.numpy(),
                               (np.arange(12.0).reshape(3, 4) - 127.5)
                               / 127.5, rtol=1e-6)


#: every input type but uint8 and float32, as numpy holds them (bfloat16
#: as its float32 values): values each type holds exactly, int64 within
#: int32 (JAX without x64 takes int64 as int32)
_ANY_TYPES = {
    "int8": (np.int8, -128, 128), "int16": (np.int16, -2 ** 15, 2 ** 15),
    "int32": (np.int32, -2 ** 31, 2 ** 31 - 1),
    "int64": (np.int64, -2 ** 31, 2 ** 31 - 1),
    "uint16": (np.uint16, 0, 2 ** 16), "float16": (np.float16, -300, 300),
    "bfloat16": (np.float32, -300, 300), "float64": (np.float64, -1e6, 1e6),
}


def _any_input(name, shape, seed):
    np_dtype, lo, hi = _ANY_TYPES[name]
    rng = np.random.default_rng(seed)
    if np.issubdtype(np_dtype, np.integer):
        return rng.integers(lo, hi, shape, dtype=np.int64).astype(np_dtype)
    x = rng.uniform(lo, hi, shape)
    if name == "bfloat16":  # integers: exact in bfloat16 below 256
        return np.round(x / 4).astype(np.float32)
    return x.astype(np_dtype)


@pytest.mark.parametrize("name", sorted(_ANY_TYPES))
def test_normalize_u8_takes_any_input_type_as_jax(name):
    """ROADMAP.md C.8: every numeric input type is cast to float32 first,
    as the JAX function casts it (here on the CPU, the plain version)."""
    x = _any_input(name, (3, 50, 7), seed=5)
    jx = jnp.asarray(x, jnp.bfloat16) if name == "bfloat16" \
        else jnp.asarray(x)
    tx = torch.from_numpy(x)
    if name == "bfloat16":
        tx = tx.to(torch.bfloat16)
    assert tx.dtype in pp.IN_CODES
    for out_dtype, jdt in ((torch.float32, jnp.float32),
                           (torch.bfloat16, jnp.bfloat16)):
        ref = np.asarray(jax_normalize_u8(jx, 127.5, 1 / 127.5, jdt)
                         .astype(jnp.float32))
        out = pp.normalize_u8(tx, 127.5, 1 / 127.5, out_dtype)
        assert out.dtype == out_dtype and tuple(out.shape) == x.shape
        got = out.float().numpy()
        if out_dtype == torch.float32:
            np.testing.assert_allclose(got, ref, rtol=1e-6)
        else:
            diff = np.abs(got.astype(np.float64) - ref)
            assert np.all(diff <= _bf16_ulp(ref)), diff.max()


def test_normalize_u8_force():
    x = torch.from_numpy(_inputs(np.uint8, (4, 9), seed=6))
    assert torch.equal(pp.normalize_u8(x, force="reference"),
                       pp.normalize_u8(x))
    assert torch.equal(pp.normalize_u8(x, force="reference"),
                       pp.normalize_chain_reference(
                           x, [("sub", 127.5), ("mul", 1 / 127.5)],
                           torch.bfloat16))
    for bad in ("pallas", "kernel"):
        with pytest.raises(ValueError, match="C.6, C.8"):
            pp.normalize_u8(x, force=bad)


def test_out_info_follows_the_trailing_typecast():
    from nnstreamer_tpu_torch.tensors.types import TensorInfo, TensorType

    spec = _TransformSpec("arithmetic", FLAGSHIP + ",typecast:bfloat16")
    info = spec.out_info(TensorInfo(dim=(3, 8, 8, 1), type=TensorType.UINT8))
    assert info.dim == (3, 8, 8, 1) and info.type is TensorType.BFLOAT16


def test_chain_wrapper_rejects_what_it_cannot_run():
    x = torch.zeros(4, dtype=torch.uint8)
    with pytest.raises(ValueError, match="at most 8"):
        pp.normalize_chain(x, [("add", 1.0)] * 9)
    with pytest.raises(ValueError, match="unknown op"):
        pp.normalize_chain(x, [("pow", 2.0)])
    with pytest.raises(ValueError, match="no kernel for device"):
        pp.normalize_chain(x.to("meta"), [("add", 1.0)])


def test_plain_chain_divides_exactly():
    # IEEE division, not a multiply by the reciprocal: 3 / 3 stays 1
    x = torch.full((5,), 3.0)
    out = pp.normalize_chain_reference(x, [("div", 3.0)], torch.float32)
    assert torch.equal(out, torch.ones(5))
    # one rounding to bfloat16, at the end of the chain: 1 + 3 * 2**-8 is
    # 1.5 bfloat16 ulps above 1 and rounds to 1 + 2**-6, where rounding
    # after every add would stay at 1
    y = pp.normalize_chain_reference(torch.tensor([1.0]),
                                     [("add", 2.0 ** -8)] * 3,
                                     torch.bfloat16)
    assert y.float().item() == 1.0 + 2.0 ** -6


FRAME = 224 * 224 * 3
#: the most elements the plan gives 4 at a time on an H100's 132 SMs
SWITCH = int(4 * 256 * 8 * 132 * pp.PASSES_OF_4_MAX)


def test_plan_fills_the_card_at_the_frame():
    plan = pp.normalize_plan(FRAME, True, 132)
    assert plan.ept == 4 and plan.threads == 256
    assert plan.blocks >= 132


@pytest.mark.parametrize("n,aligned,per_thread", [
    (FRAME, True, 4), (8 * FRAME, True, 4), (10 ** 6 + 3, True, 4),
    (SWITCH + 3, True, 4), (SWITCH + 4, True, 16), (17, True, 4),
    (4096 * 4096, True, 16),
    (FRAME, False, 1), (17, False, 1),
])
def test_plan_picks_elements_per_thread(n, aligned, per_thread):
    plan = pp.normalize_plan(n, aligned, 132)
    assert plan.ept == per_thread
    assert 1 <= plan.blocks <= 132 * pp.WAVE_BLOCKS_PER_SM


def _coverage(plan, n):
    """How often each element is written by the kernel's loops for this
    plan: vectors of ept elements over a grid-stride loop, then the rest
    one by one over the same loop (csrc/normalize.cu)."""
    counts = np.zeros(n, np.uint8)
    stride = plan.blocks * plan.threads
    tids = np.arange(stride, dtype=np.int64)
    nvec = n // plan.ept
    for k in range(-(-nvec // stride)):
        v = tids + k * stride
        v = v[v < nvec]
        for j in range(plan.ept):
            counts[plan.ept * v + j] += 1
    if plan.ept > 1:
        for k in range(-(-(n - plan.ept * nvec) // stride)):
            i = plan.ept * nvec + tids + k * stride
            counts[i[i < n]] += 1
    return counts


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n,aligned", [
    (n, True) for n in (1, 3, 15, 17, 4099, FRAME, 2 ** 20 + 3, SWITCH,
                        SWITCH + 17, 4096 * 4096)
] + [(n, False) for n in (1, 3, 17, 4099, FRAME)])
def test_plan_covers_every_element_once(n, aligned, sms):
    counts = _coverage(pp.normalize_plan(n, aligned, sms), n)
    assert counts.min() == 1 and counts.max() == 1


@pytest.mark.parametrize("ops", [
    [("add", -127.5), ("div", 127.5)], [("sub", 127.5), ("mul", 1 / 127.5)],
    [("mul", 2.0)], [], [("add", 1.0)] * 8,
])
def test_cached_chain_equals_a_fresh_one(ops):
    cached, addr = pp._cached_chain(tuple(ops))
    fresh = pp.build_chain(ops)
    assert cached.n == fresh.n == len(ops)
    assert list(cached.op) == list(fresh.op)
    assert list(cached.val) == list(fresh.val)
    assert addr == ctypes.addressof(cached)
    # a second call takes the cached struct: the chain is not rebuilt
    again, addr2 = pp._cached_chain(tuple(ops))
    assert again is cached and addr2 == addr


def test_cached_chain_keeps_signed_zeros_apart():
    """0.0 and -0.0 are equal and hash alike, but dividing by them gives
    +inf and -inf: each gets a struct of its own, with its sign."""
    pos, _ = pp._cached_chain([("div", 0.0)])
    neg, _ = pp._cached_chain([("div", -0.0)])
    assert pos is not neg
    assert math.copysign(1.0, pos.val[0]) == 1.0
    assert math.copysign(1.0, neg.val[0]) == -1.0
    # the plain version the kernel is held to tells them apart
    y = pp.normalize_chain_reference(torch.ones(2), [("div", -0.0)],
                                     torch.float32)
    assert torch.equal(y, torch.full((2,), -math.inf))


def test_cached_chain_takes_lists_and_numpy_values():
    chain, addr = pp._cached_chain([["add", np.float32(-127.5)],
                                    ["div", 127.5]])
    again, addr2 = pp._cached_chain((("add", -127.5), ("div", 127.5)))
    assert again is chain and addr2 == addr
    assert list(chain.val)[:2] == [-127.5, 127.5]


def test_cached_chain_checks_once_and_refuses_bad_ops():
    with pytest.raises(ValueError, match="unknown op"):
        pp._cached_chain((("pow", 2.0),))
    with pytest.raises(ValueError, match="at most 8"):
        pp._cached_chain((("add", 1.0),) * 9)


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


def test_entry_point_declares_the_c_parameters(monkeypatch):
    """The ctypes declaration follows csrc/normalize.cu: a missing or
    extra argument would shift every later one at the launch."""
    monkeypatch.setattr(_build, "load", lambda _: types.SimpleNamespace(
        nns_normalize_chain=types.SimpleNamespace()))
    assert _declared_like_c(pp._kernel_entry.__wrapped__(), "normalize.cu",
                            "nns_normalize_chain")


@pytest.mark.gpu
def test_kernel_bit_identical_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator().manual_seed(0)
    switch = int(4 * 256 * 8 * pp.PASSES_OF_4_MAX *
                 torch.cuda.get_device_properties(0).multi_processor_count)
    for n in (1, 17, 224 * 224 * 3, 10 ** 6 + 3, switch, switch + 17):
        for offset in (0, 1):
            base = torch.randint(0, 256, (n + offset,), generator=gen,
                                 dtype=torch.uint8).cuda()
            x = base[offset:]
            for out_dtype in (torch.float32, torch.bfloat16, torch.float16):
                for ops in ([("add", -127.5), ("div", 127.5)],
                            [("sub", 127.5), ("mul", 1 / 127.5)]):
                    y = pp.normalize_chain(x, ops, out_dtype)
                    ref = pp.normalize_chain_reference(x, ops, out_dtype)
                    assert torch.equal(y, ref)
    # signed zeros: each chain takes its own struct from the cache, and
    # x / -0.0 gives -inf where x / 0.0 gives +inf (x > 0: no NaN)
    x = torch.randint(1, 256, (4099,), generator=gen,
                      dtype=torch.uint8).cuda()
    for ops in ([("div", 0.0)], [("div", -0.0)], [("mul", -0.0)],
                [("add", -0.0), ("mul", -1.0)]):
        y = pp.normalize_chain(x, ops, torch.float32)
        ref = pp.normalize_chain_reference(x, ops, torch.float32)
        assert torch.equal(y.view(torch.int32), ref.view(torch.int32)), ops


@pytest.mark.gpu
def test_kernel_takes_every_input_type_on_the_card():
    """C.8 on the card: each input type through the kernel equals the
    plain version's conversion and chain, on both sides of the plan's
    switch and on a misaligned view."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gen = torch.Generator().manual_seed(1)
    switch = int(4 * 256 * 8 * pp.PASSES_OF_4_MAX *
                 torch.cuda.get_device_properties(0).multi_processor_count)
    ops = [("sub", 127.5), ("mul", 1 / 127.5)]
    for dtype in pp.IN_CODES:
        for n in (17, 224 * 224 * 3, switch + 17):
            for offset in (0, 1):
                if dtype.is_floating_point:
                    base = torch.randn(n + offset, generator=gen,
                                       dtype=torch.float64) * 1e4
                else:
                    base = torch.randint(-2 ** 40, 2 ** 40, (n + offset,),
                                         generator=gen, dtype=torch.int64)
                base = base.to(dtype) if dtype is not torch.bool \
                    else base > 0
                x = base.cuda()[offset:]
                for out_dtype in pp.OUT_CODES:
                    y = pp.normalize_chain(x, ops, out_dtype)
                    ref = pp.normalize_chain_reference(x.cpu(), ops,
                                                       out_dtype)
                    assert torch.equal(y.cpu(), ref), (dtype, n, offset)
