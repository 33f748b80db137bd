"""The kernel wrappers as ``torch.library`` custom ops (ROADMAP C.26,
closed): ``nnstpu::normalize_chain`` (B1), ``nnstpu::flash_attention``
(B2) and ``nnstpu::quantize_int8`` (B3).

On the CPU: each op's schema, its CPU implementation (the wrapper's plain
version, bit for bit), its fake implementation (shapes and types from the
inputs alone, on the meta device), and that an eager wrapper call outside
a trace never goes through the dispatcher. The ``gpu`` tests load an
exported program onto ``cuda:0`` and show that it launches the kernel,
counted in ``LAUNCHES``, with the direct wrapper's bits; and that an input
the kernel does not take raises through the op as through the wrapper,
with no launch and no plain version in its place. This file imports no
JAX, so ``tools/gpu_tests.py`` runs its ``gpu`` tests on the card.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nnstreamer_tpu_torch.filters import artifact
from nnstreamer_tpu_torch.ops import LAUNCHES, reset_launches
from nnstreamer_tpu_torch.ops import flash_attention as fa
from nnstreamer_tpu_torch.ops import preprocess as pp
from nnstreamer_tpu_torch.ops import quantize as qz
from nnstreamer_tpu_torch.ops._counts import tracing

SCHEMAS = {
    "normalize_chain": "nnstpu::normalize_chain(Tensor x, str[] ops, "
                       "float[] values, ScalarType out_dtype) -> Tensor",
    "flash_attention": "nnstpu::flash_attention(Tensor q, Tensor k, "
                       "Tensor v, bool causal) -> Tensor",
    "quantize_int8": "nnstpu::quantize_int8(Tensor x, int seed, str mode) "
                     "-> (Tensor, Tensor)",
}
CHAIN = [("add", -127.5), ("div", 127.5)]


def _frame(seed=0, shape=(1, 8, 8, 3)):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, shape, dtype=np.uint8))


def _qkv(seed=1, shape=(1, 24, 2, 16), dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype) for _ in range(3)]


def _signal(seed=2, n=4099):
    return torch.from_numpy((np.random.default_rng(seed).normal(size=n) *
                             3).astype(np.float32))


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_op_schema(name):
    assert str(getattr(torch.ops.nnstpu, name).default._schema) == \
        SCHEMAS[name]


def test_normalize_op_cpu_is_the_plain_version():
    x = _frame()
    for out_dtype in (torch.float32, torch.bfloat16, torch.float16):
        got = torch.ops.nnstpu.normalize_chain(
            x, [op for op, _ in CHAIN], [v for _, v in CHAIN], out_dtype)
        want = pp.normalize_chain_reference(x, CHAIN, out_dtype)
        assert got.dtype == out_dtype
        assert torch.equal(got, want)


def test_normalize_op_output_is_never_its_input():
    """An empty chain on float32 is the identity: the op returns a copy
    (a custom op's output may not alias its input)."""
    x = torch.arange(4.0)
    y = torch.ops.nnstpu.normalize_chain(x, [], [], torch.float32)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()


@pytest.mark.parametrize("causal", [True, False])
def test_flash_op_cpu_is_the_plain_version(causal):
    q, k, v = _qkv()
    got = torch.ops.nnstpu.flash_attention(q, k, v, causal)
    assert torch.equal(got, fa.attention_reference(q, k, v, causal))


@pytest.mark.parametrize("mode,force", [("auto", None),
                                        ("reference", "reference"),
                                        ("dither", "dither")])
def test_quantize_op_cpu_is_the_plain_version(mode, force):
    x = _signal()
    q, s = torch.ops.nnstpu.quantize_int8(x, 12345, mode)
    wq, ws = qz.quantize_int8(x, seed=12345, force=force)
    assert torch.equal(q, wq) and torch.equal(s, ws)


def test_quantize_op_takes_a_seed_past_int64():
    """The schema's int is signed: ``_seed64`` carries the low 64 bits of
    any seed, and the dithered bits are the wrapper's."""
    x = _signal()
    seed = 2 ** 64 - 3
    q, _ = torch.ops.nnstpu.quantize_int8(x, qz._seed64(seed), "dither")
    assert torch.equal(q, qz.quantize_int8(x, seed, "dither")[0])
    assert qz._seed64(seed) == -3 and qz._seed64(7) == 7


def test_quantize_op_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        torch.ops.nnstpu.quantize_int8(_signal(), 0, "pallas")


def test_fake_implementations_give_shapes_and_types():
    meta = torch.device("meta")
    x = torch.empty((2, 5, 7, 3), dtype=torch.uint8, device=meta)
    y = torch.ops.nnstpu.normalize_chain(x, ["sub", "mul"], [1.0, 2.0],
                                         torch.bfloat16)
    assert (y.device, y.shape, y.dtype) == (meta, x.shape, torch.bfloat16)
    q = torch.empty((1, 64, 8, 64), dtype=torch.bfloat16, device=meta)
    k = torch.empty((1, 80, 8, 64), dtype=torch.bfloat16, device=meta)
    o = torch.ops.nnstpu.flash_attention(q, k, k, False)
    assert (o.shape, o.dtype) == (q.shape, torch.bfloat16)
    qq, s = torch.ops.nnstpu.quantize_int8(x, 0, "auto")
    assert (qq.shape, qq.dtype) == (x.shape, torch.int8)
    assert (tuple(s.shape), s.dtype) == ((1,), torch.float32)


def test_fake_normalize_refuses_an_unknown_op():
    x = torch.empty(4, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unknown op"):
        torch.ops.nnstpu.normalize_chain(x, ["pow"], [2.0], torch.float32)


def _dispatched(fn) -> set:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events() if e.name.startswith("nnstpu::")}


def test_eager_wrappers_do_not_go_through_the_dispatcher():
    """Outside a trace a wrapper keeps its direct call: the profiler sees
    no ``nnstpu`` op (it does see the op when it is called)."""
    x, (q, k, v), s = _frame(), _qkv(), _signal()
    assert not tracing()
    assert _dispatched(lambda: pp.normalize_chain(x, CHAIN)) == set()
    assert _dispatched(lambda: fa.flash_attention(q, k, v)) == set()
    assert _dispatched(lambda: qz.quantize_int8(s)) == set()
    assert _dispatched(lambda: torch.ops.nnstpu.quantize_int8(
        s, 0, "auto")) == {"nnstpu::quantize_int8"}


def test_tracing_is_true_inside_an_export():
    seen = []

    class Spy(torch.nn.Module):
        def forward(self, x):
            seen.append(tracing())
            return x + 1

    torch.export.export(Spy(), (torch.ones(2),))
    assert seen and all(seen)


def test_no_device_but_cpu_and_cuda_has_an_implementation():
    """The ops have a CPU and a CUDA kernel (and the meta device's fake):
    no other dispatch key is registered."""
    for name in SCHEMAS:
        qual = f"nnstpu::{name}"
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(qual, key)
        for key in ("XPU", "MPS", "CompositeImplicitAutograd",
                    "CompositeExplicitAutograd"):
            assert not torch._C._dispatch_has_kernel_for_dispatch_key(
                qual, key), (name, key)


# -- on the card ---------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the ops' CUDA implementations "
                    "launch the hand-written kernels")
    return torch.device("cuda:0")


class _Normalizes(torch.nn.Module):
    def forward(self, x):
        return pp.normalize_chain(x, CHAIN, torch.bfloat16)


class _Attends(torch.nn.Module):
    def forward(self, q, k, v):
        return fa.flash_attention(q, k, v, causal=True)


class _Quantizes(torch.nn.Module):
    def __init__(self, force):
        super().__init__()
        self.force = force

    def forward(self, x):
        return qz.quantize_int8(x, seed=2 ** 40 + 7, force=self.force)


def _loaded(tmp_path, module, example, device):
    """``module`` exported on the CPU, saved, and loaded onto ``device``
    as the torch backend loads a ``.pt2``."""
    path = str(tmp_path / "m.pt2")
    artifact.save_artifact(path, module, example_inputs=example)
    return artifact.artifact_entry(path, device)["module"]


def _outs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _bytes(t):
    """A tensor's bytes (numpy has no bfloat16)."""
    return t.cpu().contiguous().view(torch.uint8).numpy().tobytes()


@pytest.mark.gpu
@pytest.mark.parametrize("name,module,example", [
    ("normalize_chain", _Normalizes(), [_frame(3, (1, 224, 224, 3))]),
    ("flash_attention", _Attends(),
     _qkv(4, (1, 64, 8, 64), torch.bfloat16)),
    ("quantize_int8", _Quantizes(None), [_signal(5, 224 * 224 * 3)]),
    ("quantize_int8", _Quantizes("reference"), [_signal(6, 224 * 224 * 3)]),
], ids=["B1", "B2", "B3-dither", "B3-nearest"])
def test_a_loaded_program_launches_the_kernel(name, module, example,
                                              tmp_path):
    dev = _card()
    prog = _loaded(tmp_path, module, example, dev)
    xs = [t.to(dev) for t in example]
    want = _outs(module(*xs))  # the direct wrapper on the card
    reset_launches()
    for _ in range(3):
        got = _outs(prog(*xs))
    torch.cuda.synchronize()
    assert LAUNCHES[name] == 3
    assert all(g.device == dev for g in got)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _bytes(g) == _bytes(w)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["B1-non-contiguous", "B1-float64-out",
                                  "B2-float64", "B2-head-dim",
                                  "B3-bool"])
def test_an_input_the_kernel_refuses_raises_through_the_op(case):
    dev = _card()
    if case == "B1-non-contiguous":
        x = _frame(7, (1, 16, 16, 3)).to(dev).transpose(1, 2)
        calls = [lambda: pp.normalize_chain(x, CHAIN),
                 lambda: torch.ops.nnstpu.normalize_chain(
                     x, ["add", "div"], [-127.5, 127.5], torch.float32)]
        err = ValueError
    elif case == "B1-float64-out":
        x = _frame(7).to(dev)
        calls = [lambda: pp.normalize_chain(x, CHAIN, torch.float64),
                 lambda: torch.ops.nnstpu.normalize_chain(
                     x, ["add"], [1.0], torch.float64)]
        err = TypeError
    elif case.startswith("B2"):
        shape = (1, 16, 2, 12) if case == "B2-head-dim" else (1, 16, 2, 16)
        dtype = torch.float32 if case == "B2-head-dim" else torch.float64
        q, k, v = (t.to(dev) for t in _qkv(8, shape, dtype))
        calls = [lambda: fa.flash_attention(q, k, v),
                 lambda: torch.ops.nnstpu.flash_attention(q, k, v, True)]
        err = ValueError if case == "B2-head-dim" else TypeError
    else:
        x = torch.ones(64, dtype=torch.bool, device=dev)
        calls = [lambda: qz.quantize_int8(x),
                 lambda: torch.ops.nnstpu.quantize_int8(x, 0, "auto")]
        err = TypeError
    reset_launches()
    for call in calls:
        with pytest.raises(err):
            call()
    torch.cuda.synchronize()
    assert sum(LAUNCHES.values()) == 0
