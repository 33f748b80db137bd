"""The port's parallel package (nnstreamer_tpu_torch/parallel/) against the
JAX package's 8-device CPU mesh: the mesh and sharded-pipeline cases of
tests/test_models_parallel.py (``TestMesh``, ``TestMeshShardedPipeline``)
and the transformer's sharded forward.

The port's mesh is one controller over logical devices; on the CPU these
tests ask for 8 logical host devices, the counterpart of the JAX conftest's
``--xla_force_host_platform_device_count=8``. Labels of the dp8 classifier
pipeline equal the JAX package's dp8 labels and the port's single-device
labels; an elementwise model's dp8 outputs are byte-identical to its
single-device outputs and within one ulp of the JAX package's (XLA folds
the division into a multiply).
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.filters.jax_backend import (
    register_jax_model,
    unregister_jax_model,
)
from nnstreamer_tpu.models.transformer import TransformerConfig as JCfg
from nnstreamer_tpu.models.transformer import build_forward as jforward
from nnstreamer_tpu.models.transformer import init_params as jinit
from nnstreamer_tpu.parallel.mesh import make_mesh as jmake_mesh
from nnstreamer_tpu.parallel.sharded import (
    make_sharded_forward as jsharded_forward,
)
from nnstreamer_tpu.parallel.sharded import shard_params as jshard_params
from nnstreamer_tpu_torch import parallel
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.models import transformer as ttr
from nnstreamer_tpu_torch.parallel import serve
from nnstreamer_tpu_torch.parallel.mesh import make_mesh
from nnstreamer_tpu_torch.parallel.sharded import (
    lm_loss,
    make_pp_train_step,
    make_sharded_forward,
    make_train_step,
    shard_params,
    transformer_param_specs,
)

N_SRC = 8
PATS = ["gradient", "ball", "black", "smpte"]


@pytest.fixture(autouse=True)
def host_mesh():
    tnt.set_device("cpu")
    tnt.set_host_device_count(8)
    yield
    tnt.set_host_device_count(1)
    tnt.set_device(None)


class TestMesh:
    def test_make_mesh_infer(self):
        mesh = make_mesh([("dp", -1), ("tp", 2)])
        assert mesh.shape["dp"] == 4 and mesh.shape["tp"] == 2
        jmesh = jmake_mesh([("dp", -1), ("tp", 2)])
        assert dict(jmesh.shape) == mesh.shape

    @pytest.mark.parametrize("axes", [[("dp", 3), ("tp", 3)],
                                      [("dp", -1), ("tp", -1)],
                                      [("dp", -1), ("tp", 3)]])
    def test_bad_sizes(self, axes):
        with pytest.raises(ValueError):
            make_mesh(axes)
        with pytest.raises(ValueError):
            jmake_mesh(axes)

    def test_devices_are_the_logical_host_devices(self):
        mesh = make_mesh([("dp", 8)])
        assert [str(d) for d in mesh.device_list()] == \
            [f"cpu:{i}" for i in range(8)]
        assert all(d.device == torch.device("cpu")
                   for d in mesh.device_list())

    def test_a25_names_raise(self):
        """Since ring attention and multi-host runs are ported, the
        package's names are the real ones and raise nothing."""
        from nnstreamer_tpu_torch.parallel import multihost, ring

        assert parallel.ring_attention is ring.ring_attention
        assert parallel.multihost is multihost
        assert multihost.process_info() == (0, 1)


def test_the_parallel_package_imports_no_jax():
    code = ("import sys; import nnstreamer_tpu_torch.parallel.sharded, "
            "nnstreamer_tpu_torch.parallel.serve; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'nnstreamer_tpu')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# -- the transformer's sharded forward ---------------------------------------
TCFG = ttr.TransformerConfig(vocab=128, d_model=32, n_heads=4, n_layers=2,
                             d_ff=64, dtype=torch.float32)
JTCFG = JCfg(vocab=128, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             dtype=jnp.float32)


def test_param_specs_equal_jax():
    from nnstreamer_tpu.parallel.sharded import (
        transformer_param_specs as jspecs,
    )

    for cfg, jcfg in ((TCFG, JTCFG),
                      (ttr.TransformerConfig(num_experts=4),
                       JCfg(num_experts=4))):
        ours = {k: tuple(v) for k, v in transformer_param_specs(cfg).items()}
        theirs = {k: tuple(v) for k, v in jspecs(jcfg).items()}
        assert ours == theirs


@pytest.mark.parametrize("axes", [[("dp", 2), ("tp", 2)],
                                  [("dp", 4), ("tp", 2)],
                                  [("dp", 1), ("tp", 4)],
                                  [("dp", 8), ("tp", 1)]])
def test_sharded_forward_matches_single_device_and_jax(axes):
    """The logits of the sharded forward equal the single-device forward's
    within fp32 summation order (the tp ranks' partial products sum in a
    different order) and the JAX sharded forward's on its mesh."""
    tokens = np.random.default_rng(0).integers(0, 128, (8, 9)) \
        .astype(np.int32)
    params = ttr.init_params(TCFG, seed=3)
    single = ttr.build_forward(TCFG)(ttr.prepare_params(params, TCFG),
                                     torch.from_numpy(tokens))
    mesh = make_mesh(axes)
    ours = make_sharded_forward(TCFG, mesh)(
        shard_params(params, mesh, TCFG), torch.from_numpy(tokens))
    jmesh = jmake_mesh(axes)
    jparams = jshard_params(jinit(JTCFG, seed=3), jmesh, JTCFG)
    theirs = np.asarray(jsharded_forward(JTCFG, jmesh)(jparams,
                                                       jnp.asarray(tokens)))
    np.testing.assert_allclose(ours.numpy(), single.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-4, atol=1e-4)
    assert np.array_equal(ours.argmax(-1).numpy(), theirs.argmax(-1))
    ref = np.asarray(jforward(JTCFG)(jinit(JTCFG, seed=3),
                                     jnp.asarray(tokens)))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_shard_params_places_per_spec():
    mesh = make_mesh([("dp", 2), ("tp", 2)])
    placed = shard_params(ttr.init_params(TCFG, seed=3), mesh, TCFG)
    qkv = placed["qkv"]
    assert tuple(qkv.sharding.spec) == (None, None, None, "tp")
    # [L, D, 3, H, dh]: each device holds half the heads
    assert [tuple(s.data.shape) for s in qkv.addressable_shards] == \
        [(2, 32, 3, 2, 8)] * 4
    # pipelined: the layer axis over pp (absent here: every device holds
    # both layers), tp as above
    piped = shard_params(ttr.init_params(TCFG, seed=3), mesh, TCFG,
                         pipelined=True)
    assert tuple(piped["qkv"].sharding.spec) == (None, None, None, "tp")
    assert [tuple(s.data.shape) for s in piped["qkv"].addressable_shards] \
        == [(2, 32, 3, 2, 8)] * 4


_TOKENS = torch.from_numpy(np.random.default_rng(1).integers(
    0, 128, (8, 8)).astype(np.int32))


def _pp_loss():
    mesh = make_mesh([("dp", 2), ("pp", 2), ("tp", 2)])
    return make_pp_train_step(TCFG, mesh, num_microbatches=2)(
        shard_params(ttr.init_params(TCFG), mesh, TCFG, pipelined=True),
        _TOKENS.reshape(2, 4, 8))[1]


def _sp_logits():
    mesh = make_mesh([("dp", 2), ("sp", 4)])
    return make_sharded_forward(TCFG, mesh)(
        shard_params(ttr.init_params(TCFG), mesh, TCFG), _TOKENS).sum()


@pytest.mark.parametrize("fn", [
    lambda m: make_train_step(TCFG, m)(shard_params(
        ttr.init_params(TCFG), m, TCFG), _TOKENS)[1],
    lambda m: _pp_loss(),
    lambda m: lm_loss(make_sharded_forward(TCFG, m), shard_params(
        ttr.init_params(TCFG), m, TCFG), _TOKENS),
    lambda m: _sp_logits()])
def test_training_and_long_context_raise_naming_a25(fn):
    """Training and long context were ROADMAP A.25's and raised naming
    it; they run now: each gives a finite loss (or logits) on a dp8 mesh,
    a dp2×pp2×tp2 one or a dp2×sp4 one."""
    out = fn(make_mesh([("dp", 8)]))
    assert out.dim() == 0 and torch.isfinite(out)


# -- mesh-sharded streaming pipeline (tests/test_models_parallel.py) ----------
W_CLS = np.random.default_rng(7).standard_normal(
    (16 * 16 * 3, 10)).astype(np.float32)


class _Classify(torch.nn.Module):
    """[N,16,16,3] uint8 → [N,10] logits, the JAX test's classifier."""

    def __init__(self):
        super().__init__()
        self.register_buffer("w", torch.from_numpy(W_CLS))

    def forward(self, x):
        xf = (x.float() - 127.5) / 127.5
        return xf.reshape(x.shape[0], -1) @ self.w


class _Norm(torch.nn.Module):
    def forward(self, x):
        return (x.float() - 127.5) / 127.5 * 0.977 + 0.003


@pytest.fixture
def cls_model():
    w = jnp.asarray(W_CLS)

    def classify(x):
        xf = (x.astype(jnp.float32) - 127.5) / 127.5
        return (xf.reshape(x.shape[0], -1) @ w,)

    register_jax_model("mesh_pipe_cls", classify, None)
    register_torch_model("mesh_pipe_cls", _Classify())
    yield "mesh_pipe_cls"
    unregister_jax_model("mesh_pipe_cls")
    unregister_torch_model("mesh_pipe_cls")


def _desc(model, extra="", size=16, frames=4, decode=True):
    srcs = "".join(
        f"videotestsrc num-buffers={frames} width={size} height={size} "
        f"pattern={PATS[i % len(PATS)]} ! tensor_converter ! m. "
        for i in range(N_SRC))
    tail = ("tensor_decoder mode=image_labeling option2=batched ! "
            if decode else "")
    return (srcs + "tensor_merge name=m mode=linear option=3 "
            "sync-mode=slowest ! "
            f"tensor_filter framework=jax model={model} {extra}! " + tail +
            "tensor_sink name=sink to-host=true")


def _outs(pkg, desc):
    pipe = pkg.parse_launch(desc)
    msg = pipe.run(timeout=600)
    assert msg is not None and msg.kind == "eos", f"pipeline: {msg}"
    return [np.asarray(b.tensors[0]) for b in pipe.get("sink").buffers]


class TestMeshShardedPipeline:
    def test_dp8_labels_match_single_device_and_jax(self, cls_model):
        reshard0 = serve.reshard_bytes_total()
        sharded = [o.tolist() for o in _outs(tnt, _desc(cls_model,
                                                        "mesh=dp8 "))]
        single = [o.tolist() for o in _outs(tnt, _desc(cls_model))]
        jsharded = [o.tolist() for o in _outs(jnt, _desc(cls_model,
                                                         "mesh=dp8 "))]
        assert len(sharded) == 4, sharded
        assert sharded == single == jsharded, (
            f"mesh pipeline labels diverged: {sharded} vs {single} vs "
            f"{jsharded}")
        # merge hands the batch to the one sharded invoker straight from
        # host — nothing in this graph may reshard
        assert serve.reshard_bytes_total() == reshard0

    def test_elementwise_dp8_byte_identical(self):
        register_jax_model(
            "mesh_pipe_elt",
            lambda x: ((x.astype(jnp.float32) - 127.5) / 127.5 * 0.977
                       + 0.003,), None)
        register_torch_model("mesh_pipe_elt", _Norm())
        try:
            outs = {key: _outs(pkg, _desc("mesh_pipe_elt", extra, size=8,
                                          frames=2, decode=False))
                    for key, pkg, extra in (("dp8", tnt, "mesh=dp8 "),
                                            ("single", tnt, ""),
                                            ("jax", jnt, "mesh=dp8 "))}
        finally:
            unregister_jax_model("mesh_pipe_elt")
            unregister_torch_model("mesh_pipe_elt")
        assert len(outs["dp8"]) == len(outs["single"]) == 2
        for a, b, c in zip(outs["dp8"], outs["single"], outs["jax"]):
            assert a.dtype == b.dtype == c.dtype and a.shape == b.shape
            assert np.array_equal(a, b), "dp8 not byte-identical"
            # XLA folds the division into a multiply: one ulp apart
            np.testing.assert_allclose(a, c, rtol=1e-6, atol=1e-6)

    def test_kill_switch_single_device_path(self, cls_model, monkeypatch):
        """NNSTPU_MESH=0 with a mesh= property still present takes the
        single-device path: no plan on the backend, labels equal the
        plain run."""
        monkeypatch.setenv("NNSTPU_MESH", "0")
        pipe = tnt.parse_launch(_desc(cls_model, "mesh=dp8 name=filter "))
        pipe.start()
        try:
            assert pipe.get("filter").fw._mesh_plan is None, \
                "kill switch must keep the backend planless"
            msg = pipe.wait(timeout=600)
            assert msg is not None and msg.kind == "eos", msg
        finally:
            pipe.stop()
        killed = [np.asarray(b.tensors[0]).tolist()
                  for b in pipe.get("sink").buffers]
        monkeypatch.delenv("NNSTPU_MESH")
        assert killed == [o.tolist() for o in _outs(tnt, _desc(cls_model))]
