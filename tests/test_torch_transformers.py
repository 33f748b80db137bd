"""The port's ``transformers`` backend (``nnstreamer_tpu_torch/filters/
transformers_backend.py``) held to the JAX package's on the CPU, on the
tiny BERT of ``tests/test_filter_backends_extra.py::TestTransformersFilter``
built from a local config (nothing is downloaded).

The JAX filter runs ``FlaxAutoModel.from_config`` (its seed 0); the test
builds the same Flax model, takes its parameters to numpy, turns them into
the PyTorch ``BertModel``'s ``state_dict`` with the port's
``state_dict_from_flax`` and saves that model to a directory the port's
filter loads. ``last_hidden_state`` and ``pooler_output`` then agree to
``rtol=1e-4, atol=1e-5``: the same float32 model in two frameworks,
whose matmuls, softmax and GELU round in other orders through 2 layers
(TF32 is off, and would not apply on the CPU anyway). ``backend:flax``
and ``backend:torch`` both run the PyTorch model on the port (ROADMAP
C.48).
"""

import json

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax  # noqa: E402

import nnstreamer_tpu as jnt  # noqa: E402
import nnstreamer_tpu_torch as tnt  # noqa: E402
from nnstreamer_tpu.filters.api import FilterProperties as JaxProps  # noqa: E402
from nnstreamer_tpu.registry import FILTER as JAX_FILTER  # noqa: E402
from nnstreamer_tpu.registry import get_subplugin as jax_get_subplugin  # noqa: E402
from nnstreamer_tpu.tensors.types import TensorsInfo as JaxInfo  # noqa: E402
from nnstreamer_tpu_torch.filters.api import FilterProperties  # noqa: E402
from nnstreamer_tpu_torch.filters.transformers_backend import (  # noqa: E402
    state_dict_from_flax,
)
from nnstreamer_tpu_torch.registry import FILTER, get_subplugin  # noqa: E402
from nnstreamer_tpu_torch.tensors.types import TensorsInfo  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
CFG = {
    "model_type": "bert",
    "architectures": ["BertModel"],
    "hidden_size": 32,
    "num_hidden_layers": 2,
    "num_attention_heads": 2,
    "intermediate_size": 64,
    "vocab_size": 128,
    "max_position_embeddings": 64,
    "type_vocab_size": 2,
}


@pytest.fixture(autouse=True)
def cpu_device():
    tnt.set_device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    tnt.set_device(None)


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_bert")
    (d / "config.json").write_text(json.dumps(CFG))
    return str(d)


@pytest.fixture(scope="module")
def flax_params(bert_dir):
    """The parameters of the JAX filter's model: FlaxAutoModel from the
    config at its default seed 0, as numpy arrays."""
    cfg = transformers.AutoConfig.from_pretrained(bert_dir,
                                                  local_files_only=True)
    model = transformers.FlaxAutoModel.from_config(cfg)
    return jax.tree.map(np.asarray, model.params)


@pytest.fixture(scope="module")
def converted_dir(tmp_path_factory, bert_dir, flax_params):
    """The Flax weights in a PyTorch checkpoint directory, through the
    port's conversion."""
    cfg = transformers.AutoConfig.from_pretrained(bert_dir,
                                                  local_files_only=True)
    model = transformers.AutoModel.from_config(cfg)
    sd = state_dict_from_flax(flax_params)
    params = dict(model.named_parameters())
    assert set(params) <= set(sd)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected and not set(missing) & set(params)
    d = tmp_path_factory.mktemp("converted")
    model.save_pretrained(str(d))
    return str(d)


def _ids(seed, shape=(2, 16)):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], shape, dtype=np.int32)


def _jax_filter(bert_dir, custom="from_config:true"):
    f = jax_get_subplugin(JAX_FILTER, "transformers")()
    f.open(JaxProps(model=bert_dir, custom=custom))
    return f


def _port_filter(model, custom=""):
    f = get_subplugin(FILTER, "transformers")()
    f.open(FilterProperties(model=model, custom=custom))
    return f


def test_conversion_names_and_layouts(flax_params):
    sd = state_dict_from_flax(flax_params)
    enc = flax_params["encoder"]["layer"]["0"]["attention"]["self"]
    np.testing.assert_array_equal(
        sd["encoder.layer.0.attention.self.query.weight"].numpy(),
        enc["query"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["embeddings.LayerNorm.weight"].numpy(),
        flax_params["embeddings"]["LayerNorm"]["scale"])
    np.testing.assert_array_equal(
        sd["embeddings.word_embeddings.weight"].numpy(),
        flax_params["embeddings"]["word_embeddings"]["embedding"])
    assert "pooler.dense.bias" in sd


def test_a_convolution_kernel_is_permuted():
    k = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    sd = state_dict_from_flax({"conv": {"kernel": k, "bias": np.zeros(5)}})
    w = sd["conv.weight"].numpy()
    assert w.shape == (5, 4, 2, 3)
    np.testing.assert_array_equal(w, k.transpose(3, 2, 0, 1))
    assert tuple(sd["conv.bias"].shape) == (5,)


@pytest.mark.parametrize("backend", ["flax", "torch"])
def test_outputs_match_the_jax_filter(bert_dir, converted_dir, backend):
    jf = _jax_filter(bert_dir)
    pf = _port_filter(converted_dir, f"backend:{backend}")
    try:
        want_info = jf.set_input_info(JaxInfo.from_str("16:2", "int32"))
        got_info = pf.set_input_info(TensorsInfo.from_str("16:2", "int32"))
        assert [(tuple(i.dim), i.type.value) for i in got_info] == \
            [(tuple(i.dim), i.type.value) for i in want_info] == \
            [((32, 16, 2), "float32"), ((32, 2), "float32")]
        for seed in range(2):
            ids = _ids(seed)
            want = [np.asarray(o) for o in jf.invoke([ids])]
            got = pf.invoke([ids])
            assert all(isinstance(o, torch.Tensor) for o in got)
            assert len(got) == len(want) == 2
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                           atol=ATOL)
    finally:
        jf.close()
        pf.close()


def test_an_attention_mask_input_matches_jax(bert_dir, converted_dir):
    ids = _ids(3)
    mask = np.ones_like(ids)
    mask[:, 11:] = 0
    jf, pf = _jax_filter(bert_dir), _port_filter(converted_dir)
    try:
        want = [np.asarray(o) for o in jf.invoke([ids, mask])]
        got = pf.invoke([ids, mask])
    finally:
        jf.close()
        pf.close()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)


def test_in_pipeline_as_jax(bert_dir, converted_dir):
    """TestTransformersFilter's pipeline: appsrc ! tensor_filter
    framework=transformers ! tensor_sink, two [1, 16] id frames."""
    frames = [_ids(7 + i, (1, 16)) for i in range(2)]
    outs = {}
    for pkg, model, custom in ((jnt, bert_dir, "from_config:true"),
                               (tnt, converted_dir, "backend:flax")):
        pipe = pkg.parse_launch(
            "appsrc name=src ! tensor_filter framework=transformers "
            f"model={model} custom={custom} ! tensor_sink name=out "
            "to-host=true")
        pipe.start()
        try:
            for f in frames:
                pipe.get("src").push([f])
            pipe.get("src").end_of_stream()
            msg = pipe.wait(timeout=120)
            assert msg is not None and msg.kind == "eos", msg
        finally:
            pipe.stop()
        outs[pkg] = [[np.asarray(t) for t in b.tensors]
                     for b in pipe.get("out").buffers]
    assert len(outs[tnt]) == len(outs[jnt]) == 2
    for g, w in zip(outs[tnt], outs[jnt]):
        assert [a.shape for a in g] == [a.shape for a in w] == \
            [(1, 16, 32), (1, 32)]
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_from_config_shapes_as_jax(bert_dir):
    """TestTransformersFilter's from-config cases: random weights (each
    framework's own), so shapes and types only; the port's two opens give
    the same weights."""
    jf = _jax_filter(bert_dir)
    pf = _port_filter(bert_dir, "from_config:true,backend:torch")
    pf2 = _port_filter(bert_dir, "from_config:true,arch:FlaxAutoModel")
    try:
        want = jf.invoke([np.ones((2, 16), np.int32)])
        got = pf.invoke([np.ones((2, 16), np.int64)])
        got2 = pf2.invoke([np.ones((2, 16), np.int32)])
        assert [tuple(o.shape) for o in got] == \
            [tuple(np.asarray(o).shape) for o in want]
        assert all(torch.equal(a, b) for a, b in zip(got, got2))
    finally:
        jf.close()
        pf.close()
        pf2.close()


def test_unknown_arch_and_backend_raise(bert_dir):
    with pytest.raises(ValueError, match="auto-class"):
        _port_filter(bert_dir, "from_config:true,arch:NoSuchAutoModel")
    with pytest.raises(ValueError, match="backend"):
        _port_filter(bert_dir, "from_config:true,backend:tf")
