"""Graphviz dot dumps in the PyTorch port (``pipeline/dot.py``), held to
the JAX package's: the same launch string gives the same dot text once
node ids (object addresses) are numbered in order and the region label's
"one XLA program" reads "one CUDA graph"; ``NNSTPU_DUMP_DOT_DIR`` writes
one dump a start, and a failing dump never breaks the pipeline.
"""

import os
import re

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.filters.jax_backend import (
    register_jax_model,
    unregister_jax_model,
)
from nnstreamer_tpu_torch.cli import main as cli_main
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)

DESC = ("videotestsrc name=src num-buffers=2 width=8 height=8 ! "
        "tensor_converter name=conv ! "
        "tensor_transform name=tf mode=typecast option=float32 ! "
        "tensor_sink name=out")


def _normalized(dot: str) -> str:
    ids = {}
    dot = re.sub(r"n[0-9a-f]{8,}",
                 lambda m: ids.setdefault(m.group(0), f"N{len(ids)}"), dot)
    return dot.replace("one XLA program", "one CUDA graph")


class _Double(torch.nn.Module):
    def forward(self, x):
        return x * 2.0


@pytest.fixture(autouse=True)
def models():
    tnt.set_device("cpu")
    register_jax_model("tdot_double", lambda x: x * 2.0)
    register_torch_model("tdot_double", _Double())
    yield
    unregister_jax_model("tdot_double")
    unregister_torch_model("tdot_double")
    tnt.set_device(None)


def test_to_dot_lists_elements_and_links_as_jax():
    dot = tnt.parse_launch(DESC).to_dot()
    for name in ("src", "conv", "tf", "out", "videotestsrc",
                 "tensor_converter", "tensor_transform"):
        assert name in dot
    assert dot.count("->") == 3 and dot.strip().startswith("digraph")
    assert _normalized(dot) == _normalized(jnt.parse_launch(DESC).to_dot())


@pytest.mark.parametrize("lanes", [1, 4])
def test_started_dot_equals_jax_with_regions_and_lanes(lanes):
    """A started pipeline: the fused region as a cluster, the lane
    executor as a routing node, negotiated caps on the edges."""
    desc = ("appsrc name=src ! tensor_transform name=tf mode=arithmetic "
            "option=typecast:float32,add:1 ! tensor_filter name=f "
            "framework=jax model=tdot_double ! tensor_sink name=out")
    if lanes > 1:
        desc = ("videotestsrc name=src num-buffers=2 width=8 height=8 ! "
                "tensor_converter name=conv ! queue name=q ! "
                + desc.split("! ", 1)[1])
    texts = {}
    for pkg, mod in (("jax", jnt), ("port", tnt)):
        pipe = mod.parse_launch(desc, lanes=lanes)
        if lanes > 1:
            # a source streams at once: dump after EOS, when every edge
            # has negotiated in both packages (regions and lanes stay)
            assert pipe.run(timeout=60).kind == "eos"
            texts[pkg] = pipe.to_dot()
            continue
        pipe.start()
        try:
            texts[pkg] = pipe.to_dot()
        finally:
            pipe.get("src").end_of_stream()
            pipe.stop()
    assert "subgraph cluster_" in texts["port"]
    assert "fused region" in texts["port"]
    if lanes > 1:
        assert "ingest lanes" in texts["port"]
    assert _normalized(texts["port"]) == _normalized(texts["jax"])


def test_env_dump_writes_file_on_start(tmp_path, monkeypatch):
    monkeypatch.setenv("NNSTPU_DUMP_DOT_DIR", str(tmp_path))
    pipe = tnt.parse_launch(DESC)
    assert pipe.run(timeout=30).kind == "eos"
    dumps = [p for p in os.listdir(tmp_path) if p.endswith(".playing.dot")]
    assert len(dumps) == 1
    assert "digraph" in (tmp_path / dumps[0]).read_text()


def test_cli_dot_flag(tmp_path):
    out = tmp_path / "graph.dot"
    assert cli_main(["-q", "--platforms", "cpu", "--dot", str(out),
                     DESC]) == 0
    text = out.read_text()
    assert "digraph" in text and "tensor_converter" in text


def test_dump_failure_does_not_break_pipeline(monkeypatch, tmp_path):
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("")  # a FILE where a directory is needed
    monkeypatch.setenv("NNSTPU_DUMP_DOT_DIR", str(blocker))
    pipe = tnt.parse_launch(DESC)
    assert pipe.run(timeout=30).kind == "eos"
    assert len(pipe.get("out").buffers) == 2
    np.testing.assert_array_equal(
        np.asarray(pipe.get("out").buffers[0].tensors[0]).shape, (1, 8, 8, 3))
