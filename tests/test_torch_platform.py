"""Platform selection of the PyTorch port (``nnstreamer_tpu_torch/utils/
platform.py``), held to the JAX package's ``utils/platform.py``: the same
subprocess probe with a timeout and the same TTL'd verdict cache. The
port differs on purpose where no healthy card is found: it raises unless
the CPU was asked for, where the JAX package falls back to the CPU
(ROADMAP queue C).
"""

import json
import os
import time

import pytest

import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.utils import platform as jplatform
from nnstreamer_tpu_torch.utils import platform


@pytest.fixture
def private_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(platform.tempfile, "gettempdir",
                        lambda: str(tmp_path))
    monkeypatch.delenv("NNSTPU_PROBE_NOCACHE", raising=False)
    monkeypatch.delenv("NNSTPU_PROBE_CACHE_TTL", raising=False)
    return tmp_path


def test_probe_finds_no_card_here():
    import torch

    want = "cuda" if torch.cuda.is_available() else None
    assert platform.probe_cuda_platform(timeout_s=120) == want


def test_a_wedged_probe_times_out(monkeypatch):
    monkeypatch.setattr(platform, "_PROBE", "import time; time.sleep(60)")
    t0 = time.monotonic()
    assert platform.probe_cuda_platform(timeout_s=0.5) is None
    assert time.monotonic() - t0 < 30


def test_cache_round_trip_and_ttl(private_cache, monkeypatch):
    platform._probe_cache_put("0", "cuda")
    assert platform._probe_cache_get("0") == {"platform": "cuda"}
    path = platform._probe_cache_path("0")
    old = time.time() - 2 * platform.DEFAULT_PROBE_CACHE_TTL
    os.utime(path, (old, old))
    assert platform._probe_cache_get("0") is None  # stale
    monkeypatch.setenv("NNSTPU_PROBE_NOCACHE", "1")
    platform._probe_cache_put("1", "cuda")
    assert not os.path.exists(platform._probe_cache_path("1"))


def test_cache_file_is_the_jax_packages_format(private_cache):
    platform._probe_cache_put("x", None)
    with open(platform._probe_cache_path("x")) as f:
        assert json.load(f) == {"platform": None}
    # the JAX package keys its own file by the JAX preset: no clash
    assert platform._probe_cache_path("x") != jplatform._probe_cache_path("x")


def test_no_card_raises_unless_the_cpu_was_asked_for(private_cache,
                                                     monkeypatch):
    """The deliberate divergence: the JAX package's ensure_jax_platform
    would fall back to the CPU here."""
    monkeypatch.setattr(platform, "probe_cuda_platform",
                        lambda timeout_s=None: None)
    tnt.set_device(None)
    with pytest.raises(RuntimeError, match="no healthy CUDA device"):
        platform.ensure_platform()
    assert platform.ensure_platform(cpu=True) == "cpu"
    tnt.set_device("cpu")
    try:
        assert platform.ensure_platform() == "cpu"
    finally:
        tnt.set_device(None)


def test_a_healthy_verdict_is_cached(private_cache, monkeypatch):
    calls = []

    def probe(timeout_s=None):
        calls.append(1)
        return "cuda"

    monkeypatch.setattr(platform, "probe_cuda_platform", probe)
    tnt.set_device(None)
    assert platform.ensure_platform() == "cuda"
    assert platform.ensure_platform() == "cuda"
    assert calls == [1]
