"""Helpers of the benchmark's own tests: a cell cut to a size the CPU
runs in seconds (the port on the CPU, float32)."""

from __future__ import annotations

import copy

import pytest

#: per-configuration sizes of a CPU run: small frames, few classes
TINY = {
    "mobilenet_v2_224": {"image_size": 32, "num_classes": 10},
    "ssd_mobilenet_v2_300": {"image_size": 64, "num_classes": 5},
}

#: (configuration, traffic) of each cell the tests drive: the two in
#: BENCHMARK.json and the two SSD cells whose files wait for their entries
PAIRS = {
    "mnv2.b8_saturated": ("mobilenet_v2_224", "saturated_b8"),
    "mnv2.b1_saturated": ("mobilenet_v2_224", "saturated_b1_flagship"),
    "ssd.b1_saturated": ("ssd_mobilenet_v2_300", "saturated_b1"),
    "ssd.b1_rate80": ("ssd_mobilenet_v2_300", "poisson_rate80_b1"),
}


def tiny_cell(config: str, traffic: str, dtype: str = "float32", **mix):
    """A cell of configuration ``config`` under the mix ``traffic`` (both
    found by name, in BENCHMARK.json or not) at a CPU size: the
    configuration's frames and classes cut (:data:`TINY`), its dtype
    ``dtype``, a pool of 16 frames, and any traffic key of ``mix``
    replaced. It reports every end-to-end metric the harness takes."""
    from h100bench import cells

    cfg = cells.load_config({"name": config,
                             "file": f"h100bench/configs/{config}.json"})
    cfg.data = copy.deepcopy(cfg.data)
    cfg.data.update(TINY[config], dtype=dtype)
    mix_data = {**cells.load_traffic(traffic), "pool_frames": 16,
                "preroll_s": 0.2, **mix}
    if mix_data["arrivals"] == "poisson":
        mix_data["rate_fps"] = min(mix_data["rate_fps"], 40)
    e2e = [{"name": n, "unit": u} for n, u in (
        ("frames_per_s", "frames/s"), ("latency_p95_ms", "ms"),
        ("latency_p50_ms", "ms"), ("setup_s", "s"))]
    return cells.Cell(name=f"{config}.{traffic}", chips=1, config=cfg,
                      traffic_name=traffic, traffic=mix_data,
                      end_to_end=e2e)


@pytest.fixture
def cpu_device():
    """The port's package device set to the CPU for one test."""
    import nnstreamer_tpu_torch as nt

    nt.set_device("cpu")
    yield "cpu"
    nt.set_device(None)
