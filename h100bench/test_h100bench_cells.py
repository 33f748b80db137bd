"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix and metric found by name, and the file within the limits a
benchmark's description keeps."""

from __future__ import annotations

import json
import os
import re

import pytest

from h100bench import cells

BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(cell):
    c = cells.find_cell(cell)
    assert c.chips == 1
    for attr in ("caps", "inputs", "module", "segment", "answers",
                 "served", "flops", "KERNELS"):
        assert hasattr(c.config.program, attr)
    for attr in ("specs", "judge", "control", "NUMBERS"):
        assert hasattr(c.config.reference, attr)
    assert set(c.config.reference.NUMBERS) == set(c.config.data["limits"])
    assert {"setup_s"} < {m["name"] for m in c.end_to_end}
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.end_to_end + c.per_layer:
        assert callable(cells.load_metric(m["name"]).read)
    assert c.traffic["arrivals"] in ("closed", "poisson")
    assert "{caps}" in c.traffic["launch"] and \
        "{model}" in c.traffic["launch"]


def test_names_units_and_sizes_keep_the_limits():
    assert os.path.getsize(os.path.join(cells.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in BENCH["configs"]:
        data = cells.load_json(os.path.join(cells.ROOT, c["file"]))
        assert data["name"] == c["name"]
        assert all(NAME.match(k) for k in c["reduced"])
        assert all(k in data for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_size")) or
                       "hidden" in k or "intermediate" in k
                       for k in c["reduced"])


def test_every_metric_reader_and_mix_is_a_file_of_its_own():
    here = cells.HERE
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert os.path.isfile(os.path.join(here, "metrics",
                                           f"{m['name']}.py"))
    for w in BENCH["workloads"]:
        path = os.path.join(here, "traffic", f"{w['traffic']}.json")
        with open(path) as f:
            json.load(f)
        assert len(w["why"]) <= 200


def test_a_per_layer_metric_applies_only_where_it_moves_a_reported_metric():
    for w in BENCH["workloads"]:
        c = cells.find_cell(w["name"])
        moved = {m["name"] for m in c.end_to_end}
        assert all(m["moves"] in moved for m in c.per_layer)
        assert "model_mfu" in {m["name"] for m in c.per_layer}


def test_the_cells_waiting_for_entries_have_their_files():
    from h100bench.conftest import PAIRS

    for config, traffic in PAIRS.values():
        c = cells.load_config({"name": config,
                               "file": f"h100bench/configs/{config}.json"})
        assert set(c.reference.NUMBERS) == set(c.data["limits"])
        assert all(v is not None for v in c.data["limits"].values())
        cells.load_traffic(traffic)
    for name in ("queue_wait_ms.rate", "device_idle_share.rate",
                 "latency_p95_ms", "latency_p50_ms"):
        assert callable(cells.load_metric(name).read)
