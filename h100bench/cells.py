"""Find a cell's configuration, traffic mix, metric readers and kernel
counts by name: ``BENCHMARK.json`` at the checkout's root, and files of
their own under ``h100bench/``. Adding a cell, a configuration, a mix or
a metric adds files and entries; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from types import ModuleType
from typing import Any, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
#: the checkout's root: BENCHMARK.json and the port's package live there
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str) -> ModuleType:
    """Import the Python file ``path`` as module ``name`` (file names may
    hold dots, as a metric's name does)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[name]
        raise
    return module


def _module_name(kind: str, name: str) -> str:
    return f"h100bench._{kind}_" + "".join(
        c if c.isalnum() else "_" for c in name)


@dataclass
class Config:
    """One model configuration: its JSON (``data``), the port's side
    (``program``: configs/<name>.py) and the reference's side
    (``reference``: reference/<name>.py)."""
    name: str
    data: Dict[str, Any]
    program: ModuleType
    reference: ModuleType


@dataclass
class Cell:
    """One entry of ``workloads``, resolved: its configuration, its
    traffic parameters, and the per-layer metrics it reports, with the
    end-to-end metric each one moves."""
    name: str
    chips: int
    config: Config
    traffic_name: str
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]] = field(default_factory=list)
    per_layer: List[Dict[str, Any]] = field(default_factory=list)


def load_benchmark(root: str = ROOT) -> Dict[str, Any]:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def load_config(entry: Dict[str, Any], root: str = ROOT) -> Config:
    """A ``configs`` entry of BENCHMARK.json → its files."""
    name = entry["name"]
    data = load_json(os.path.join(root, entry["file"]))
    program = load_module(os.path.join(HERE, "configs", f"{name}.py"),
                          _module_name("config", name))
    reference = load_module(os.path.join(HERE, "reference", f"{name}.py"),
                            _module_name("reference", name))
    return Config(name=name, data=data, program=program,
                  reference=reference)


def load_traffic(name: str) -> Dict[str, Any]:
    return load_json(os.path.join(HERE, "traffic", f"{name}.json"))


def load_metric(name: str) -> ModuleType:
    """``metrics/<name>.py``: a ``read(ctx)`` that returns the metric's
    value, or None where the run gave it nothing to read."""
    return load_module(os.path.join(HERE, "metrics", f"{name}.py"),
                       _module_name("metric", name))


def load_count(kernel: str) -> ModuleType:
    """``counts/<kernel>.py``: the kernel's operations and bytes."""
    return load_module(os.path.join(HERE, "counts", f"{kernel}.py"),
                       _module_name("count", kernel))


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: str = ROOT) -> Cell:
    """The workload ``name`` of BENCHMARK.json, with its metrics."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _applies(m, name) and m["moves"] in moved]
    return Cell(name=name, chips=int(w["chips"]),
                config=load_config(configs[w["config"]], root),
                traffic_name=w["traffic"], traffic=load_traffic(w["traffic"]),
                end_to_end=e2e, per_layer=layer)
