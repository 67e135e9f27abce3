"""A cell found by name: ``BENCHMARK.json``'s workload entry, its
configuration file, its traffic mix (``traffic/<mix>.json``), its limits
(``limits/<cell>.json``) and the per-layer metrics it reports
(``metrics/<metric>.py``). Adding a configuration, a mix, a metric or a
cell adds files and entries; no file here names one."""

from __future__ import annotations

import importlib.util
import json
import types
from dataclasses import dataclass, field
from pathlib import Path
from typing import List

#: the benchmark's folder and the checkout's root
HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent

#: the fields of a model configuration and their defaults (the program's
#: ``UNetConfig``)
MODEL_DEFAULTS = {"in_channels": 2, "out_channels": 1, "base_features": 32,
                  "depth": 4, "norm": "batch", "group_norm_groups": 8,
                  "arch": "unet", "deep_supervision": False,
                  "prune_level": None, "compute_dtype": "bfloat16",
                  "use_pallas": False, "use_mega": False}


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> types.ModuleType:
    """Import the Python file ``path`` under ``name`` (file names carry
    dots and hyphens, which an import statement cannot)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def model_config(entry: dict) -> types.SimpleNamespace:
    """The model fields of a configuration file as attributes, defaults
    filled in."""
    unknown = set(entry) - set(MODEL_DEFAULTS)
    if unknown:
        raise ValueError(f"unknown model fields {sorted(unknown)}")
    return types.SimpleNamespace(**{**MODEL_DEFAULTS, **entry})


@dataclass
class Metric:
    """One per-layer metric: its entry in ``BENCHMARK.json`` and its
    reader, ``read(record) -> float or None``."""

    name: str
    entry: dict
    read: object


@dataclass
class Cell:
    name: str
    root: Path                   # the checkout (BENCHMARK.json's folder)
    chips: int
    config: dict                 # the configuration file
    model: types.SimpleNamespace
    mix: dict                    # the traffic mix file
    limits: dict                 # {number: limit}
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)

    @property
    def folder(self) -> Path:
        return self.root / HERE.name


def reported_by(entry: dict, cell: str, end_to_end: List[str]) -> bool:
    """Whether a metric entry belongs to ``cell``: it lists the cell, or it
    lists none and moves (or is) an end-to-end metric the cell reports."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves", entry["name"]) in end_to_end


def load_cell(name: str, bench: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of ``bench`` with everything it reads."""
    spec = _load_json(bench)
    root = bench.parent
    here = root / HERE.name
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {bench} "
                       f"(have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = _load_json(root / conf["file"])
    mix = _load_json(here / "traffic" / f"{w['traffic']}.json")
    limits = _load_json(here / "limits" / f"{name}.json")
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = [m["name"] for m in e2e]
    per_layer = []
    for m in spec["per_layer"]:
        if not reported_by(m, name, e2e_names):
            continue
        module = load_module(here / "metrics" / f"{m['name']}.py",
                             f"benchmark_metric_{len(per_layer)}")
        per_layer.append(Metric(m["name"], m, module.read))
    return Cell(name, root, int(w["chips"]), config, model_config(config["model"]),
                mix, limits, e2e, per_layer)
