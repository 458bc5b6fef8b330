"""A cell as ``BENCHMARK.json`` names it, with everything found by name:
the configuration's file (``configs[].file``), the traffic mix
(``traffic/<traffic>.json``), the limits of its comparison
(``limits/<workload>.json``), and one reader a metric
(``e2e/<name>.py`` for an end-to-end metric, ``metrics/<name>.py`` for a
per-layer one). A later cell, mix or metric is a new file; nothing here
names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Metric:
    name: str
    unit: str
    reader: object       # its module: read(window) or read(reading)


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def reader(kind: str, name: str, here: str = HERE):
    """The module ``<here>/<kind>/<name>.py``, loaded from its path: its
    ``read``; the unit, layer and ``moves`` are BENCHMARK.json's."""
    path = os.path.join(here, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"gpubench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(root: str, workload: str, here: str = HERE) -> Tuple[Cell, Dict]:
    """(the cell named ``workload``, the whole ``BENCHMARK.json``) of the
    checkout at ``root``; ``here`` is the harness's own folder."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cell = Cell(
        name=workload, chips=w["chips"],
        config=_json(os.path.join(root, conf["file"])),
        traffic=_json(os.path.join(here, "traffic", w["traffic"] + ".json")),
        limits=_json(os.path.join(here, "limits", workload + ".json")),
        end_to_end=[Metric(m["name"], m["unit"], reader("e2e", m["name"], here))
                    for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[Metric(m["name"], m["unit"], reader("metrics", m["name"], here))
                   for m in bench["per_layer"] if _applies(m, workload)])
    return cell, bench
