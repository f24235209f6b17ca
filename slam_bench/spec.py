"""``BENCHMARK.json`` and the files it names.

A cell is found by its workload name. Its configuration's ``file`` is a
path from the root; its traffic, its limits and each metric and kernel
count are found by name in the benchmark's directories (``paths``, in
order): ``traffic/<traffic>.json``, ``limits/<workload>.json``,
``metrics/<metric>.py``, ``rooflines/<kernel>.py`` and
``requests/<request>.py``, the request a traffic file names.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's ``config``
    traffic: dict
    limits: dict  # number compared → its limit
    end_to_end: list  # the metrics entries this cell reports
    per_layer: list
    dirs: list  # where files are looked up, in order


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def search_dirs(root: Path, bench: dict) -> list:
    return [root / p for p in bench["paths"]]


def find(dirs: list, sub: str, name: str) -> Path:
    for d in dirs:
        p = Path(d) / sub / name
        if p.is_file():
            return p
    raise FileNotFoundError(f"no {sub}/{name} under {[str(d) for d in dirs]}")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, workload: str) -> Cell:
    root = Path(root)
    bench = load_json(root / "BENCHMARK.json")
    w = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    dirs = search_dirs(root, bench)
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=load_json(root / conf["file"])["config"],
        traffic=load_json(find(dirs, "traffic", w["traffic"] + ".json")),
        limits=load_json(find(dirs, "limits", workload + ".json"))["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
        dirs=dirs,
    )


def load_module(dirs: list, sub: str, name: str):
    """The module ``<sub>/<name>.py`` (a name may hold dots)."""
    path = find(dirs, sub, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"slam_bench_{sub}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
