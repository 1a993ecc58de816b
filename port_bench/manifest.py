"""Find a cell's parts by name: everything is a file of its own.

``BENCHMARK.json`` (beside this folder) names each cell's configuration
and traffic mix and lists the metrics. Under this folder:
``configs/<config>.json`` (the configuration as it is run),
``traffic/<traffic>.json`` (the mix's parameters; its ``kind`` names the
loop ``traffic/<kind>.py`` that drives it, its ``entry`` the program's
entry ``entries/<entry>.py``), ``providers/<cost>.py`` (a cost that needs
a provider object), ``checks/<config>.json`` (the numbers that decide
``correct`` and their limits),
``layers/*.json`` (each a layer's kernel-name table and, optionally, the
name of its work count ``work/<name>.py``; a layer's table is the union of
every file that names it) and ``metrics/<metric>.py`` (a reader per
per-layer metric).
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    checks: dict
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric`` (no ``workloads`` key: all)."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    return Cell(
        name=name,
        config=_json(here / "configs" / f"{w['config']}.json"),
        traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
        checks=_json(here / "checks" / f"{w['config']}.json"),
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)])


def layer_files(here: Path = HERE) -> list[dict]:
    return [_json(p) for p in sorted((here / "layers").glob("*.json"))]


def matches(when: dict | None, config: dict) -> bool:
    return all(config.get(k) == v for k, v in (when or {}).items())


def kernel_tables(here: Path = HERE) -> dict[str, list[str]]:
    """Layer -> the kernel-name patterns of every file that names it."""
    tables: dict[str, list[str]] = {}
    for spec in layer_files(here):
        tables.setdefault(spec["layer"], []).extend(spec.get("kernels", []))
    return tables


def module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"port_bench._{path.parent.name}_{path.stem.replace('.', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def layer_work(config: dict, here: Path = HERE) -> dict[str, dict]:
    """Layer -> its work a frame (bytes, tf32_flop, flop), summed over the
    layer files whose ``when`` matches ``config`` and that name a work."""
    work: dict[str, dict] = {}
    for spec in layer_files(here):
        if "work" not in spec or not matches(spec.get("when"), config):
            continue
        counts = module(here / "work" / f"{spec['work']}.py").count(config)
        into = work.setdefault(spec["layer"], {})
        for k, v in counts.items():
            into[k] = into.get(k, 0.0) + v
    return work


def reader(metric: str, here: Path = HERE):
    """``metrics/<metric>.py``'s ``read``."""
    return module(here / "metrics" / f"{metric}.py").read


def traffic_kind(kind: str, here: Path = HERE):
    """``traffic/<kind>.py``: the loop that drives a mix of that kind."""
    return module(here / "traffic" / f"{kind}.py")
