"""A cell of the benchmark, found by name: its entry in ``BENCHMARK.json``,
its configuration file (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the limits of its correctness numbers
(``limits/<workload>.json``), and the code those files name: the mix's
driver (``drivers/<driver>.py``), its input shapes (``shapes/<shape>.py``)
and the readers of the cell's per-layer metrics (``metrics/<metric>.py``).
A later cell adds files and entries; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _load_json(path: pathlib.Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} is missing")
    return json.loads(path.read_text())


def config(name: str) -> dict:
    return _load_json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _load_json(BENCH / "traffic" / f"{name}.json")


def limits(workload: str) -> dict:
    return _load_json(BENCH / "limits" / f"{workload}.json")


def module(folder: str, name: str):
    """``<folder>/<name>.py`` under ``port_bench/``, loaded once."""
    path = BENCH / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} is missing")
    key = f"port_bench_{folder}_" + name.replace(".", "_").replace("-", "_")
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def metric_reader(name: str):
    """The ``read(run) -> float | None`` of ``metrics/<name>.py``."""
    return module("metrics", name).read


def driver(name: str):
    """The ``Driver`` class of ``drivers/<name>.py``."""
    return module("drivers", name).Driver


def shape(name: str):
    """The ``make(count, points, params, seed, device)`` of
    ``shapes/<name>.py``."""
    return module("shapes", name).make


def dataclass_args(d: dict) -> dict:
    """A configuration group as keyword arguments: lists as tuples."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


class Cell:
    """Everything one run of ``workload`` needs to know, read from files."""

    def __init__(self, workload: str):
        man = manifest()
        found = [w for w in man["workloads"] if w["name"] == workload]
        if not found:
            names = ", ".join(w["name"] for w in man["workloads"])
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(there are: {names})")
        self.workload = found[0]
        self.name = workload
        self.config_name = self.workload["config"]
        self.config = config(self.config_name)
        self.traffic = traffic(self.workload["traffic"])
        self.limits = limits(workload)
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in man["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in man["per_layer"]
                          if workload in m.get("workloads", [workload])]
