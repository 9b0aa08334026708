"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Everything that belongs to one of them sits in files of its own:

  * ``configs/<config>.json``: the TFHE parameter set as it is run;
  * ``traffic/<traffic>.json``: the mix of requests, read by the client its
    ``client`` key names (``clients/<client>.py``);
  * ``workloads/<cell>.json``: how the cell drives the program (its ``impl``,
    the impl its control runs, how many requests the check recomputes);
  * ``metrics/<metric>.py``: one reader per metric, end to end or per layer.

A later cell, configuration, traffic mix or metric is new files and new
entries in ``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "benchmark"


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    workload: dict
    #: the metrics that apply to this cell, each its BENCHMARK.json entry
    end_to_end: tuple
    per_layer: tuple


def read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark_json(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark_json(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(entries)}")
    entry = entries[name]
    bdir = root / "benchmark"
    return Cell(
        name=name,
        chips=entry["chips"],
        config_name=entry["config"],
        config=read_json(bdir / "configs" / f"{entry['config']}.json"),
        traffic_name=entry["traffic"],
        traffic=read_json(bdir / "traffic" / f"{entry['traffic']}.json"),
        workload=read_json(bdir / "workloads" / f"{name}.json"),
        end_to_end=tuple(m for m in bench["end_to_end"] if _applies(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _applies(m, name)),
    )


def cell_to_json(cell: Cell) -> str:
    """``cell`` as loaded, for the ranks of a cell on more than one card."""
    return json.dumps(dataclasses.asdict(cell))


def cell_from_json(text: str) -> Cell:
    fields = json.loads(text)
    return Cell(**dict(fields, end_to_end=tuple(fields["end_to_end"]),
                       per_layer=tuple(fields["per_layer"])))


def load_module(kind: str, name: str, root: Path = ROOT):
    """``benchmark/<kind>/<name>.py`` as a module (the names hold dots, so
    they are loaded by path)."""
    path = root / "benchmark" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    return load_module("metrics", name, root).read


def client_class(name: str, root: Path = ROOT):
    """The ``Client`` class of ``clients/<name>.py``."""
    return load_module("clients", name, root).Client
