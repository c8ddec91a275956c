"""Where the benchmark finds each thing it runs, by name.

``BENCHMARK.json`` at the root of the checkout lists the configurations, the
cells (``workloads``) and the metrics. Each named thing is a file of its own
under this directory, so a later cell, configuration or metric is a new file
and a new entry, never an edit:

* ``configs/<config>.json``: one configuration (widths, catalog, dtype);
* ``traffic/<traffic>.json``: one traffic mix, the parameters that the
  general generator it names (``generators/<generator>.py``) reads;
* ``workloads/<cell>.json``: what belongs to one cell alone: the slice its
  traced run profiles and the limits of its correctness check;
* ``layer_metrics/<metric>.py``: the reader of one per-layer metric.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / 'BENCHMARK.json')


@dataclass
class Cell:
    """One cell of ``BENCHMARK.json`` with its files read."""
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    settings: dict          # workloads/<cell>.json
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]   # the per-layer metrics this cell reports


def _reports(metric: dict, cell: str) -> bool:
    return 'workloads' not in metric or cell in metric['workloads']


def cell(name: str, bench: dict = None) -> Cell:
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench['workloads'] if w['name'] == name), None)
    if entry is None:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')
    e2e = [m for m in bench['end_to_end'] if _reports(m, name)]
    moved = {m['name'] for m in e2e}
    layer = [m for m in bench['per_layer']
             if _reports(m, name) and m['moves'] in moved]
    return Cell(name=name, chips=int(entry['chips']),
                config_name=entry['config'],
                config=load_json(HERE / 'configs'
                                 / f"{entry['config']}.json"),
                traffic=load_json(HERE / 'traffic'
                                  / f"{entry['traffic']}.json"),
                settings=load_json(HERE / 'workloads' / f'{name}.json'),
                end_to_end=e2e, per_layer=layer)


def generator(kind: str):
    """The module ``generators/<kind>.py``."""
    return importlib.import_module(f'portbench.generators.{kind}')


def layer_reader(name: str):
    """The ``read`` function of ``layer_metrics/<name>.py`` (names carry
    dots, so the file is loaded by path)."""
    path = HERE / 'layer_metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        f'portbench_layer_metric_{name.replace(".", "_")}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
