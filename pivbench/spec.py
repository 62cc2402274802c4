"""What a cell is made of, found by name under the benchmark's folder.

    BENCHMARK.json           the cells, their metrics and bounds
    pivbench/configs/<config>.json    a deployment: registry name, sizes,
                                      particle statistics, the reference's
                                      recipe and the limits of ``correct``
    pivbench/traffic/<mix>.json       a traffic mix: which entry, the pool,
                                      the stack, the traced calls
    pivbench/metrics/<metric>.py      a per-layer metric's reader
    pivbench/stages/<stage>/*.txt     a roofline stage's kernel names, one a
                                      line, any number of files

A later change adds a configuration, a mix, a metric or a stage's kernel by
adding a file; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    root: Path = field(default=PACKAGE_DIR)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_benchmark(bench_file: Path) -> dict:
    with open(bench_file) as f:
        return json.load(f)


def load_cell(name: str, bench_file: Path, root: Path = PACKAGE_DIR) -> Cell:
    """The cell ``name`` of ``bench_file``, its files read from ``root``
    (the benchmark's folder)."""
    bench = load_benchmark(bench_file)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_file}; there are {sorted(cells)}")
    w = cells[name]
    with open(root / "configs" / f"{w['config']}.json") as f:
        config = json.load(f)
    with open(root / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)], root)


def stages(root: Path = PACKAGE_DIR) -> dict:
    """stage -> the kernel names its files list."""
    out: dict = {}
    for d in sorted(p for p in (root / "stages").iterdir() if p.is_dir()):
        names = out.setdefault(d.name, [])
        for f in sorted(d.glob("*.txt")):
            names += [ln.strip() for ln in f.read_text().splitlines()
                      if ln.strip() and not ln.startswith("#")]
    return out


def module(metric: str, root: Path = PACKAGE_DIR):
    """The module ``metrics/<metric>.py``: its ``read(ctx)``, and the
    ``STAGE`` whose kernels it reads, if it reads one."""
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"pivbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = PACKAGE_DIR):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    return module(metric, root).read
