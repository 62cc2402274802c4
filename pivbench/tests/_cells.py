"""Cells of the benchmark at a size a CPU test run holds."""

from __future__ import annotations

import time
from pathlib import Path

from pivbench import drive, harness, spec

CHECKOUT = Path(__file__).resolve().parents[2]


def small_cell(name: str, size: int = 48, pool: int = 4, stack: int = 2,
               bench: Path = CHECKOUT / "BENCHMARK.json", root: Path = spec.PACKAGE_DIR):
    """The cell ``name`` with its frames cut to size x size and its pool to
    ``pool`` pairs (stacks of ``stack``); everything else as committed."""
    cell = spec.load_cell(name, bench, root)
    cell.config.update(height=size, width=size, reference_block=pool)
    cell.traffic.update(pool=pool, trace_calls=2)
    if cell.traffic["entry"] == "scan":
        cell.traffic["stack"] = stack
    return cell


def rehearse(cell, seed: int = 2**31 + 5, seconds: float = 0.5, trace: bool = False) -> dict:
    """One run of ``cell`` on the CPU, everything but the look for a card,
    with no warm-up beyond the loop's first two calls."""
    saved, drive.WARM_SECONDS = drive.WARM_SECONDS, 0.0
    try:
        return harness.run_cell(cell, seed, seconds, trace, "cpu", time.time())
    finally:
        drive.WARM_SECONDS = saved
