"""The readings that the limits of ``correct`` are set from, for one cell, in
one process on the card:

    python3 -m pivbench.calibrate --workload ls_hs_512.stream \
        --seeds 11 12 ... --control-seeds 21 22 23

For each ``--seeds`` seed, the program's flows of the cell's pool, one pass
of the cell's mix (every pair once, as many as a run compares), against the
reference; for each ``--control-seeds`` seed, the control: the reference in
the precision below the configuration's (its ``control``), put in the
program's place.  Prints one JSON line a seed and a summary: the largest
reading of the program and the smallest of the control, number by number.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from pivbench import check, spec
from pivbench.drive import Driver
from pivbench.generator import make_pool


def pool(cell: spec.Cell, seed: int, dev: torch.device):
    a, b, _ = make_pool(cell.config, seed, int(cell.traffic["pool"]), dev)
    return a.cpu().numpy(), b.cpu().numpy()


def program_numbers(cell: spec.Cell, seed: int, dev: torch.device) -> dict:
    """The program's numbers for the pool of ``seed``: every unit of the mix
    called once, each flow held against the reference."""
    im1s, im2s = pool(cell, seed, dev)
    driver = Driver(cell.traffic, cell.config["registry"], im1s, im2s, dev)
    flows = {}
    for i in range(len(driver.units)):
        c, _ = driver.call(i)
        for j, k in enumerate(c.pairs):
            flows[k] = (c.u[j], c.v[j])
    ref = check.reference_flows(cell.config, im1s, im2s, range(im1s.shape[0]), dev)
    return check.compare(flows, ref)


def control_numbers(cell: spec.Cell, seed: int, dev: torch.device) -> dict:
    """The control's numbers for the pool of ``seed``: the reference in the
    configuration's ``control`` precision in the program's place."""
    cfg = cell.config
    im1s, im2s = pool(cell, seed, dev)
    idx = range(im1s.shape[0])
    flows = {i: (u.cpu(), v.cpu()) for i, u, v, _ in
             check.reference_flows(cfg, im1s, im2s, idx, dev, precision=cfg["control"])}
    return check.compare(flows, check.reference_flows(cfg, im1s, im2s, idx, dev))


def _line(kind: str, seed: int, numbers: dict) -> dict:
    out = {"kind": kind, "seed": seed, "pairs": numbers["pairs"]}
    out.update({k: numbers[k] for k in check.NUMBERS})
    steps = sorted({e["count"] for entries in numbers["tally"].values() for e in entries
                    if e["stage"] == "ls_iterate"})
    if steps:
        out["ls_steps"] = steps
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    cell = spec.load_cell(args.workload, root / "BENCHMARK.json")
    if not torch.cuda.is_available():
        print("the readings are taken on the card; no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    lines = []
    for kind, seeds, fn in (("program", args.seeds, program_numbers),
                            ("control", args.control_seeds, control_numbers)):
        for s in seeds:
            lines.append(_line(kind, s, fn(cell, s, dev)))
            print(json.dumps(lines[-1]), flush=True)
    summary = {"workload": args.workload, "device": torch.cuda.get_device_name(dev)}
    for k in check.NUMBERS:
        prog = [ln[k] for ln in lines if ln["kind"] == "program"]
        ctrl = [ln[k] for ln in lines if ln["kind"] == "control"]
        summary[k] = {"program_max": max(prog, default=None),
                      "control_min": min(ctrl, default=None)}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
