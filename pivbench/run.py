"""Run one cell of the benchmark once and print its result line.

    python3 -m pivbench.run --workload ls_hs_512.stream --seed 7 --seconds 51 --trace 0

from the root of a checkout, on a machine with the cards the cell asks for.
``--trace 0`` times the window and prints the cell's end-to-end metrics;
``--trace 1`` traces a short window and prints its per-layer metrics.  The
last line of standard output is one JSON object; the numbers that decide
``correct`` are the last lines of standard error.  Without a card, or with
fewer than the cell asks for, it prints no result and exits 2; with JAX or
the JAX package loaded once the window has closed, it exits 3; where the
trace does not see all the device work that its metrics read, it exits 4.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "opticalflow_ri_tpu"}


def loaded_forbidden() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every build and kernel cache of this run stays in the checkout
    cache = CHECKOUT / "build" / "pivbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    import torch

    from pivbench import harness, spec

    cell = spec.load_cell(args.workload, CHECKOUT / "BENCHMARK.json")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                              T_PROCESS)
    found = loaded_forbidden()
    if found:
        print(f"JAX or the JAX package was loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    faults = result.pop("trace_faults", [])
    for fault in faults:
        print(f"trace fault: {fault}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    if faults:
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
