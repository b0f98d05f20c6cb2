"""Run one cell of the port's benchmark on the card.

    python3 -m streambench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. Prints, last on standard output, one JSON
line: ``correct``, ``attempted`` and ``failed`` (rows due and rows
wrong), the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics (``--trace 1``, with ``breakdown``), ``device``, and last
``check``: each number compared with its limit, which standard error's
last lines repeat. Exits non-zero and prints no result without a CUDA
card or with fewer than the cell's chips, or if JAX or the JAX package
was loaded. ``--control 1`` runs the configuration's control, the
program's own lower-precision path, which must come out not correct.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# every build and kernel cache inside the checkout, at fixed paths (the
# port's kernels and parser build into build/ there already)
CACHES = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "TRITON_CACHE_DIR": "build/triton",
          "CUDA_CACHE_PATH": "build/cuda_cache"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, rel in CACHES.items():
        os.environ[var] = str(CHECKOUT / rel)

    from streambench.harness import Cell, forbidden_modules, run_cell

    cell = Cell(args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"streambench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), found {have}", file=sys.stderr)
        return 2
    result, _ = run_cell(cell, args.seed, args.seconds, trace=bool(args.trace),
                         control=bool(args.control), t_start=T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"streambench: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
