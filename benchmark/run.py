"""Run one cell of the benchmark of tfhe_tpu_torch on the card.

    python3 benchmark/run.py --workload d128.gates.b1024 --seed 7 --seconds 30 --trace 0

Run from the root of a checkout.  One run sets the cell up from the seed,
measures for ``--seconds``, checks the outputs against the plain reference
(``benchmark/reference``) and prints one JSON line last on standard output:
the cell's end-to-end metrics with ``--trace 0``, its per-layer metrics from
a profiler trace of the whole window with ``--trace 1``.  ``--control`` runs
the cell's control impl in place of its impl (a lower-precision path the
check must refuse).  Without a card, or with fewer cards than the cell asks
for, it exits with status 2 and prints no result; it never falls back to the
CPU.  Where JAX or the JAX package is loaded once the window has closed
(the metric readers and the check included), it exits with status 3 and
prints no result.

A cell on more than one card (``"chips"`` in BENCHMARK.json) runs as one
process a card (``benchlib/ranks.py``), this one rank 0 on ``cuda:0``; it
starts the others before its own ``import torch``.  Where one of them ends
with a status other than 0, the run exits with status 4 and prints no
result.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache the program or torch could write goes to fixed directories of the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ.setdefault(var, str(ROOT / "build" / "bench_cache" / sub))
sys.path[0] = str(ROOT)  # the program's package and ``benchmark`` live at the root

from benchmark.benchlib import guard, ranks, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="run the cell's control impl (its check must come out false)")
    args = ap.parse_args(argv)

    cell = spec.load_cell(args.workload)
    marks = {"python_s": time.perf_counter() - T_START}
    group = None
    if cell.chips > 1:  # the other ranks load torch while this process does
        t = time.perf_counter()
        group = ranks.Ranks.start(cell.chips, "cuda")
        marks["spawn_s"] = time.perf_counter() - t
    t = time.perf_counter()
    import torch

    marks["import_torch_s"] = time.perf_counter() - t
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s), found {found}",
              file=sys.stderr, flush=True)
        if group is not None:
            group.abort()
        return 2
    t = time.perf_counter()
    from benchmark.benchlib import runner

    marks["import_program_s"] = time.perf_counter() - t
    guard.check_imports("after loading the cell")
    result = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), T_START, control=args.control, marks=marks,
                             group=group)
    guard.check_imports("before the result")
    runner.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
