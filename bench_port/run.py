"""Run one cell of the port's benchmark on the local CUDA cards.

    python3 bench_port/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Sets up (inputs and weights from the seed, the cell's shapes warmed),
measures whole rounds or steps for ``--seconds``, checks what the timed
path produced against the plain reference, and prints one JSON line
last on standard output; the compared numbers beside their limits are
the last lines on standard error.  Exits non-zero, printing no result,
without enough CUDA cards, and if JAX or the JAX package was loaded.
Kernel builds go to the program's own fixed build directory inside the
checkout (``src/repro_torch/_build``).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench_port import harness
    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from bench_port import flops
    record = harness.driver(cell.traffic["kind"]).run(
        cell, args.seed, args.seconds, bool(args.trace), device="cuda",
        t_start=T_START)
    record.part = flops.card_part(torch.cuda.get_device_name(0))
    return harness.emit(record, bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
