"""Run one cell of the benchmark once, from the root of a checkout:

    python3 spmvbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(``python3 -m spmvbench.run ...`` is the same.)  Prints the run's numbers
on standard error, each compared number beside its limit last, and as the
last line of standard output one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and ``checks`` last.  Without a CUDA card, or with fewer
cards than the cell asks for, it exits 2 having measured nothing.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    # run as a script: the checkout's root, not this folder, on the path
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from spmvbench import core
    bench = core.read_json(os.path.join(os.path.dirname(core.ROOT),
                                        "BENCHMARK.json"))
    chips = core.by_name(bench["workloads"], args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"spmvbench: the cell needs {chips} CUDA card(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = core.run_cell(bench, args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda:0", T_START)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
