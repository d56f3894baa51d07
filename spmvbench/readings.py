"""The readings a cell's limits are set from, on the card at the cell's own
size, many seeds in one process:

    python3 spmvbench/readings.py --workload <cell> --seeds 1,2,3 [--control 1,2,3]

For each seed: the cell's set-up (``core.set_up``, as a run makes it), as
many units of its loop as a run samples, and the largest gap of each
compared number between the program's outputs and the f64 reference (the
lower reading).  For each ``--control`` seed, the same gaps of the
control: the reference computed one precision below the configuration's
(``reference.plain.LOWER``), put in the program's place (the upper
reading).  One JSON line a seed.  The benchmark's own runs never run
this.
"""

import json
import os
import sys

if __package__ in (None, ""):
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control", type=seeds, default=[])
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)

    import torch
    import spmv_tpu_torch as port
    from spmvbench import core
    from spmvbench.reference import plain

    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    bench = core.read_json(os.path.join(os.path.dirname(core.ROOT),
                                        "BENCHMARK.json"))
    c = core.cell_files(bench, args.workload)
    cfg, traffic = c.cfg, c.traffic
    dtype = getattr(torch, cfg["dtype"])
    for seed in sorted(set(args.seeds) | set(args.control)):
        inputs = core.set_up(c, seed, args.device)
        a = inputs.a
        loop = c.loop.make(port, inputs.h, a, cfg, traffic, seed,
                           args.device)
        items = [loop.unit(None)[2] for _ in range(traffic["samples"])]
        loop.release()
        inputs.h = inputs.mat = None
        torch.cuda.empty_cache()
        ref = plain.Csr(a, torch.float64, args.device)
        want = [loop.reference(ref, it) for it in items]
        line = {"workload": args.workload, "seed": seed}
        if seed in args.seeds:
            line["program"] = worst(loop.gaps(it, w)
                                    for it, w in zip(items, want))
        if seed in args.control:
            low = plain.Csr(a, plain.LOWER[dtype], args.device)
            line["control"] = worst(loop.gaps(loop.reference(low, it), w)
                                    for it, w in zip(items, want))
        print(json.dumps(line), flush=True)
    return 0


def worst(gaps):
    out = {}
    for g in gaps:
        for k, v in g.items():
            out[k] = max(out.get(k, 0.0), v if v == v else float("inf"))
    return out


if __name__ == "__main__":
    sys.exit(main())
