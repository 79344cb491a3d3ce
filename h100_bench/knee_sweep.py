"""The serve cell's knee: the highest Poisson rate the port sustains
without a growing backlog, found once by a sweep on the card.

    python3 h100_bench/knee_sweep.py --workload sd3-medium-bf16.serve-poisson-512 \
        --rates 0.7,0.8,0.9,1.0,1.1,1.2 --seconds 51 --seeds 1,2 [--out knee.jsonl]

One process builds the cell's pipeline and server once, then offers each
rate for ``--seconds`` (the cell's open loop, ``drivers.serve``). A rate is
sustained when every request due in the window completes within it plus
its last request's service, and the median latency of the last third of
the arrivals is within 1.25x that of the first third (no growing queue).
The rate written into the cell's file is 0.8 x the highest sustained rate,
with the card's name and power limit beside it (PERF.md).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

import run  # noqa: E402


def thirds(latency_by_due):
    n = len(latency_by_due)
    if n < 6:
        return None, None
    import numpy as np

    first = float(np.median([lat for _, lat in latency_by_due[: n // 3]]))
    last = float(np.median([lat for _, lat in latency_by_due[-(n // 3):]]))
    return first, last


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seeds", default=None,
                    help="comma-separated seeds, each run at every rate (default: --seed + i)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    import build
    import drivers

    c = run.load_cell(args.workload)
    cell, config = c["cell"], c["config"]
    pipe = build.build(config, args.seed, "cuda", cell)
    limit = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True).stdout
    runs = [(float(r), int(s)) for r in args.rates.split(",")
            for s in (args.seeds.split(",") if args.seeds else [None])]
    for i, (rate, seed) in enumerate(runs):
        seed = args.seed + i if seed is None else seed
        res = drivers.serve(pipe, cell, seed, args.seconds, False, "cuda",
                            lambda: None, rate=rate)
        first, last = thirds(res.latency_by_due)
        sustained = (res.failed == 0 and first is not None and last <= 1.25 * first)
        row = {"rate": rate, "seed": seed, "seconds": args.seconds, "attempted": res.attempted,
               "failed": res.failed, **res.e2e, "first_third_median_s": first,
               "last_third_median_s": last, "sustained": sustained,
               "batches": res.server["batches"], "served": res.server["served"],
               "card": limit.strip(), "notes": res.notes[-1]}
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
