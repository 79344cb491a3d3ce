"""The control of a cell's check: the plain reference put in the program's
place and computed one precision step below the configuration's (bf16 ->
float8 e4m3 operands; w4a8 / w8a8 -> activations on 4 bits; a float32 model,
the img2img encoder -> TF32), on the same sample of requests that a run of
the program compared, in one process.

    python3 h100_bench/control.py --workload <cell> --seeds 1,2,3 --seconds 10 \
        [--precision fp8|fp8a4] [--also bf16] [--out control.jsonl]

For each seed it prints (and appends to ``--out``) the program's numbers
compared (``check.errors``) and the control's, each against the fp32
reference: the lower and the upper readings from which a cell's limits
are set (PERF.md).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import run  # noqa: E402


def control_err(keep, seed: int, precision: str, device) -> dict:
    import check

    reqs = [o["request"] for o in keep["sample"]]
    ctl = check.reference_images(keep["config"], keep["cell"], seed, reqs, precision, device)
    return check.errors(ctl, keep["reference"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--precision", default=None,
                    help="fp8 or fp8a4 (default: the configuration's control)")
    ap.add_argument("--also", default=None,
                    help="further precisions read on the same sample, e.g. bf16")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        keep = {}
        t0 = time.perf_counter()
        out = run.run(args.workload, seed, args.seconds, False, device="cuda", keep=keep)
        prec = args.precision or keep["config"].get("control", "fp8")
        row = {"workload": args.workload, "seed": seed,
               "program": {k: v["value"] for k, v in out["check"].items()},
               "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
        t1 = time.perf_counter()
        row["control"] = prec
        row["control_errors"] = control_err(keep, seed, prec, "cuda")
        row["control_s"] = time.perf_counter() - t1
        for extra in (args.also.split(",") if args.also else []):
            row[extra + "_errors"] = control_err(keep, seed, extra, "cuda")
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
