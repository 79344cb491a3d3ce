"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name: ``BENCHMARK.json`` (at the repository root)
lists it, ``workloads/<cell>.json`` holds its entry and traffic,
``configs/<config>.json`` its configuration, and each per-layer metric
``metrics/<metric>.py`` its reader. With ``--trace 0`` the result carries
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics.
After the window the sampled outputs are compared with the plain reference
(``check.py``); the numbers compared and their limits are the result's last
key, ``check``, and the last lines on standard error.

Exits non-zero and prints no result when no CUDA card is there, or fewer
than the cell asks for, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

PROCESS_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "diffusionkit_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    jaxlib's, flax's or the JAX package's, compared whole."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(name: str, root: Path = ROOT) -> Dict:
    """The cell's entry in ``root``'s BENCHMARK.json with its file
    (``h100_bench/workloads/<cell>.json``) and its configuration's file."""
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = json.loads((root / "h100_bench" / "workloads" / f"{name}.json").read_text())
    cell["name"] = name
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    config["name"] = entry["config"]
    return {"bench": bench, "entry": entry, "cell": cell, "config": config}


def metrics_for(bench: Dict, cell_name: str, section: str) -> List[Dict]:
    """The metrics of ``section`` this cell reports."""
    return [m for m in bench[section] if cell_name in m.get("workloads", [cell_name])]


def read_metric(name: str, ctx: Dict) -> Optional[float]:
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def device_report(count: int, traced: Optional[Dict]) -> Dict:
    import torch

    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
           "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                        for i in range(count)))}
    if traced is not None:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
    return dev


def run(workload: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
        fault: Optional[str] = None, root: Path = ROOT, keep: Optional[Dict] = None) -> Dict:
    """One run of ``workload``: set-up, the window, the check. Returns the
    result object (without printing it). ``fault`` breaks the timed path
    underneath, for the test that sees ``correct`` come out false; ``keep``
    takes the compared sample, the reference's images, the configuration and
    the cell (``control.py``)."""
    import torch

    import build
    import check
    import drivers

    c = load_cell(workload, root)
    bench, cell, config = c["bench"], c["cell"], c["config"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_build = time.perf_counter()
    pipe = build.build(config, seed, device, cell)
    t_built = time.perf_counter()
    undo = None
    if fault:
        import faults

        undo = faults.plant(fault, pipe)
    setup = {}

    def setup_done():
        now = time.perf_counter()
        setup["s"] = now - PROCESS_T0
        log(f"set-up {setup['s']!r} s: start to build {t_build - PROCESS_T0!r} s, build "
            f"{t_built - t_build!r} s, warm-up {now - t_built!r} s")
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()

    try:
        res = drivers.ENTRIES[cell["entry"]](pipe, cell, seed, seconds, traced, device,
                                             setup_done)
    finally:
        if undo is not None:
            undo()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    dev = device_report(c["entry"]["chips"], res.trace) if torch.device(device).type == "cuda" \
        else {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    peak = dev["memory_peak_bytes"]
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of JAX or the JAX package were loaded: {bad}")
    res.e2e["setup_s"] = setup["s"]
    for note in res.notes:
        log(note)
    ctx = {"config": config, "cell": cell, "spans": res.spans, "trace": res.trace,
           "server": res.server, "peak_bytes": peak, "e2e": res.e2e}
    out_metrics = {}
    if traced:
        for m in metrics_for(bench, workload, "per_layer"):
            v = read_metric(m["name"], ctx)
            if v is not None:
                out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in metrics_for(bench, workload, "end_to_end"):
            out_metrics[m["name"]] = {"value": res.e2e[m["name"]], "unit": m["unit"]}
    # the program's state freed before the reference runs
    server = cell.pop("_server", None)
    if server is not None:
        server.pipeline = None
    del pipe, server
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    nums = check.compare(config, cell, seed, res.outputs, device, keep=keep)
    if keep is not None:
        keep.update(config=config, cell=cell)
    limits = cell["check"]
    log(f"check took {time.perf_counter() - t_check!r} s over {nums['compared']} images")
    folder = cell.pop("_cleanup", None)
    if folder:
        shutil.rmtree(folder, ignore_errors=True)
    compared = {k: {"value": nums[k], "limit": limits.get(k + "_limit")}
                for k in ("image_err",)}
    correct = bool(all(v["limit"] is not None and v["value"] <= v["limit"]
                       for v in compared.values())
                   and res.failed == 0 and nums["compared"] > 0)
    out = {"correct": correct, "attempted": res.attempted, "failed": res.failed,
           "metrics": out_metrics, "device": dev}
    if traced and res.trace is not None and res.trace.get("breakdown"):
        out["breakdown"] = res.trace["breakdown"]
    out["check"] = {**compared, "images_compared": {"value": nums["compared"], "limit": 1}}
    for k, v in out["check"].items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}"
            + (" (at least)" if k == "images_compared" else ""))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    need = load_cell(args.workload)["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"this cell needs {need} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or the JAX package were loaded: {bad}")
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
