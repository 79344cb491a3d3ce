"""Shared fixtures of the benchmark's CPU tests: the harness's folder on
``sys.path`` and a repository root in a temporary directory whose
BENCHMARK.json lists the tiny cells of ``fixtures/``."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FIXTURES = Path(__file__).resolve().parent / "fixtures"
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# tiny cell -> the cell of BENCHMARK.json whose metrics it reports
TINY = {
    "tiny-sd3.batch": ("tiny-sd3", "sd3-medium-bf16.batch4-512"),
    "tiny-sd3-bf16.batch": ("tiny-sd3-bf16", "sd3-medium-bf16.batch4-512"),
    "tiny-sd3.serve": ("tiny-sd3", "sd3-medium-bf16.serve-poisson-512"),
    "tiny-flux.batch": ("tiny-flux", "flux-schnell-w4a8.batch4-1024"),
    "tiny-flux.img2img": ("tiny-flux", "flux-schnell-w4a8.img2img-1024"),
}


def tiny_benchmark() -> dict:
    """BENCHMARK.json with the tiny cells in place of the real ones."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs = sorted({c for c, _ in TINY.values()})
    bench["configs"] = [{"name": c, "source": "tiny", "file": f"h100_bench/configs/{c}.json",
                         "reduced": [], "why": "CPU test"} for c in configs]
    bench["workloads"] = [{"name": t, "config": c, "traffic": t.split(".")[1], "chips": 1,
                           "why": "CPU test"} for t, (c, _) in TINY.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [t for t, (_, real) in TINY.items() if real in m["workloads"]]
    return bench


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("root")
    (root / "h100_bench").mkdir()
    shutil.copytree(FIXTURES / "configs", root / "h100_bench" / "configs")
    shutil.copytree(FIXTURES / "workloads", root / "h100_bench" / "workloads")
    (root / "BENCHMARK.json").write_text(json.dumps(tiny_benchmark()))
    return root


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skipped on a machine without one")
