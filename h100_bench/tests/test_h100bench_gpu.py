"""On the card: one short run of each cell prints a result line of the
contract's shape. Run there with
``python3 -m pytest h100_bench/tests -m gpu``."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCHMARK["workloads"]])
def test_cell_runs_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", cell, "--seed",
                          "2147483659", "--seconds", "5", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(res) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert "setup_s" in res["metrics"]
