"""Nothing the benchmark loads has the top-level name of JAX or of the JAX
package; the names are compared whole, since ``diffusionkit_tpu_torch``
begins with ``diffusionkit_tpu``."""

from __future__ import annotations

import subprocess
import sys

from conftest import BENCH, ROOT

import run

MODULES = ["run", "build", "check", "drivers", "traffic", "trace", "spans", "weights",
           "yardstick", "faults", "control", "knee_sweep", "plain",
           "diffusionkit_tpu_torch.pipeline", "diffusionkit_tpu_torch.serve"]


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "diffusionkit_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert "diffusionkit_tpu_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "diffusionkit_tpu.ops", object())
    assert "diffusionkit_tpu.ops" in run.forbidden_modules()


def test_harness_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r, %r]; " % (str(BENCH), str(BENCH / "reference"),
                                                          str(ROOT))
            + "; ".join(f"import {m}" for m in MODULES)
            + "; import run; print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result(tmp_path):
    """Without a card the run exits non-zero and prints nothing to stdout."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "sd3-medium-bf16.batch4-512", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
