"""The plain reference at a tiny size on the CPU: the program's images
agree with it through the whole harness (set-up, window, check); the
control, the reference one precision step down, does not; and a run whose
timed path is broken underneath comes out not correct.

The CPU runs the port's plain versions of its kernels, so these tests hold
the harness and the reference, not the kernels; on the card the same check
holds the kernels (PERF.md gives the readings of both).
"""

from __future__ import annotations

import pytest

import control
import run

SEED = 2**31 + 4242


@pytest.mark.parametrize("cell", ["tiny-sd3.batch", "tiny-sd3-bf16.batch", "tiny-flux.batch",
                                  "tiny-flux.img2img", "tiny-sd3.serve"])
def test_program_agrees_with_reference(tiny_root, cell):
    out = run.run(cell, SEED, 1.0, False, device="cpu", root=tiny_root)
    assert out["correct"], out["check"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "check"


@pytest.mark.parametrize("cell", ["tiny-sd3-bf16.batch", "tiny-flux.batch"])
def test_control_fails(tiny_root, cell):
    keep = {}
    out = run.run(cell, SEED, 0.5, False, device="cpu", root=tiny_root, keep=keep)
    errs = control.control_err(keep, SEED, keep["config"]["control"], "cpu")
    assert any(errs[k] > out["check"][k]["limit"] for k in errs)
    assert all(out["check"][k]["limit"] > out["check"][k]["value"] for k in errs)


FAULTS = [(cell, fault) for cell in ("tiny-sd3.batch", "tiny-flux.batch", "tiny-flux.img2img",
                                     "tiny-sd3.serve")
          for fault in ("step_unchanged", "half_batch", "answer_altered")
          if fault != "half_batch" or cell.endswith(".batch")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_broken_timed_path_is_not_correct(tiny_root, cell, fault):
    """Each fault a cell can have: a step that returns its latents unchanged,
    half of a batch left out (the batched entries), an image altered where
    it is decoded. The cells run on one card: no exchange to leave out."""
    out = run.run(cell, SEED, 0.5, False, device="cpu", fault=fault, root=tiny_root)
    assert not out["correct"]
    assert out["check"]["image_err"]["value"] > out["check"]["image_err"]["limit"]


def test_traced_run_reads_its_metrics(tiny_root):
    out = run.run("tiny-flux.img2img", SEED, 3.0, True, device="cpu", root=tiny_root)
    assert out["correct"]
    for name in ("denoise_ms_per_step", "text_encode_ms", "vae_decode_ms", "vae_encode_ms"):
        assert out["metrics"][name]["value"] > 0
