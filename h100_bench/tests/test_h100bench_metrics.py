"""The metric arithmetic: a rate over the whole window, a tail over every
request from its due time, the least time of ``denoise_mfu`` and the
rooflines, and the trace's busy time and spans."""

from __future__ import annotations

import importlib.util
import json

import numpy as np
import pytest

from conftest import BENCH

import drivers
import trace
import yardstick

SD3 = json.loads((BENCH / "configs" / "sd3-medium-bf16.json").read_text())
FLUX = json.loads((BENCH / "configs" / "flux-schnell-w4a8.json").read_text())


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"m_{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cfg,hw,txt,cfg_on", [(SD3, (64, 64), 154, True),
                                               (FLUX, (128, 128), 256, False)])
def test_frozen_flops_match_the_port(cfg, hw, txt, cfg_on):
    from diffusionkit_tpu_torch import flops
    import build

    port = flops.mmdit_step_flops(build.mmdit_config(cfg["mmdit"]), hw, txt, 4, cfg_on)
    ours = yardstick.mmdit_step_flops(cfg["mmdit"], hw, txt, 4, cfg_on)
    assert ours["total"] == pytest.approx(port["total"], rel=1e-12)
    assert ours["attention"] == pytest.approx(port["attention"], rel=1e-12)
    assert ours["block_linears"] + ours["io_linears"] == pytest.approx(port["projections"])


def test_denoise_mfu_least_time():
    ctx = {"config": SD3, "cell": {"traffic": {"height": 512, "width": 512, "cfg": 5.0,
                                               "batch": 4}, "model_batch": 4},
           "spans": {"iterations": 2, "denoise": 2 * 50 * 0.035, "steps_per_iteration": 50}}
    f = yardstick.mmdit_step_flops(SD3["mmdit"], (64, 64), 154, 4, True)
    want = 100 * f["total"] / 989e12 / 0.035
    assert _reader("denoise_mfu").read(ctx) == pytest.approx(want, rel=1e-9)
    assert 40 < want < 43  # 14.42 TFLOP a step at 35 ms: ~42 %
    assert _reader("denoise_ms_per_step").read(ctx) == pytest.approx(35.0)


def test_w4a8_least_time_takes_the_int8_peak():
    f = yardstick.mmdit_step_flops(FLUX["mmdit"], (128, 128), 256, 4, False)
    least = yardstick.step_least_seconds(FLUX["mmdit"], (128, 128), 256, 4, False, "int8", 0.5)
    want = f["block_linears"] / 1979e12 + f["io_linears"] / 989e12
    assert least["linears"] == pytest.approx(want, rel=1e-9)  # bound by operations
    assert least["attention"] == pytest.approx(f["attention"] / 989e12, rel=1e-9)


def test_rate_and_tail_over_all_requests():
    """images_per_min is every image over all the window; the tail ranks
    every request due, a failed one as infinitely late."""
    lats = sorted([1.0] * 90 + [5.0] * 9) + [float("inf")]
    rank = lambda q: drivers.rank(lats, q)  # noqa: E731
    assert rank(0.5) == 1.0 and rank(0.9) == 1.0 and rank(0.95) == 5.0 and rank(1.0) == np.inf


def test_trace_busy_gaps_and_spans():
    dev = [("spin_kernel", 0.0, 0.001), ("nvjet_gemm", 0.002, 0.010),
           ("spin_kernel", 0.010, 0.011), ("flash_fwd_sm90<64, false>", 0.012, 0.020),
           ("w4a8_mm_sm90<0, 128>", 0.020, 0.030), ("spin_kernel", 0.031, 0.032),
           ("flash_fwd_wide_sm90<false>", 0.032, 0.040), ("spin_kernel", 0.040, 0.041)]
    busy, gaps = trace.busy_and_gaps(dev)
    assert busy == pytest.approx(0.041 - 0.003) and len(gaps) == 3
    spans = trace.span_of_kernels(dev, ["text_pre", "text_post", "decode_pre", "decode_post"])
    assert spans == [("text", "nvjet_gemm", pytest.approx(0.008)),
                     ("denoise", "flash_fwd_sm90<64, false>", pytest.approx(0.008)),
                     ("denoise", "w4a8_mm_sm90<0, 128>", pytest.approx(0.010)),
                     ("decode", "flash_fwd_wide_sm90<false>", pytest.approx(0.008))]
    assert trace.is_joint_attention("flash_fwd_sm90<64, false>")
    assert not trace.is_joint_attention("flash_fwd_wide_sm90<false>")
    assert trace.is_linear("w4a8_mm_sm90<0, 128>") and trace.is_linear("nvjet_tst_128x256")
    assert not trace.is_linear("mod_ln_kernel<bf16>")


def test_kernel_data_files_name_only_what_the_frozen_map_leaves(tmp_path, monkeypatch):
    """A ``kernels/*.json`` file sorts a kernel the frozen map calls "other";
    it cannot move one the frozen map already sorts."""
    (tmp_path / "later.json").write_text(json.dumps({"family": {
        "gemm": "other", "flash_fwd": "w4a8_matmul", "fused_block_sm90": "w4a8_matmul"}}))
    monkeypatch.setattr(trace, "EXTRA", trace._extra_families(tmp_path))
    assert trace.family("nvjet_tst_256x128_gemm_bias") == "gemm"
    assert trace.family("flash_fwd_sm90<64, false>") == "flash_attention_bshd"
    assert trace.family("fused_block_sm90<1>") == "w4a8_matmul"
    assert trace.is_linear("fused_block_sm90<1>")
    assert trace.family("elementwise_kernel") == "other"


def test_rooflines_and_idle_read_the_trace():
    ctx = {"config": SD3, "cell": {"traffic": {"height": 512, "width": 512, "cfg": 5.0,
                                               "batch": 4}, "model_batch": 4, "steps_run": 50},
           "trace": {"markers_seen": 4, "markers_sent": 4, "iterations": 1, "busy_s": 1.9,
                     "window_s": 2.0, "span_device_s": {"denoise.attention": 0.3,
                                                        "denoise.linear": 1.2}}}
    least = yardstick.cell_step(ctx)
    assert _reader("attn_roofline").read(ctx) == pytest.approx(100 * least["attention"] * 50 / 0.3)
    assert _reader("linear_roofline").read(ctx) == pytest.approx(100 * least["linears"] * 50 / 1.2)
    assert _reader("device_idle").read(ctx) == pytest.approx(5.0)
    ctx["trace"]["markers_seen"] = 3  # a marker lost: the spans cannot be told apart
    assert _reader("attn_roofline").read(ctx) is None
