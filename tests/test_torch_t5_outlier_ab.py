"""``diffusionkit_tpu_torch/tools/t5_outlier_ab.py`` against the JAX
package on the CPU, at tests/test_torch_w8a8.py's tiny T5 (d_model 256, two
layers).

The same float weights with the same outlier channels (the tool's
``inject_t5_outliers`` on the port's model; the same channels scaled in
the JAX tree) go through the tool's ``ab`` and through the JAX functions:
``w8a8_tree`` plain, and ``w8a8_tree`` of ``smoothquant_fold_t5_host`` on
``t5_calibration_stats_host`` of the same calibration tokens, under the
JAX package's fused quantizers in interpret mode
(tests/test_torch_w8a8.py's ``jax_fused``). The outputs agree up to int8
flips (XLA contracts some epilogue products into FMAs): each SNR on the
non-outlier channels (the gate's measure) within 0.05 dB of the JAX one
(0.008 dB apart here), on all channels within 0.25 dB (0.10 dB here: the
error there sits in the few hot channels, where one flip weighs more).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionkit_tpu.models import init_t5_params
from diffusionkit_tpu.models.t5 import apply_t5_encoder
from diffusionkit_tpu.ops import smoothquant as jsq
from diffusionkit_tpu.ops import w8a8 as jw8
from diffusionkit_tpu_torch import config as tcfg
from diffusionkit_tpu_torch.convert import t5_from_jax
from diffusionkit_tpu_torch.ops.smoothquant import calibration_tokens
from diffusionkit_tpu_torch.tokenizer import SyntheticT5Tokenizer
from diffusionkit_tpu_torch.tools import t5_outlier_ab as ab_tool
from diffusionkit_tpu_torch.tools.quant_quality import inject_t5_outliers, t5_outlier_channels

from test_torch_gptq import two_intra_op_threads  # noqa: F401 (a fixture)
from test_torch_models import randomize, torch_config
from test_torch_w8a8 import T5_TINY
from test_torch_w8a8 import jax_fused  # noqa: F401 (a fixture)

SNR_TOL_DB = {"w8a8_plain": 0.05, "w8a8_smooth": 0.05,
              "w8a8_plain_all_channels": 0.25, "w8a8_smooth_all_channels": 0.25}


def jax_snr(got, want, keep=None):
    return ab_tool.snr_db(np.asarray(got), np.asarray(want), keep)


@pytest.mark.parametrize("n_out,factor", [(2, 100.0), (16, 50.0)], ids=["2x100", "16x50"])
def test_t5_outlier_ab_matches_jax(jax_fused, n_out, factor):  # noqa: F811
    params = randomize(init_t5_params(jax.random.PRNGKey(0), T5_TINY), seed=21)
    for ln in (params["layers"]["ln1"], params["layers"]["ln2"], params["final_ln"]):
        ln["weight"] = np.asarray(ln["weight"]) + 1.0
    model = t5_from_jax(params, torch_config(T5_TINY, tcfg.T5Config), device="cpu")
    channels = inject_t5_outliers(model, n_out, factor)
    assert np.array_equal(channels, t5_outlier_channels(T5_TINY.d_model, n_out))
    hot = jax.tree.map(np.array, params)
    hot["wte"][:, channels] *= factor
    hot["layers"]["wo"]["kernel"][..., channels] *= factor
    carried = t5_from_jax(hot, torch_config(T5_TINY, tcfg.T5Config), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 carried.state_dict().values()))

    tokenizer = SyntheticT5Tokenizer(max_length=32, vocab_size=T5_TINY.vocab_size)
    tokens = ab_tool.tokens_of(tokenizer, ab_tool.PROMPTS, 32)
    got = ab_tool.ab(model, tokens, channels, tokenizer)

    want = np.asarray(apply_t5_encoder(hot, jnp.asarray(tokens), T5_TINY))
    keep = np.setdiff1d(np.arange(T5_TINY.d_model), channels)
    plain = apply_t5_encoder(jw8.w8a8_tree(hot), jnp.asarray(tokens), T5_TINY)
    calib = calibration_tokens(T5_TINY.vocab_size, tokenizer)
    stats = jsq.t5_calibration_stats_host(hot, calib, T5_TINY)
    smooth = apply_t5_encoder(jw8.w8a8_tree(jsq.smoothquant_fold_t5_host(hot, stats, alpha=0.5)),
                              jnp.asarray(tokens), T5_TINY)
    ref = {"w8a8_plain": jax_snr(plain, want, keep), "w8a8_smooth": jax_snr(smooth, want, keep),
           "w8a8_plain_all_channels": jax_snr(plain, want),
           "w8a8_smooth_all_channels": jax_snr(smooth, want)}
    for key, value in ref.items():
        assert abs(got[key] - value) <= SNR_TOL_DB[key], (key, got[key], value)
    assert abs(got["margin_db"] - (ref["w8a8_smooth"] - ref["w8a8_plain"])) <= 0.1
    # The fold helps on these outliers, on both sides.
    assert got["margin_db"] > 0 and ref["w8a8_smooth"] > ref["w8a8_plain"]
    # The model handed in is left as it was (the copies were converted).
    assert not any(type(m).__name__ == "W8A8Linear" for m in model.modules())


def test_t5_outlier_ab_run_writes_its_report(tmp_path):
    """``run`` at a two-layer T5 of width 256 on the CPU: the report's keys,
    written to its file."""
    cfg = tcfg.T5Config(vocab_size=512, d_model=256, d_kv=32, d_ff=512, num_layers=2,
                        num_heads=4)
    out = tmp_path / "ab.json"
    report = ab_tool.run(device="cpu", config=cfg, n_out=4, factor=50.0, out_path=str(out))
    saved = json.loads(out.read_text())
    assert saved == json.loads(json.dumps(report))
    assert saved["t5_outlier_channels"] == 4 and saved["d_model"] == 256
    for key in ("w8a8_plain", "w8a8_smooth", "margin_db", "w8a8_plain_all_channels",
                "w8a8_smooth_all_channels"):
        assert np.isfinite(saved[key])
    assert saved["margin_db"] == pytest.approx(saved["w8a8_smooth"] - saved["w8a8_plain"])
