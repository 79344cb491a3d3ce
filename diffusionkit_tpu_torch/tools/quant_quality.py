"""Image quality of every quantize mode against the bf16 pipeline.

Counterpart of the JAX repo's ``tools/quant_quality.py``: the same float
SD3-medium (from ``DIFFUSIONKIT_TPU_CKPT_DIR``) generates one pinned prompt
once in bf16 and once per quantize mode at the same seed, and each image's
PSNR against the bf16 one is reported beside the mode's wall time and its
quantizer (GPTQ for int4, w4a8 and both ``-mixed`` modes by default, the
ALS grid under ``DIFFUSIONKIT_TPU_GPTQ=0``, min/max for int8; w8a8
converts per channel) with its conversion seconds. The JAX package's gate
on this table is its ``tests/test_quant_quality.py`` (256², 6 steps: int8
at least 38 dB, w8a8 31). ``--t5`` measures the w8a8 T5 instead, on
FLUX.1-schnell w4a8, with heavy-tailed outlier channels injected into the
T5 before both runs.

    DIFFUSIONKIT_TPU_CKPT_DIR=... python -m diffusionkit_tpu_torch.tools.quant_quality \\
        [--steps 10] [--size 512] [--out quant_quality.json] [--modes int8,w8a8] \\
        [--deadline-epoch N] [--device cpu]
    DIFFUSIONKIT_TPU_CKPT_DIR=... python -m diffusionkit_tpu_torch.tools.quant_quality --t5 \\
        --steps 4 [--t5-outliers 16] [--t5-outlier-factor 50] [--t5-no-smooth]

It runs on the card unless given ``--device cpu``. The table is written to
``--out`` after every mode, so a run stopped between modes (``--deadline-
epoch``: no mode starts past that unix time) leaves a valid file. The
quantized-model disk cache is used as the pipelines use it, but not by the
``--t5`` leg, whose injection changes the T5 without changing the cache
key.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import FLUX_SCHNELL_VERSION, SD3_MEDIUM

MODEL = SD3_MEDIUM
PROMPT = "a photo of a cat in a wizard hat"
MODES = [None, "int8", "int4", "w8a8", "w4a8", "int4-mixed", "w4a8-mixed"]


def run(mode, steps, latent_hw, device="cuda", stats: Optional[dict] = None, **pipeline_kw):
    """One image of ``PROMPT`` (seed 42, CFG 5.0, ``steps`` steps, latents
    ``latent_hw``) from SD3-medium loaded and quantized by ``mode`` (None:
    bf16); returns it as float32 (H, W, 3) and the wall seconds, pipeline
    construction included. ``stats``, if given, gets the quantizer that ran
    (``pipe.quantizer``: its name and seconds, None for bf16).
    ``pipeline_kw`` go to ``DiffusionPipeline`` (``w16``, ``a16``)."""
    from ..pipeline import DiffusionPipeline

    t0 = time.time()
    pipe = DiffusionPipeline(model_version=MODEL, shift=3.0, use_t5=False, low_memory_mode=False,
                             quantize_mmdit=mode, device=device, **pipeline_kw)
    if stats is not None:  # the conversion ran at construction; a request resets it
        stats["quantizer"] = pipe.quantizer
    img, _ = pipe.generate_image(PROMPT, num_steps=steps, cfg_weight=5.0, latent_size=latent_hw,
                                 seed=42, verbose=False)
    del pipe
    return np.asarray(img, np.float32), time.time() - t0


def t5_outlier_channels(d_model: int, n_channels: int) -> np.ndarray:
    """The residual-stream channels the injection makes hot."""
    return np.random.RandomState(7).choice(d_model, n_channels, replace=False)


def inject_t5_outliers(model, n_channels: int, factor: float) -> np.ndarray:
    """``n_channels`` residual-stream channels of a T5 made ``factor``
    times hotter, in place (the embedding's columns and every layer's
    ``wo`` output rows), as a trained T5-XXL has a few channels one or two
    orders of magnitude above the rest: what per-token int8 clips. Returns
    the channels."""
    channels = t5_outlier_channels(model.wte.weight.shape[1], n_channels)
    idx = torch.as_tensor(channels, device=model.wte.weight.device)
    with torch.no_grad():
        model.wte.weight[:, idx] *= factor
        for layer in model.layers:
            layer.wo.weight[idx, :] *= factor
    return channels


def _install_t5_outlier_injection(n_channels: int, factor: float):
    """Wrap ``model_io.load_t5_encoder`` so the loaded T5 gets
    ``inject_t5_outliers``. Both the bf16 and the w8a8 run get the same
    injection, so their PSNR isolates the quantization. The T5's cache is
    turned off (its key is the untouched file's); the MMDiT's stays."""
    from .. import model_io

    orig = model_io.load_t5_encoder

    def load_with_outliers(dtype=torch.bfloat16, device="cuda"):
        model = orig(dtype, device=device)
        inject_t5_outliers(model, n_channels, factor)
        print(f"[t5-outliers] injected {n_channels} channels x{factor}", flush=True)
        return model

    model_io.load_t5_encoder = load_with_outliers
    orig_cache = model_io.quant_cache_path
    model_io.quant_cache_path = lambda tag, src: (
        None if tag.startswith("t5_") else orig_cache(tag, src))


def run_flux_t5(quantize_t5, steps, latent_hw, device="cuda"):
    """FLUX.1-schnell w4a8 with a bf16 or a w8a8 T5 (``quantize_t5``), the
    T5 loaded for its phase and dropped after it (``low_memory_mode``);
    returns the image as float32 and the wall seconds."""
    from ..pipeline import FluxPipeline

    t0 = time.time()
    pipe = FluxPipeline(model_version=FLUX_SCHNELL_VERSION, shift=1.0, low_memory_mode=True,
                        quantize_mmdit="w4a8", quantize_t5=quantize_t5, device=device)
    img, _ = pipe.generate_image(PROMPT, num_steps=steps, cfg_weight=0.0, latent_size=latent_hw,
                                 seed=42, verbose=False)
    del pipe
    return np.asarray(img, np.float32), time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--out", default="quant_quality.json")
    ap.add_argument("--modes", default=None,
                    help="comma-separated subset of the modes (e.g. 'int4-mixed,w4a8-mixed'); "
                    "the bf16 base always runs first")
    ap.add_argument("--deadline-epoch", type=int, default=0,
                    help="unix time past which no new mode starts (the table is written after "
                    "every mode)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--t5", action="store_true",
                    help="measure the w8a8 T5 on FLUX.1-schnell w4a8 instead of the MMDiT mode "
                    "table (use --steps 4, schnell's schedule)")
    ap.add_argument("--t5-outliers", type=int, default=16, metavar="N",
                    help="inject N outlier channels (x the factor below) into the T5 before both "
                    "runs; 0 disables")
    ap.add_argument("--t5-outlier-factor", type=float, default=50.0)
    ap.add_argument("--t5-no-smooth", action="store_true",
                    help="disable the SmoothQuant fold (A/B the mitigation)")
    args = ap.parse_args(argv)

    if not os.environ.get("DIFFUSIONKIT_TPU_CKPT_DIR"):
        raise SystemExit("set DIFFUSIONKIT_TPU_CKPT_DIR to the checkpoint mirror")
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("quant_quality: no CUDA device (pass --device cpu for the CPU)")
    from ..utils import image_psnr

    latent_hw = (args.size // 8, args.size // 8)
    if args.t5:
        if args.t5_outliers:
            _install_t5_outlier_injection(args.t5_outliers, args.t5_outlier_factor)
        if args.t5_no_smooth:
            os.environ["DIFFUSIONKIT_TPU_T5_SMOOTH"] = "0"
        base, dt_base = run_flux_t5(False, args.steps, latent_hw, args.device)
        quant, dt_quant = run_flux_t5(True, args.steps, latent_hw, args.device)
        out = {
            "model": f"{FLUX_SCHNELL_VERSION} (w4a8 MMDiT)", "size": args.size,
            "prompt": PROMPT, "t5_outlier_channels": args.t5_outliers,
            "t5_outlier_factor": args.t5_outlier_factor, "smoothquant": not args.t5_no_smooth,
            "t5_w8a8_psnr_vs_bf16_t5_db": float(image_psnr(base, quant)),
            "wall_s": {"bf16_t5": dt_base, "w8a8_t5": dt_quant},
        }
        print(json.dumps(out), flush=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
        print("wrote", args.out, flush=True)
        return out
    modes = MODES
    if args.modes:
        wanted = {m.strip() for m in args.modes.split(",")}
        modes = [None] + [m for m in MODES if m in wanted]
    results = {}
    base = None
    for mode in modes:
        if args.deadline_epoch and time.time() > args.deadline_epoch:
            print(f"[deadline] skipping remaining modes from {mode or 'bf16'}", flush=True)
            break
        stats = {}
        img, dt = run(mode, args.steps, latent_hw, args.device, stats)
        name = mode or "bf16"
        q = stats["quantizer"]
        row = {"psnr_vs_bf16_db": None, "wall_s": dt,
               "quantizer": None if q is None else q["name"],
               "quantize_s": None if q is None else q["seconds"]}
        if base is None:
            base = img
        else:
            row["psnr_vs_bf16_db"] = float(image_psnr(base, img))
        results[name] = row
        print(json.dumps({name: row}), flush=True)
        with open(args.out, "w") as f:
            json.dump({"model": MODEL, "steps": args.steps, "size": args.size, "prompt": PROMPT,
                       "device": args.device, "modes": results}, f, indent=2)
    print("wrote", args.out, flush=True)
    return results


if __name__ == "__main__":
    main()
