"""``diffusionkit-tpu-torch-cli`` — text (and optional image) to image
generation on the card.

    python -m diffusionkit_tpu_torch.scripts.generate_images --prompt "a cat" \
        --model-version argmaxinc/mlx-stable-diffusion-3-medium -o out.png

The counterpart of ``diffusionkit_tpu/scripts/generate_images.py``, with its
flag surface (every option string, dest, default, choice, nargs and const):
the same per-model height/width/shift defaults, FLUX forces CFG off,
benchmark mode disables offloading and first runs a 1-step generation (it
builds the kernel library and captures a graph of that schedule; the real
run, with more sigmas, captures its own, which its ``capture_time`` shows).
``--num-images`` generates a batch of one prompt, ``--guidance`` sets
FLUX.1-dev's distilled guidance, ``--profile-dir`` writes a
``torch.profiler`` trace of the denoise phase and ``--use-scan`` runs the
denoise as a CUDA graph of one step replayed once a step.
"""

from __future__ import annotations

import argparse

import torch

from ..model_io import MMDIT_CKPT
from ..pipeline import DiffusionPipeline, FluxPipeline
from ..utils import get_logger

logger = get_logger(__name__)

# Per-model defaults (the reference CLI's tables).
HEIGHT = {
    "argmaxinc/mlx-stable-diffusion-3-medium": 512,
    "argmaxinc/mlx-stable-diffusion-3.5-large": 1024,
    "argmaxinc/mlx-stable-diffusion-3.5-large-4bit-quantized": 1024,
    "argmaxinc/mlx-FLUX.1-schnell": 512,
    "argmaxinc/mlx-FLUX.1-schnell-4bit-quantized": 512,
    "argmaxinc/mlx-FLUX.1-dev": 512,
}
WIDTH = dict(HEIGHT)
SHIFT = {
    "argmaxinc/mlx-stable-diffusion-3-medium": 3.0,
    "argmaxinc/mlx-stable-diffusion-3.5-large": 3.0,
    "argmaxinc/mlx-stable-diffusion-3.5-large-4bit-quantized": 3.0,
    "argmaxinc/mlx-FLUX.1-schnell": 1.0,
    "argmaxinc/mlx-FLUX.1-schnell-4bit-quantized": 1.0,
    "argmaxinc/mlx-FLUX.1-dev": 1.0,
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=(
            "Generate images from a text (and an optional image) prompt "
            "using Stable Diffusion 3 / FLUX on a CUDA card"
        )
    )
    parser.add_argument("--prompt", required=True, help="Text prompt")
    parser.add_argument("--image-path", type=str, default=None, help="Path to the image prompt")
    parser.add_argument(
        "--model-version",
        choices=tuple(MMDIT_CKPT.keys()),
        default="argmaxinc/mlx-FLUX.1-schnell",
        help="Diffusion model version",
    )
    parser.add_argument("--steps", type=int, default=50, help="Number of diffusion steps")
    parser.add_argument("--cfg", type=float, default=5.0, help="Classifier-free guidance weight")
    parser.add_argument("--negative_prompt", default="", help="Negative text prompt")
    parser.add_argument(
        "--preload-models", action="store_true",
        help="Block until all weights are resident on the card before generating",
    )
    parser.add_argument("--output-path", "-o", default="out.png", help="Output image path")
    parser.add_argument("--seed", type=int, help="Random seed")
    parser.add_argument("--verbose", "-v", action="store_true", help="Print detailed information")
    parser.add_argument("--shift", type=float, help="Sigma-schedule shift")
    parser.add_argument(
        "--t5", action="store_true",
        help="Engage T5-XXL for stronger text embeddings (more device memory)",
    )
    parser.add_argument("--height", type=int, help="Output image height")
    parser.add_argument("--width", type=int, help="Output image width")
    parser.add_argument(
        "--no-low-memory-mode", action="store_false", dest="low_memory_mode",
        help="Disable low memory mode (no model offloading between phases)",
    )
    parser.add_argument(
        "--benchmark-mode", action="store_true",
        help="Benchmark mode: no offloading + a 1-step warmup generation (kernel build, "
             "graph capture)",
    )
    parser.add_argument(
        "--denoise", type=float, default=0.0,
        help="Denoising strength for img2img (0.0-1.0)",
    )
    parser.add_argument("--local-ckpt", default=None, type=str, help="Local MMDiT checkpoint path")
    parser.add_argument("--num-images", type=int, default=1, help="Images per prompt (batched)")
    parser.add_argument("--guidance", type=float, default=None, help="FLUX.1-dev guidance scale")
    parser.add_argument(
        "--profile-dir", type=str, default=None,
        help="Write a torch.profiler trace (host and card) of the denoise phase to this "
             "directory",
    )
    parser.add_argument(
        "--quantize-mmdit", nargs="?", const="int4", default=None,
        choices=["int4", "int8", "w8a8", "w4a8", "int4-mixed", "w4a8-mixed"],
        help="Quantize the MMDiT at load. Bare flag = int4 weight-only (GPTQ on a float "
             "checkpoint). 'w8a8' runs int8 weights x dynamic int8 activations on the int8 "
             "tensor cores; 'w4a8' int4 weights on the same products. '-mixed' keeps int4 "
             "on the bulk linears only (int8 AdaLN, float final layer/embedders)",
    )
    parser.add_argument(
        "--quantize-t5", action="store_true",
        help="w8a8 T5-XXL with a SmoothQuant outlier fold (4.7 GB resident instead of 9.4)",
    )
    parser.add_argument(
        "--quantize-group-size", type=int, default=32,
        help="Group size for quantize-at-load; pre-quantized checkpoints keep their file's "
             "group size",
    )
    parser.add_argument(
        "--use-scan", action=argparse.BooleanOptionalAction, default=True,
        help="Run the denoise schedule as a CUDA graph of one step replayed once a step "
             "(default on; --no-use-scan runs the per-step loop, synchronised each step, "
             "with true per-iteration timings)",
    )
    return parser


def cli(argv=None, device="cuda"):
    """Parse ``argv``, generate, save the image(s); returns the phase log.
    Runs on the card; ``device`` is for tests (it adds no flag). Raises
    where ``device`` is a CUDA device and there is no card."""
    args = build_parser().parse_args(argv)
    args.w16 = True
    args.a16 = True
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("generate_images: no CUDA device; the port generates on the card")

    if "FLUX" in args.model_version and args.cfg > 0.0:
        logger.warning("Disabling CFG for %s model.", args.model_version)
        args.cfg = 0.0
    if args.benchmark_mode and args.low_memory_mode:
        logger.warning("Benchmark mode is enabled, disabling low memory mode.")
    if args.benchmark_mode:
        args.low_memory_mode = False
    if not 0.0 <= args.denoise <= 1.0:
        raise ValueError("Denoising factor must be between 0.0 and 1.0")

    # `is None` (not falsy-or): an explicit --shift 0.0 must be honoured.
    shift = SHIFT[args.model_version] if args.shift is None else args.shift
    pipeline_class = FluxPipeline if "FLUX" in args.model_version else DiffusionPipeline
    sd = pipeline_class(
        w16=args.w16,
        shift=shift,
        use_t5=args.t5,
        model_version=args.model_version,
        low_memory_mode=args.low_memory_mode,
        a16=args.a16,
        local_ckpt=args.local_ckpt,
        use_scan=args.use_scan,
        quantize_mmdit=args.quantize_mmdit,
        quantize_t5=args.quantize_t5,
        quantize_group_size=args.quantize_group_size,
        device=device,
    )
    if args.preload_models:
        sd.ensure_models_are_loaded()

    height = HEIGHT[args.model_version] if args.height is None else args.height
    width = WIDTH[args.model_version] if args.width is None else args.width
    if height % 16 or width % 16:
        raise ValueError(f"Height and width must be divisible by 16 ({height}x{width})")
    logger.info("Output image resolution will be %dx%d", height, width)

    if args.benchmark_mode:
        sd.ensure_models_are_loaded()
        logger.info("Benchmark mode: 1-step warmup generation.")
        sd.generate_image(
            args.prompt,
            cfg_weight=args.cfg,
            num_steps=1,
            seed=args.seed,
            negative_text=args.negative_prompt,
            latent_size=(height // 8, width // 8),
            verbose=False,
            num_images=args.num_images,
            guidance=args.guidance,
        )
        logger.info("Benchmark mode: warmup done.")

    image, log = sd.generate_image(
        args.prompt,
        cfg_weight=args.cfg,
        num_steps=args.steps,
        seed=args.seed,
        negative_text=args.negative_prompt,
        latent_size=(height // 8, width // 8),
        image_path=args.image_path,
        denoise=args.denoise,
        verbose=args.verbose,
        num_images=args.num_images,
        guidance=args.guidance,
        profile_dir=args.profile_dir,
    )
    if isinstance(image, list):
        from pathlib import Path

        base = Path(args.output_path)
        for i, im in enumerate(image):
            p = base.with_name(f"{base.stem}_{i}{base.suffix}")
            im.save(p)
            logger.info("Saved image %d to %s", i, p)
    else:
        image.save(args.output_path)
        logger.info("Saved the image to %s", args.output_path)
    return log


if __name__ == "__main__":
    cli()
