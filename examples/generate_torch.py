"""Text-to-image and image-to-image with the port's Python API, on the card.

The PyTorch / CUDA counterpart of examples/generate.py, with its flags:
build a pipeline for a registry model, generate at a given size/steps/CFG.

Checkpoints resolve from the HuggingFace cache, or set
DIFFUSIONKIT_TPU_CKPT_DIR to a local mirror laid out as
<dir>/<model repo>/<file> (offline boxes).

    python examples/generate_torch.py --model argmaxinc/mlx-stable-diffusion-3-medium \
        --prompt "a photo of a cat in a wizard hat" --size 512 --steps 28
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="argmaxinc/mlx-stable-diffusion-3-medium")
    ap.add_argument("--prompt", default="a photo of a cat in a wizard hat")
    ap.add_argument("--negative-prompt", default="")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--steps", type=int, default=28)
    ap.add_argument("--cfg", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--image", help="init image for img2img")
    ap.add_argument("--denoise", type=float, default=0.7,
                    help="img2img strength (1.0 = full denoise)")
    ap.add_argument("--quantize-mmdit", choices=["int4", "int8", "w8a8", "w4a8"],
                    help="quantization mode (see README quality table)")
    args = ap.parse_args()

    import torch

    from diffusionkit_tpu_torch.pipeline import DiffusionPipeline, FluxPipeline

    if not torch.cuda.is_available():
        raise SystemExit("generate_torch: no CUDA device; the port generates on the card")
    cls = FluxPipeline if "FLUX" in args.model else DiffusionPipeline
    pipe = cls(
        model_version=args.model,
        shift=1.0 if "FLUX" in args.model else 3.0,
        low_memory_mode=True,
        quantize_mmdit=args.quantize_mmdit or False,
    )
    image, log = pipe.generate_image(
        args.prompt,
        negative_text=args.negative_prompt,
        num_steps=args.steps,
        cfg_weight=0.0 if "FLUX" in args.model else args.cfg,
        latent_size=(args.size // 8, args.size // 8),
        seed=args.seed,
        image_path=args.image,
        denoise=args.denoise if args.image else 1.0,
    )
    image.save(args.out)
    print(f"wrote {args.out}  (denoise {log['denoising']['time']:.2f}s)")


if __name__ == "__main__":
    main()
