"""Serving throughput on the card: batched multi-prompt generation at
batches of 1, 4 and 8 prompts.

The counterpart of the reference's ``tools/bench_serving.py``: it times
``pipeline.generate_images_batched`` (the batching server's fast path) on
FLUX.1-schnell's 4-bit release with ``quantize_mmdit="w4a8"`` and the w8a8
T5 (``quantize_t5=True``), everything resident (``low_memory_mode=False``),
4 steps, CFG 0, from ``DIFFUSIONKIT_TPU_CKPT_DIR`` (default ``.ckpt_mirror``
beside the package). Each batch runs once untimed (it captures the batch's
step graphs), then ``n_runs`` times; its row is the mean seconds a batch and
images a minute. A batch that fails makes the run fail. Prints one JSON line
a batch, beside the card's name.

    python -m diffusionkit_tpu_torch.tools.bench_serving [--size 512|1024] [--batches 1 4 8]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import List, Optional, Sequence

import torch

PROMPTS = [f"a photo of a cat number {i}" for i in range(8)]
STEPS = 4


def _sync(pipe) -> None:
    if pipe.device.type == "cuda":
        torch.cuda.synchronize(pipe.device)


def run(pipe, size: int, batches: Sequence[int] = (1, 4, 8), n_runs: int = 3) -> List[dict]:
    """One row a batch: ``batch``, ``s_per_batch`` (the mean of ``n_runs``
    timed calls after one untimed call) and ``images_per_min``. A batch of
    b takes the first b of the reference's eight prompts; run r's seeds are
    ``range(b)`` shifted by r."""
    latent = (size // 8, size // 8)
    rows = []
    for batch in batches:
        if not 1 <= batch <= len(PROMPTS):
            raise ValueError(f"batch {batch}: 1 to {len(PROMPTS)} prompts")
        texts = PROMPTS[:batch]
        seeds = list(range(batch))
        pipe.generate_images_batched(texts, num_steps=STEPS, cfg_weight=0.0, latent_size=latent,
                                     seeds=seeds)
        _sync(pipe)
        t0 = time.perf_counter()
        for r in range(n_runs):
            pipe.generate_images_batched(texts, num_steps=STEPS, cfg_weight=0.0,
                                         latent_size=latent, seeds=[s + r for s in seeds])
        _sync(pipe)
        dt = (time.perf_counter() - t0) / n_runs
        rows.append({"metric": f"flux_w4a8_{size}_4step_images_per_min", "batch": batch,
                     "s_per_batch": dt, "images_per_min": 60.0 * batch / dt})
    return rows


def main(argv: Optional[List[str]] = None) -> None:
    from ..pipeline import FluxPipeline

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=512, choices=(512, 1024))
    ap.add_argument("--batches", type=int, nargs="*", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_serving: no CUDA device; it times the card")
    os.environ.setdefault("DIFFUSIONKIT_TPU_CKPT_DIR",
                          str(Path(__file__).resolve().parents[2] / ".ckpt_mirror"))
    pipe = FluxPipeline(model_version="argmaxinc/mlx-FLUX.1-schnell-4bit-quantized",
                        low_memory_mode=False, use_scan=True, quantize_t5=True,
                        quantize_mmdit="w4a8")
    card = torch.cuda.get_device_name(0)
    for row in run(pipe, args.size, tuple(args.batches) if args.batches else (1, 4, 8)):
        print(json.dumps({**row, "device": card}), flush=True)


if __name__ == "__main__":
    main()
