"""Device times of the flash attention kernels beside the library's.

    python -m diffusionkit_tpu_torch.tools.bench_flash [--fp32] [B,S,H,D ...]

At each (B, S, H, D) (by default FLUX.1 1024²'s and SD3-medium 512²'s joint
attention, FLUX.1 2048²'s 16640 tokens, where the one-rank ring runs #14 on
every joint attention, the VAE decoder's mid-block at 512² and 1024², one
head of 512 over 4096 and 16384 positions, and #14's three d=64 shapes:
SD3-medium 512² CFG's four-rank ring chunk (295 tokens), 1024² CFG's (1063)
and 1024²'s one-rank ring call (4250)), on the same random q, k, v
(bf16, or fp32 with ``--fp32``): kernel B on (B, S, H, D), #15 and #14
(every key valid; not at d=512, which no ring runs) on contiguous (B, H, S,
D) copies, and ``F.scaled_dot_product_attention`` on those copies, the
yardstick the port never calls (in fp32 with TF32 off, as the port's fp32
kernels compute). Each is timed by ``device_ms`` (calls captured in one
CUDA graph, as ``chip_smoke.py`` times kernels) and given its rate in
TFLOP/s of the 4 B H S² D operations. With ``device="cpu"`` (the tests)
each runs its plain version once and no time is taken.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch
import torch.nn.functional as F

from ..ops.flash_attention import (
    STATS_HEAD_DIMS,
    flash_attention,
    flash_attention_bshd,
    flash_attention_stats,
)
from . import device_label, device_ms

DEFAULT_FLASH_SHAPES = ((1, 4352, 24, 128), (2, 1178, 24, 64), (1, 16640, 24, 128),
                        (1, 4096, 1, 512), (1, 16384, 1, 512), (2, 295, 24, 64),
                        (2, 1063, 24, 64), (2, 4250, 24, 64))
NAMES = ("flash_attention_bshd", "flash_attention", "flash_attention_stats", "sdpa")


@torch.inference_mode()
def run(shapes=DEFAULT_FLASH_SHAPES, device="cuda", dtype=torch.bfloat16) -> List[dict]:
    """One row per shape and name (NAMES; #14 only at its head dims): its
    ms and TFLOP/s (None on the CPU) and its output (#14's o)."""
    dev = torch.device(device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _rows(shapes, dev, dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _rows(shapes, dev: torch.device, dtype) -> List[dict]:
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for shape in shapes:
        b, s, h, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(3))
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        scale = d**-0.5
        calls = {"flash_attention_bshd": lambda: flash_attention_bshd(q, k, v, scale),
                 "flash_attention": lambda: flash_attention(qh, kh, vh, scale),
                 "flash_attention_stats": lambda: flash_attention_stats(qh, kh, vh, scale, s)[0],
                 "sdpa": lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)}
        if d not in STATS_HEAD_DIMS:
            del calls["flash_attention_stats"]
        for name, call in calls.items():
            ms = device_ms(call) if dev.type == "cuda" else None
            rows.append({"shape": shape, "name": name, "ms": ms,
                         "tflops": 4 * b * h * s * s * d / ms / 1e9 if ms else None,
                         "out": call()})
    return rows


def main(argv: Optional[List[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    dtype = torch.float32 if "--fp32" in argv else torch.bfloat16
    shapes = [tuple(int(x) for x in a.split(",")) for a in argv if a != "--fp32"]
    dev = torch.device("cuda")
    print(f"flash attention, {dtype}, on {device_label(dev)}", flush=True)
    for r in run(shapes or DEFAULT_FLASH_SHAPES, dev, dtype):
        print(f"{str(r['shape']):20s} {r['name']:22s} {r['ms']:10.4f} ms  {r['tflops']:7.1f} "
              f"TFLOP/s", flush=True)


if __name__ == "__main__":
    main()
