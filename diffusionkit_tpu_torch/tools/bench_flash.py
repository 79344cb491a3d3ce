"""Device times of the flash attention kernels beside the library's.

    python -m diffusionkit_tpu_torch.tools.bench_flash [B,S,H,D ...]

At each (B, S, H, D) (by default FLUX.1 1024²'s and SD3-medium 512²'s joint
attention, and FLUX.1 2048²'s 16640 tokens, where the one-rank ring runs #14
on every joint attention), on the same random bf16 q, k, v: kernel B on
(B, S, H, D), #15 and #14 (every key valid) on contiguous (B, H, S, D)
copies, and
``F.scaled_dot_product_attention`` on those copies, the yardstick the port
never calls. Each is timed by ``device_ms`` (calls captured in one CUDA
graph, as ``chip_smoke.py`` times kernels) and given its rate in TFLOP/s of
the 4 B H S² D operations. With ``device="cpu"`` (the tests) each runs its
plain version once and no time is taken.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention, flash_attention_bshd, flash_attention_stats
from . import device_ms, device_label

DEFAULT_FLASH_SHAPES = ((1, 4352, 24, 128), (2, 1178, 24, 64), (1, 16640, 24, 128))
NAMES = ("flash_attention_bshd", "flash_attention", "flash_attention_stats", "sdpa")


@torch.inference_mode()
def run(shapes=DEFAULT_FLASH_SHAPES, device="cuda") -> List[dict]:
    """One row per shape and name (NAMES): its ms and TFLOP/s (None on the
    CPU) and its output (#14's o)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for shape in shapes:
        b, s, h, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16() for _ in range(3))
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        scale = d**-0.5
        calls = (lambda: flash_attention_bshd(q, k, v, scale),
                 lambda: flash_attention(qh, kh, vh, scale),
                 lambda: flash_attention_stats(qh, kh, vh, scale, s)[0],
                 lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
        for name, call in zip(NAMES, calls):
            ms = device_ms(call) if dev.type == "cuda" else None
            rows.append({"shape": shape, "name": name, "ms": ms,
                         "tflops": 4 * b * h * s * s * d / ms / 1e9 if ms else None,
                         "out": call()})
    return rows


def main(argv: Optional[List[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    shapes = [tuple(int(x) for x in a.split(",")) for a in argv] or DEFAULT_FLASH_SHAPES
    dev = torch.device("cuda")
    print(f"flash attention on {device_label(dev)}", flush=True)
    for r in run(shapes, dev):
        print(f"{str(r['shape']):20s} {r['name']:22s} {r['ms']:10.4f} ms  {r['tflops']:7.1f} "
              f"TFLOP/s", flush=True)


if __name__ == "__main__":
    main()
