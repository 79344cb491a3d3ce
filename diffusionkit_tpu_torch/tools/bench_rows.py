"""Device times of the row kernels A' (mod_ln_quantize), D (quantize) and
#4 (gelu_quantize), of D's and #4's two-pass form and of E's gelu_quant in
tiles, warm and cold.

    python -m diffusionkit_tpu_torch.tools.bench_rows [name:shape ...]

e.g. ``mod_ln_quantize:1,4352,3072 quantize:2048,1536
gelu_quantize:2048,6144 quantize_two_pass:256,5120
gelu_quant_tiles:8192,4864,0,19``. A two-pass row times both passes on
one rank's rows (``row_absmax`` then ``quantize_amax``, no collective); a
tiles row, shaped (M, N, col0, tiles), both passes on one rank's fp32
columns from ``col0`` of a hidden of ``tiles`` scale tiles. By default
the measured paths' shapes: A' at
FLUX.1's image, joint and 2048² rows (hidden 3072) and SD3-medium's image
and text rows with CFG (hidden 1536); D at FLUX.1's `o` inputs (its
joint, image and 2048² unified rows, 3072 wide), a FLUX w8a8 FFN hidden
(12288 wide), T5-XXL's `wo` input (10240 wide) and SD3-medium w8a8's `o`
inputs (image and text rows, 1536 wide); #4 at SD3-medium w8a8's FFN
hidden (6144 wide), image and text rows; the two-pass D at the T5's
`wo` input, FLUX's `o` input and SD3.5-large's `o` inputs (image and text
rows) over two ranks, and at 1 and 3 rows; the two-pass #4 at SD3-medium
w8a8's FFN hidden over two; the tiles at SD3.5-large's FFN hidden over two
(rank 0) and four (rank 1). Inputs are bf16 (the tiles' fp32) from a seeded
generator, shift and scale strided views of one modulation vector as the
model passes them; #4 in its erf form. Each shape
is timed warm by ``device_ms`` (20 calls on one input, which stays in the
L2 where it fits) and cold by ``device_ms_cold`` (one call on each of
enough copies of the input to pass 100 MB, so each call reads its row from
device memory; shift and scale, a few KB a sample, stay shared), and
printed beside the bytes a call must move over 3.35 TB/s. Only the
wrappers' public calls are used, so the same script times any tree of the
package that has them. With ``device="cpu"`` (the tests) each runs its
plain version once and no time is taken.
"""

from __future__ import annotations

import math
import subprocess
import sys
from typing import Callable, List, Optional

import torch

from ..ops.fused_quant import (
    gelu_quantize, mod_ln_quantize, quantize, quantize_amax, row_absmax, tile_absmax,
    tile_quantize,
)
from . import device_label, device_ms, device_ms_cold

DEFAULT_ROW_SHAPES = {
    "mod_ln_quantize": ((1, 4352, 3072), (1, 4096, 3072), (1, 16384, 3072), (2, 1024, 1536),
                        (2, 154, 1536)),
    "quantize": ((4352, 3072), (4096, 3072), (16384, 3072), (16640, 3072), (4352, 12288),
                 (256, 10240), (2048, 1536), (308, 1536)),
    "gelu_quantize": ((2048, 6144), (308, 6144)),
    "quantize_two_pass": ((256, 5120), (4352, 1536), (8192, 1216), (308, 1216), (1, 5120),
                          (3, 5120)),
    "gelu_quantize_two_pass": ((2048, 3072),),
    "gelu_quant_tiles": ((8192, 4864, 0, 19), (8192, 2432, 2432, 19)),
}
# The GELU form of each two-pass row (None: D's).
TWO_PASS_FORM = {"quantize_two_pass": None, "gelu_quantize_two_pass": "erf"}
COLD_BYTES = 100e6  # the copies' inputs together, twice the L2
HBM = 3.35e12  # the H100 SXM's memory rate, bytes a second


def input_bytes(shape, name: str = "") -> int:
    """The bytes of one input row block: bf16 x for A', y for D and #4; the
    tiles' fp32 (M, N)."""
    if name == "gelu_quant_tiles":
        return 4 * shape[0] * shape[1]
    return 2 * math.prod(shape)


def moved_bytes(name: str, shape) -> int:
    """The bytes one call must move: the input read once, the int8 rows and
    fp32 scales written once (and for A' each sample's shift and scale read
    once; the tiles a scale a row and tile)."""
    if name == "gelu_quant_tiles":
        m, n, _, tiles = shape
        return 5 * m * n + 4 * m * tiles
    rows, width = math.prod(shape[:-1]), shape[-1]
    extra = 4 * shape[0] * width if name == "mod_ln_quantize" else 0
    return 3 * rows * width + 4 * rows + extra


def calls(name: str, shape, copies: int, gen, dev) -> List[Callable]:
    """``copies`` calls of ``name`` at ``shape``, each on its own input."""
    out = []
    if name == "mod_ln_quantize":
        b, _, h = shape
        vec = torch.randn(b, 6 * h, generator=gen, device=dev).bfloat16()
        sh, sc = vec[:, None, :h], vec[:, None, h : 2 * h]
        for _ in range(copies):
            x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).bfloat16()
            out.append(lambda x=x: mod_ln_quantize(x, sh, sc))
        return out
    if name == "gelu_quant_tiles":
        m, n, col0, tiles = shape
        for _ in range(copies):
            y = torch.randn(m, n, generator=gen, device=dev) * 2
            out.append(lambda y=y: tile_quantize(y, tile_absmax(y, col0, tiles), col0))
        return out
    if name in TWO_PASS_FORM:
        form = TWO_PASS_FORM[name]
        for _ in range(copies):
            y = (torch.randn(shape, generator=gen, device=dev) * 2).bfloat16()
            out.append(lambda y=y: quantize_amax(y, row_absmax(y, form), form))
        return out
    fn = quantize if name == "quantize" else gelu_quantize
    for _ in range(copies):
        y = (torch.randn(shape, generator=gen, device=dev) * 2).bfloat16()
        out.append(lambda y=y: fn(y))
    return out


@torch.inference_mode()
def run(shapes: Optional[dict] = None, device="cuda") -> List[dict]:
    """One row per kernel name and shape: its warm and cold ms (None on the
    CPU), the copies timed cold, the bytes a call moves and the first
    call's output."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name, name_shapes in (shapes or DEFAULT_ROW_SHAPES).items():
        for shape in name_shapes:
            copies = (math.ceil(COLD_BYTES / input_bytes(shape, name)) + 1
                      if dev.type == "cuda" else 1)
            fns = calls(name, shape, copies, gen, dev)
            out = fns[0]()
            warm = device_ms(fns[0]) if dev.type == "cuda" else None
            cold = device_ms_cold(fns) if dev.type == "cuda" else None
            rows.append({"name": name, "shape": tuple(shape), "warm_ms": warm, "cold_ms": cold,
                         "copies": copies, "bytes": moved_bytes(name, shape), "out": out})
            del fns
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return rows


def parse_shapes(argv: List[str]) -> Optional[dict]:
    """``name:d0,d1[,d2]`` arguments -> {name: [shape, ...]}."""
    if not argv:
        return None
    out = {}
    for arg in argv:
        name, dims = arg.split(":")
        if name not in DEFAULT_ROW_SHAPES:
            raise ValueError(f"unknown kernel {name!r} (one of {sorted(DEFAULT_ROW_SHAPES)})")
        out.setdefault(name, []).append(tuple(int(v) for v in dims.split(",")))
    return out


def clocks() -> str:
    """The card's SM clock now and its maximum, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[torch.cuda.current_device()]


def main(argv: Optional[List[str]] = None) -> List[dict]:
    argv = sys.argv[1:] if argv is None else argv
    dev = torch.device("cuda")
    print(f"Row kernels on {device_label(dev)}: ms warm (one input, in L2) and cold "
          f"(input copies over {COLD_BYTES / 1e6:.0f} MB)", flush=True)
    rows = run(parse_shapes(argv))
    for r in rows:
        bound = r["bytes"] / HBM * 1e3
        print(f"{r['name']:16s} {str(r['shape']):18s} warm {r['warm_ms']!r} ms, cold "
              f"{r['cold_ms']!r} ms ({r['bytes'] / (r['cold_ms'] / 1e3) / 1e12!r} TB/s; "
              f"{r['copies']} copies), bytes bound {bound!r} ms, cold at {bound / r['cold_ms']!r}"
              f" of it", flush=True)
    print(f"card, power limit, SM clock, max SM clock: {clocks()}", flush=True)
    return rows


if __name__ == "__main__":
    main()
