"""On-chip A/B: the fused w4a8 kernel E against materialise-int8 variants.

Counterpart of the reference's ``tools/bench_w4a8_mat.py``. Kernel E
requantises each packed weight tile once per M-tile; materialising the
int8 grid once per call (#10 ``dequant_w8``: K*N/2 bytes of words read, K*N
written) and feeding a requant-free int8 product pays it once. Rows:

  kernel   kernel E, ``w4a8_matmul`` (mode plain) on its Hopper loop
           (``_route="sm90"``; the port's own route at these shapes is
           mat_pl's)
  mat_xla  #10, then ``torch._int_mm`` and the epilogue in torch
  mat_pl   #10, then #11 ``w8_matmul`` (the epilogue in its kernel) at its
           own tile; the reference's sweep over (bm, bk, bn) is a sweep of
           TPU blocks and has no counterpart here
  mxu8     ``torch._int_mm`` on a resident w8 (the int8 library product)
  mxubf16  ``torch.matmul`` in bf16 on the same grid (the bf16 library
           product)

The layer is the reference's: random packed words and affine
(``random_quantized_linear_``, group 64, no bias) from a seeded
``torch.Generator``, the bound ``wscale`` (``add_wscale_bound_``), and
activations from ``quantize_float`` (kernel D on the card). ``mat_pl``
and ``mat_xla`` equal ``kernel`` bit for bit: the grids are the same and
the epilogues run in the same order.

    python -m diffusionkit_tpu_torch.tools.bench_w4a8_mat [M K N [iters]]

``ab`` times mode plain's two dataflows as ``w4a8_route`` chooses between
them, each through ``w4a8_matmul``: kernel E's Hopper loop (``sm90``) and
#10 then #11 (``mat``), on random layers from a seeded generator
(``bench_gemv.layer``), warm by ``device_ms`` (one layer, in L2) and cold
by ``device_ms_cold`` (one call on each of enough layers to pass 100 MB,
as a denoise step reads each layer once):

    python -m diffusionkit_tpu_torch.tools.bench_w4a8_mat ab [M,K,N,group ...]

by default at ``AB_SHAPES``, mode plain's shapes on the FLUX w4a8 paths,
and ``AB_EDGES``, fewer rows and larger groups than those.
"""

from __future__ import annotations

import math
import sys
from typing import List, Optional

import torch

from ..ops.quantized import QuantizedLinear, add_wscale_bound_, random_quantized_linear_
from ..ops.w4a8_matmul import dequant_w8, scaled_affine, w4a8_matmul, w8_matmul
from ..ops.w8a8 import quantize_float
from . import device_label, device_ms, device_ms_cold, parse_args, print_rows, row, widen
from .bench_gemv import layer as random_layer
from .bench_rows import COLD_BYTES, clocks

GROUP = 64
# Mode plain above 16 rows on the FLUX w4a8 paths, (M, K, N, group): the
# text stream's q/k/v/o (256 rows), the image stream's v/o at 1024² (4096)
# and 2048² (16384), the single blocks' v/o (4352, 16640), and 4352 rows at
# group 32.
AB_SHAPES = ((256, 3072, 3072, 64), (4096, 3072, 3072, 64), (4352, 3072, 3072, 64),
             (16384, 3072, 3072, 64), (16640, 3072, 3072, 64), (4352, 3072, 3072, 32))
# Off the paths, where the route's rule reaches beyond them: 17 to 128
# rows, and groups of 128 and 256.
AB_EDGES = ((17, 3072, 3072, 64), (64, 3072, 3072, 64), (128, 3072, 3072, 64),
            (256, 3072, 3072, 128), (4352, 3072, 3072, 128), (4352, 3072, 3072, 256))


def launches(iters: int) -> dict:
    """Kernel launches one ``run`` makes on the card: #10 in mat_xla and
    mat_pl (iters + 1 calls each) and once for the resident grid; #11 in
    mat_pl; E in kernel; kernel D once for the activations."""
    return {"dequant_w8": 2 * (iters + 1) + 1, "w8_matmul": iters + 1,
            "w4a8_matmul[plain]": iters + 1, "quantize": 1}


def feed(y: torch.Tensor, k: int) -> torch.Tensor:
    """The reference's feed: the next int8 input from an (M, N) output."""
    return widen(y, k).clamp(-127, 127).to(torch.int8)


@torch.inference_mode()
def run(m: int, k: int, n: int, iters: int = 16, device="cuda") -> List[dict]:
    """The five rows at (M, K, N), each a chain of ``iters`` calls."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    layer = QuantizedLinear(k, n, GROUP, bias=False, device=dev)
    random_quantized_linear_(layer, gen)
    add_wscale_bound_(layer)
    s8, z8 = scaled_affine(layer.scales, layer.zeros, layer.wscale)
    aq = quantize_float(torch.randn(m, k, generator=gen, device=dev).bfloat16())
    x8_0, xs = aq.x8, aq.xscale.reshape(m, 1)
    xb_0 = torch.randn(m, k, generator=gen, device=dev).bfloat16()
    ws = layer.wscale
    w8 = dequant_w8(layer.q4, s8, z8)
    w8t, wb = w8.t(), w8.t().to(torch.bfloat16)
    ops = 2.0 * m * k * n
    int8_feed = lambda y: feed(y, k)  # noqa: E731

    def mat_xla(x8):
        acc = torch._int_mm(x8, dequant_w8(layer.q4, s8, z8).t())
        return (acc.float() * xs * ws).to(torch.bfloat16)

    return [
        row("kernel", lambda x8: w4a8_matmul(x8, layer.q4, layer.scales, layer.zeros, ws, xs,
                                             None, _route="sm90"),
            x8_0, iters, int8_feed, ops, "TOP/s"),
        row("mat_xla", mat_xla, x8_0, iters, int8_feed, ops, "TOP/s"),
        row("mat_pl", lambda x8: w8_matmul(x8, dequant_w8(layer.q4, s8, z8), ws, xs, None),
            x8_0, iters, int8_feed, ops, "TOP/s"),
        row("mxu8", lambda x8: torch._int_mm(x8, w8t), x8_0, iters, int8_feed, ops, "TOP/s"),
        row("mxubf16", lambda xb: torch.matmul(xb, wb), xb_0, iters,
            lambda y: widen(y, k).contiguous(), ops, "TFLOP/s"),
    ]


def weight_bytes(k: int, n: int, group: int) -> int:
    """One layer's bytes that either dataflow reads: the packed words, the
    fp32 scales and zeros and wscale."""
    return k * n // 2 + 8 * (k // group) * n + 4 * n


def dataflows(shape, copies: int, gen, dev) -> dict:
    """Mode plain at (M, K, N, group) on ``copies`` random layers (words,
    affine, wscale and bf16 bias), one int8 activation: {"sm90": kernel E's
    Hopper loop, "mat": #10 then #11}, one call per layer each."""
    m, k, n, group = shape
    x8 = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
    xs = (torch.rand(m, 1, generator=gen, device=dev) + 0.5) / (127 * k**0.5)
    out = {"sm90": [], "mat": []}
    for _ in range(copies):
        q4, sc, z, ws, b = random_layer("w4a8_matmul", k, n, group, gen, dev)
        for route, fns in out.items():
            fns.append(lambda q4=q4, sc=sc, z=z, ws=ws, b=b, route=route: w4a8_matmul(
                x8, q4, sc, z, ws, xs, b, _route=route))
    return out


@torch.inference_mode()
def ab(shapes=AB_SHAPES + AB_EDGES) -> List[dict]:
    """Per (M, K, N, group) on the card: each dataflow's ms warm and cold,
    the layers timed cold, and whether the two outputs of the first layer
    are bit-identical (they must be: one grid, one epilogue order)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for shape in shapes:
        copies = math.ceil(COLD_BYTES / weight_bytes(*shape[1:])) + 1
        flows = dataflows(shape, copies, gen, dev)
        same = torch.equal(flows["sm90"][0](), flows["mat"][0]())
        rows.append({"shape": tuple(shape), "copies": copies, "same": same,
                     **{f"{route}_warm_ms": device_ms(fns[0]) for route, fns in flows.items()},
                     **{f"{route}_cold_ms": device_ms_cold(fns) for route, fns in flows.items()}})
        del flows
        torch.cuda.empty_cache()
    return rows


def main(argv: Optional[List[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] != ["ab"]:
        m, k, n, iters = parse_args(argv)
        print_rows(run(m, k, n, iters), torch.device("cuda"), (m, k, n))
        return
    shapes = [tuple(int(v) for v in a.split(",")) for a in argv[1:]] or None
    print(f"mode plain's two dataflows on {device_label(torch.device('cuda'))}: ms warm (one "
          f"layer, in L2) and cold (layers over {COLD_BYTES / 1e6:.0f} MB)", flush=True)
    for r in ab(*([shapes] if shapes else [])):
        print(f"(M, K, N, group) {r['shape']}: kernel E cold {r['sm90_cold_ms']!r} / warm "
              f"{r['sm90_warm_ms']!r} ms, #10 then #11 cold {r['mat_cold_ms']!r} / warm "
              f"{r['mat_warm_ms']!r} ms, E at {r['sm90_cold_ms'] / r['mat_cold_ms']!r}x / "
              f"{r['sm90_warm_ms'] / r['mat_warm_ms']!r}x ({r['copies']} layers; outputs "
              f"{'bit-identical' if r['same'] else 'DIFFER'})", flush=True)
    print(f"card, power limit, SM clock, max SM clock: {clocks()}", flush=True)


if __name__ == "__main__":
    main()
