"""On-chip A/B: the fused w4a8 kernel E against materialise-int8 variants.

Counterpart of the reference's ``tools/bench_w4a8_mat.py``. Kernel E
requantises each packed weight tile once per M-tile; materialising the
int8 grid once per call (#10 ``dequant_w8``: K*N/2 bytes of words read, K*N
written) and feeding a requant-free int8 product pays it once. Rows:

  kernel   kernel E, ``w4a8_linear`` (mode plain)
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
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..ops.quantized import QuantizedLinear, add_wscale_bound_, random_quantized_linear_
from ..ops.w4a8_matmul import dequant_w8, scaled_affine, w4a8_linear, w8_matmul
from ..ops.w8a8 import ActQuant, quantize_float
from . import parse_args, print_rows, row, widen

GROUP = 64


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
        row("kernel", lambda x8: w4a8_linear(layer, ActQuant(x8, xs, out_dtype=torch.bfloat16)),
            x8_0, iters, int8_feed, ops, "TOP/s"),
        row("mat_xla", mat_xla, x8_0, iters, int8_feed, ops, "TOP/s"),
        row("mat_pl", lambda x8: w8_matmul(x8, dequant_w8(layer.q4, s8, z8), ws, xs, None),
            x8_0, iters, int8_feed, ops, "TOP/s"),
        row("mxu8", lambda x8: torch._int_mm(x8, w8t), x8_0, iters, int8_feed, ops, "TOP/s"),
        row("mxubf16", lambda xb: torch.matmul(xb, wb), xb_0, iters,
            lambda y: widen(y, k).contiguous(), ops, "TFLOP/s"),
    ]


def main(argv: Optional[List[str]] = None) -> None:
    m, k, n, iters = parse_args(argv)
    print_rows(run(m, k, n, iters), torch.device("cuda"), (m, k, n))


if __name__ == "__main__":
    main()
