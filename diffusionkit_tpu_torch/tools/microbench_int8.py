"""On-chip experiment: how fast is the bare int8 product, with no requant?

Counterpart of the reference's ``tools/microbench_pallas_int8.py``: it
splits kernel E's cost into the int8 product at the port's tiling and the
in-tile requantisation, by timing #16 ``int8_dot`` (kernel #11's main loop
storing the int32 accumulators; weights arrive as int8) beside the int8
library product, ``torch._int_mm``. Rows:

  int_mm    ``torch._int_mm(x8, w8.t())``
  int8_dot  #16 at its own tile; the reference's sweep over (bm, bk, bn)
            is a sweep of TPU blocks and has no counterpart here

x8 (M, K) and w8 (N, K) are uniform int8 in [-127, 127] from a seeded
``torch.Generator``; the two rows' outputs are equal (both exact).

    python -m diffusionkit_tpu_torch.tools.microbench_int8 [M K N [iters]]
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..ops.w4a8_matmul import int8_dot
from . import parse_args, print_rows, row, widen


def launches(iters: int) -> dict:
    """Kernel launches one ``run`` makes on the card: #16 in its row."""
    return {"int8_dot": iters + 1}


def feed(y: torch.Tensor, k: int) -> torch.Tensor:
    """The reference's feed: the int32 output shifted right by 7, clipped
    to int8."""
    return (widen(y, k) >> 7).clamp(-127, 127).to(torch.int8)


@torch.inference_mode()
def run(m: int, k: int, n: int, iters: int = 16, device="cuda") -> List[dict]:
    """The two rows at (M, K, N), each a chain of ``iters`` calls."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    x8 = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
    w8t = w8.t()
    ops = 2.0 * m * k * n
    int8_feed = lambda y: feed(y, k)  # noqa: E731
    return [
        row("int_mm", lambda x: torch._int_mm(x, w8t), x8, iters, int8_feed, ops, "TOP/s"),
        row("int8_dot", lambda x: int8_dot(x, w8), x8, iters, int8_feed, ops, "TOP/s"),
    ]


def main(argv: Optional[List[str]] = None) -> None:
    m, k, n, iters = parse_args(argv)
    print_rows(run(m, k, n, iters), torch.device("cuda"), (m, k, n))


if __name__ == "__main__":
    main()
