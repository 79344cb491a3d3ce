"""Device times of the kernels of FLUX w4a8's materialised dataflow and of
SD3 w8a8's x_embedder, warm and cold: #10 ``dequant_w8`` alone, and #11
``w8_matmul`` at K = 64 beside ``torch._int_mm``'s int32 product. (Mode
plain's two dataflows, kernel E against #10 then #11, are
``bench_w4a8_mat``'s ``ab``.)

    python -m diffusionkit_tpu_torch.tools.bench_mat [name:d0,d1,d2 ...]

with ``dequant:K,N,group`` or ``w8:M,K,N``; by default the measured paths'
shapes: #10 at FLUX.1's fc1, fc2 and q/k/v/o (group 64) and q/k/v/o at
group 32; #11 at (2048, 64, 1536). Each shape is timed warm by
``device_ms`` (20 calls on one set of inputs, which stays in L2 where it
fits) and cold by ``device_ms_cold`` (one call on each of enough copies
of the weights to pass 100 MB, as a denoise step reads each layer's
weights once), beside the bytes a call must move over 3.35 TB/s. Random
packed layers from a seeded generator, as ``bench_gemv``'s. With
``device="cpu"`` (the tests) each runs its plain version once and no
time is taken.
"""

from __future__ import annotations

import math
import sys
from typing import List, Optional

import torch

from ..ops.w4a8_matmul import dequant_w8, scaled_affine, w8_matmul
from . import device_label, device_ms, device_ms_cold
from .bench_gemv import layer as random_layer
from .bench_rows import COLD_BYTES, HBM, clocks

DEFAULT_SHAPES = {
    "dequant": ((3072, 12288, 64), (12288, 3072, 64), (3072, 3072, 64), (3072, 3072, 32)),
    "w8": ((2048, 64, 1536),),
}


def weight_bytes(name: str, shape) -> int:
    """The bytes of one copy of the weights a call reads: the packed words
    and the fp32 affine (and wscale) for #10, w8 and wscale for #11."""
    if name == "w8":
        _, k, n = shape
        return n * k + 4 * n
    k, n, group = shape
    return k * n // 2 + 8 * (k // group) * n + 4 * n


def moved_bytes(name: str, shape) -> int:
    """The bytes one call must move, each input read once and each output
    written once: #10's words, affine and (N, K) grid; #11's x8, w8, scales,
    bias and bf16 y."""
    if name == "dequant":
        k, n, group = shape
        return k * n // 2 + 8 * (k // group) * n + k * n
    m, k, n = shape
    return m * k + n * k + 4 * m + 6 * n + 2 * m * n


def calls(name: str, shape, copies: int, gen, dev) -> dict:
    """Per function of ``name`` at ``shape``, ``copies`` calls, each on its
    own copy of the weights: {"dequant_w8": [...]} for #10, {"w8_matmul",
    "int_mm"} (the latter on the card only) for #11."""
    if name == "w8":
        m, k, n = shape
        x8 = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        xs = (torch.rand(m, 1, generator=gen, device=dev) + 0.5) / (127 * k**0.5)
        out = {"w8_matmul": [], "int_mm": []}
        for _ in range(copies):
            w8 = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
            ws = (torch.rand(n, generator=gen, device=dev) + 0.5) / 127
            b = (0.1 * torch.randn(n, generator=gen, device=dev)).bfloat16()
            out["w8_matmul"].append(lambda w8=w8, ws=ws, b=b: w8_matmul(x8, w8, ws, xs, b))
            if dev.type == "cuda":
                out["int_mm"].append(lambda w8t=w8.t(): torch._int_mm(x8, w8t))
        return out
    k, n, group = shape
    layers = [random_layer("w4a8_matmul", k, n, group, gen, dev) for _ in range(copies)]
    affine = [scaled_affine(sc, z, ws) for _, sc, z, ws, _ in layers]
    return {"dequant_w8": [lambda q4=lay[0], a=a: dequant_w8(q4, *a)
                           for lay, a in zip(layers, affine)]}


@torch.inference_mode()
def run(shapes: Optional[dict] = None, device="cuda") -> List[dict]:
    """One row per name and shape: per function its warm and cold ms (None
    on the CPU) and its first call's output; the copies timed cold and the
    bytes a call moves."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name, name_shapes in (shapes or DEFAULT_SHAPES).items():
        for shape in name_shapes:
            copies = (math.ceil(COLD_BYTES / weight_bytes(name, shape)) + 1
                      if dev.type == "cuda" else 1)
            flows = calls(name, shape, copies, gen, dev)
            r = {"name": name, "shape": tuple(shape), "copies": copies,
                 "bytes": moved_bytes(name, shape), "flows": {}}
            cuda = dev.type == "cuda"
            for flow, fns in flows.items():
                if not fns:
                    continue
                r["flows"][flow] = {"out": fns[0](),
                                    "warm_ms": device_ms(fns[0]) if cuda else None,
                                    "cold_ms": device_ms_cold(fns) if cuda else None}
            rows.append(r)
            del flows
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return rows


def parse_shapes(argv: List[str]) -> Optional[dict]:
    """``name:d0,d1,d2`` arguments -> {name: [shape, ...]}."""
    if not argv:
        return None
    out = {}
    for arg in argv:
        name, dims = arg.split(":")
        if name not in DEFAULT_SHAPES:
            raise ValueError(f"unknown name {name!r} (one of {sorted(DEFAULT_SHAPES)})")
        out.setdefault(name, []).append(tuple(int(v) for v in dims.split(",")))
    return out


def main(argv: Optional[List[str]] = None) -> List[dict]:
    argv = sys.argv[1:] if argv is None else argv
    dev = torch.device("cuda")
    print(f"#10 and #11 at K = 64 on {device_label(dev)}: ms warm "
          f"(one set of weights, in L2) and cold (weight copies over {COLD_BYTES / 1e6:.0f} MB)",
          flush=True)
    rows = run(parse_shapes(argv))
    for r in rows:
        bound = r["bytes"] / HBM * 1e3
        for flow, f in r["flows"].items():
            print(f"{r['name']:8s} {str(r['shape']):24s} {flow:10s} warm {f['warm_ms']!r} ms, "
                  f"cold {f['cold_ms']!r} ms ({r['copies']} copies), bytes bound {bound!r} ms, "
                  f"cold at {bound / f['cold_ms']!r} of it", flush=True)
    print(f"card, power limit, SM clock, max SM clock: {clocks()}", flush=True)
    return rows


if __name__ == "__main__":
    main()
