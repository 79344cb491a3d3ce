"""Device times of the M <= 16 GEMVs of kernels C, #13, E and #11, warm
and cold.

    python -m diffusionkit_tpu_torch.tools.bench_gemv [M,K,N[,group] ...]

At each (M, K, N, group) (by default the `ada` projections of the measured
paths: FLUX.1's dual and single blocks at M = 1, group 64, through C and E;
SD3-medium's blocks, final layer and embedders at M = 2, group 32, through
#13), on random packed weights: ``int4_matmul`` (C) and ``w4a8_matmul`` in
mode plain (E) where K and the group allow them, ``int8_matmul`` (#13) at
M = 2's shapes and wherever it is named alone; ``int4_matmul[f32]`` and
``int8_matmul[f32]``, C and #13 on fp32 x (an fp32 model's `ada`: the fp32
GEMV), at the fp32 paths' shapes and wherever C is named. At each (M, K, N) (by
default the same SD3 shapes, which SD3-medium w8a8 runs through #11) on
random int8 weights: ``w8_matmul`` on int8 x (#11's int8 entry),
``quantize_w8_matmul`` on bf16 x (its quantizing entry, where the tree has
it) and ``quantize+w8_matmul``, kernel D then #11 on the same bf16 x. Each
is timed warm by ``device_ms`` (20 calls on one weight, which stays in the
L2) and cold by ``device_ms_cold`` (one call on each of enough copies of
the weight to pass 100 MB, so each call reads it from device memory, as
each `ada` weight of a denoise step is read once). Only the wrappers'
public calls are used, so the same script times any tree of the package
that has them (a name whose wrapper the tree lacks is left out). With
``device="cpu"`` (the tests) each runs its plain version once and no time
is taken.
"""

from __future__ import annotations

import math
import sys
from typing import Callable, List, Optional, Tuple

import torch

from ..ops import w4a8_matmul as w8_ops
from ..ops.fused_quant import quantize
from ..ops.int4_matmul import int4_matmul, int8_matmul
from ..ops.w4a8_matmul import w4a8_matmul
from ..ops.w8a8 import quantize_activations
from . import device_label, device_ms, device_ms_cold

DEFAULT_GEMV_SHAPES = {
    "int4_matmul": ((1, 3072, 18432, 64), (1, 3072, 9216, 64)),
    "w4a8_matmul": ((1, 3072, 18432, 64), (1, 3072, 9216, 64)),
    "int8_matmul": ((2, 1536, 9216, 32), (2, 1536, 3072, 32), (2, 2048, 1536, 32),
                    (2, 256, 1536, 32), (2, 1536, 1536, 32)),
    **{name: ((2, 1536, 9216), (2, 1536, 3072), (2, 2048, 1536), (2, 256, 1536),
              (2, 1536, 1536))
       for name in ("w8_matmul", "quantize_w8_matmul", "quantize+w8_matmul")},
    # fp32 FLUX's dual and single-block `ada` (path z), SD3.5-large's, and
    # fp32 SD3-medium int8's (path y).
    "int4_matmul[f32]": ((1, 3072, 18432, 64), (1, 3072, 9216, 64), (2, 2432, 14592, 64)),
    "int8_matmul[f32]": ((2, 1536, 9216, 32), (2, 2432, 14592, 64)),
}
# #11's names (shapes (M, K, N)): the int8 entry, the quantizing entry, and
# kernel D then #11.
W8_NAMES = ("w8_matmul", "quantize_w8_matmul", "quantize+w8_matmul")
COLD_BYTES = 100e6  # the copies' weights together, twice the L2


def weight_bytes(name: str, k: int, n: int, group: int = 0) -> int:
    """The bytes of a layer's weight: packed with its scale and zero rows,
    or #11's int8 w8 with its fp32 wscale."""
    if name in W8_NAMES:
        return k * n + 4 * n
    return (k * n if name.startswith("int8_matmul") else k * n // 2) + 8 * (k // group) * n


def available(name: str) -> bool:
    """Whether this tree of the package has ``name``'s wrapper (the
    quantizing entry of #11 is newer than the others)."""
    return name != "quantize_w8_matmul" or hasattr(w8_ops, "quantize_w8_matmul")


def layer(name: str, k: int, n: int, group: int, gen, dev) -> tuple:
    """One random packed layer: the weight, scales and zeros (and, for E,
    its per-channel wscale and a bf16 bias), weights of about 1/sqrt(K)."""
    if name.startswith("int8_matmul"):
        qw = torch.randint(0, 256, (k, n), generator=gen, device=dev, dtype=torch.uint8)
        levels = 255
    else:
        qw = torch.randint(-(2**31), 2**31, (k // 8, n), generator=gen, device=dev,
                           dtype=torch.int32)
        levels = 15
    scales = (torch.rand(k // group, n, generator=gen, device=dev) + 0.5) * (2 / levels / k**0.5)
    zeros = -(torch.rand(k // group, n, generator=gen, device=dev) + 0.5) / k**0.5
    if name != "w4a8_matmul":
        return qw, scales, zeros
    wscale = (torch.rand(n, generator=gen, device=dev) + 0.5) * (2 / 127 / k**0.5)
    bias = (0.1 * torch.randn(n, generator=gen, device=dev)).bfloat16()
    return qw, scales, zeros, wscale, bias


def w8_calls(name: str, shape, copies: int, gen, dev) -> List[Callable]:
    """#11's calls (``W8_NAMES``) at (M, K, N), each on its own w8, wscale
    and bf16 bias, all on one activation: bf16 x, and its int8 x8 and
    scales (kernel D's plain version) for the int8 entry."""
    m, k, n = shape
    x = (2 * torch.randn(m, k, generator=gen, device=dev)).bfloat16()
    x8, xs = quantize_activations(x)
    out = []
    for _ in range(copies):
        w8 = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
        ws = (torch.rand(n, generator=gen, device=dev) + 0.5) / (127 * k**0.5)
        b = (0.1 * torch.randn(n, generator=gen, device=dev)).bfloat16()
        if name == "w8_matmul":
            out.append(lambda w8=w8, ws=ws, b=b: w8_ops.w8_matmul(x8, w8, ws, xs, b))
        elif name == "quantize_w8_matmul":
            out.append(lambda w8=w8, ws=ws, b=b: w8_ops.quantize_w8_matmul(x, w8, ws, b))
        else:
            def staged(w8=w8, ws=ws, b=b):
                aq = quantize(x)
                return w8_ops.w8_matmul(aq.x8.reshape(m, k), w8, ws, aq.xscale.reshape(m, 1), b)
            out.append(staged)
    return out


def calls(name: str, shape, copies: int, gen, dev) -> List[Callable]:
    """``copies`` calls of ``name`` at ``shape``, each on its own layer and
    all on one activation (bf16, or int8 with per-row scales for E)."""
    if name in W8_NAMES:
        return w8_calls(name, shape, copies, gen, dev)
    m, k, n, group = shape
    if name == "w4a8_matmul":
        x8 = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        xs = (torch.rand(m, 1, generator=gen, device=dev) + 0.5) / (127 * k**0.5)
        out = []
        for _ in range(copies):
            q4, s, z, ws, b = layer(name, k, n, group, gen, dev)
            out.append(lambda q4=q4, s=s, z=z, ws=ws, b=b: w4a8_matmul(x8, q4, s, z, ws, xs, b))
        return out
    fn = int8_matmul if name.startswith("int8_matmul") else int4_matmul
    x = torch.randn(m, k, generator=gen, device=dev)
    if not name.endswith("[f32]"):
        x = x.bfloat16()
    out = []
    for _ in range(copies):
        qw, s, z = layer(name, k, n, group, gen, dev)
        out.append(lambda qw=qw, s=s, z=z: fn(x, qw, s, z))
    return out


@torch.inference_mode()
def run(shapes: Optional[dict] = None, device="cuda") -> List[dict]:
    """One row per kernel name and (M, K, N, group): its warm and cold ms
    (None on the CPU), the copies timed cold, the weight's bytes and the
    first call's output."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name, name_shapes in (shapes or DEFAULT_GEMV_SHAPES).items():
        if not available(name):
            continue
        for shape in name_shapes:
            wbytes = weight_bytes(name, *shape[1:])
            copies = math.ceil(COLD_BYTES / wbytes) + 1 if dev.type == "cuda" else 1
            fns = calls(name, shape, copies, gen, dev)
            y = fns[0]()
            warm = device_ms(fns[0]) if dev.type == "cuda" else None
            cold = device_ms_cold(fns) if dev.type == "cuda" else None
            rows.append({"name": name, "shape": tuple(shape), "warm_ms": warm, "cold_ms": cold,
                         "copies": copies, "weight_bytes": wbytes, "y": y})
            del fns
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return rows


def parse_shapes(argv: List[str]) -> Optional[dict]:
    """``M,K,N,group`` arguments -> every kernel that takes each shape (C
    and #13 on bf16 and on fp32 x; E needs K a multiple of 128 and group
    32, 64 or a multiple of 128);
    ``M,K,N`` arguments -> #11's three names."""
    if not argv:
        return None
    out = {name: [] for name in DEFAULT_GEMV_SHAPES}
    for arg in argv:
        dims = tuple(int(v) for v in arg.split(","))
        if len(dims) == 3:
            for name in W8_NAMES:
                out[name].append(dims)
            continue
        m, k, n, group = dims
        for name in ("int4_matmul", "int8_matmul", "int4_matmul[f32]", "int8_matmul[f32]"):
            out[name].append((m, k, n, group))
        if k % 128 == 0 and (group in (32, 64) or group % 128 == 0):
            out["w4a8_matmul"].append((m, k, n, group))
    return out


def main(argv: Optional[List[str]] = None) -> List[dict]:
    argv = sys.argv[1:] if argv is None else argv
    dev = torch.device("cuda")
    print(f"M <= 16 GEMVs on {device_label(dev)}: ms warm (one weight, in L2) and cold "
          f"(weight copies over {COLD_BYTES / 1e6:.0f} MB)", flush=True)
    rows = run(parse_shapes(argv))
    for r in rows:
        gbs = r["weight_bytes"] / (r["cold_ms"] / 1e3) / 1e12
        print(f"{r['name']:18s} {str(r['shape']):24s} warm {r['warm_ms']!r} ms, cold "
              f"{r['cold_ms']!r} ms ({gbs!r} TB/s of weight, scales and zeros; "
              f"{r['copies']} copies)", flush=True)
    return rows


if __name__ == "__main__":
    main()
