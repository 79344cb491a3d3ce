"""Kernels C and #13: matmuls with fused int4 / int8 dequantisation.

Replaces the Pallas kernel ``diffusionkit_tpu/ops/int4_matmul.py:int4_matmul``
(``_kernel``), which runs every block linear of the int4 MMDiT (FLUX.1-schnell
4-bit: q/k/v/o/fc1/fc2 and the AdaLN ``ada`` projections of 19 dual-stream
and 38 single-stream blocks). It computes ``y[M, N] = x[M, K] @ W`` where
``W = q * scale + zero`` is dequantised in fp32 from the packed words of
``ops/quantized.py``, ROUNDED TO x's DTYPE before the product, accumulated
in fp32 and rounded once. Two CUDA main loops run it in bf16, picked by
``dequant_route``: at M > 16 ``csrc/int4_matmul_sm90.cu`` (TMA, bf16
``wgmma``, the dequantisation beside the products), at M <= 16 (the ``ada``
GEMVs) the split-K GEMV of ``csrc/gemv_sm90.cu`` (``gemv_splits`` blocks
along K, each streaming its slab of the weight once, their partial sums
added in split order in a workspace); the notes there say what bounds each
and how it is tiled. An fp32 x (the linears of an fp32-upcast block, as
SD3.5-large's block 35, or an fp32 model) takes fp32 forms of the same two
routes, the weight dequantised in fp32 and not rounded further, fp32 out
(counted in ``f32_launches`` too): above 16 rows ``csrc/dequant_f32.cu``,
the products as 3xTF32 ``wgmma``; at M <= 16 (an fp32 model's ``ada``
GEMVs) ``csrc/gemv_sm90.cu``'s fp32 split-K GEMV, the products as fp32 FMAs
(counted in ``gemv_launches`` too). ``out_dtype=torch.float32`` on bf16 x
asks the bf16 loops for their fp32 sums unrounded (``_f32out`` entries,
counted in ``f32out_launches``): a row-parallel linear's partial product,
which ``ops/common.py`` sums over the ranks and rounds once.

``int4_matmul`` launches the kernel for a CUDA tensor and raises on what it
does not take (bf16 or fp32 x, K a multiple of 64, N of 128, group 32 or a
multiple of 64); a CPU tensor goes to ``int4_matmul_plain``, the same math
in plain torch. The reference's TPU tile pickers (``pick_k_block``, ``pick_m_block``,
``_maybe_pad_n``) and its padding of M are not carried over as tilings: the
kernel masks the ragged M edge itself.

Which packed linears reach a kernel at all is the kernels' own shape
rule, ``kernel_takes``: the K, N and group that ``dequant_kernel`` (C, #13)
and ``w4a8_matmul.w4a8_kernel`` (E, and #10 then #11) raise on. Any other
packed linear (the MLX 4-bit releases' ``final_layer.linear``, N = 64)
takes ``dequant_linear``, the reference's path off its kernel: the weight
dequantised and rounded to x's dtype, one product with fp32 accumulation,
the bias added and the GELU applied in fp32, one rounding.
``ops/common.linear`` decides it before any launch, for int4, int8 and
w4a8 layers alike.

Kernel #13 ``int8_matmul`` replaces the reference's ``int8_matmul``
(``_kernel8``), the int8 weight-only mode's product: the same with ``q8``
uint8 (K, N) bytes, values 0..255, in place of the nibbles (``int8_linear``
applies it as ``int4_linear`` applies C). Its CUDA sources are C's, with
bytes in place of words, routed the same way.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import kernels

# Kernel tiling constraints (csrc/gemv_sm90.cu, csrc/int4_matmul_sm90.cu),
# and kernel E's K tile (csrc/w4a8_matmul_sm90.cu).
K_TILE, N_TILE, W4A8_K_TILE = 64, 128, 128
# Rows at or below which C and #13 (and E's mode plain) run the split-K GEMV
# (the `ada` projections); above, the Hopper main loop's 256-row blocks.
SMALL_M = 16
# The GEMV's split of K (``gemv_splits``): at most 8 blocks a column tile,
# each a whole number of 64-k parts and groups, chosen for the H100 SXM's
# 132 SMs at the kernel's 2 resident blocks a SM.
GEMV_PART_K, GEMV_MAX_SPLITS, GEMV_SLOTS = 64, 8, 2 * 132
# The cost of one more split against a wave's, fitted to the card's times
# of S = 2..8 at the paths' shapes (tools/bench_gemv.py).
GEMV_SPLIT_COST = 0.015
# The device type whose tensors ``_launch`` hands to the kernels.
CARD = "cuda"


def kernel_takes(k: int, n: int, groups: int, wscale: bool = False) -> bool:
    """Whether the kernels take a packed weight of K = ``k`` and N = ``n``
    in ``groups`` scale rows, at any M: for C and #13 K a multiple of 64, N
    of 128 and the group K / groups 32 or a multiple of 64; with a w4a8
    ``wscale`` (E, and #10 then #11) K a multiple of 128, N of 128 and the
    group 32, 64 or a multiple of 128. ``dequant_kernel`` and
    ``w4a8_matmul.w4a8_kernel`` raise on what it refuses, and
    ``ops/common.linear`` sends it to ``dequant_linear``."""
    if groups <= 0 or k % groups or n % N_TILE:
        return False
    group = k // groups
    if wscale:
        return k % W4A8_K_TILE == 0 and (group in (32, 64) or group % W4A8_K_TILE == 0)
    return k % K_TILE == 0 and (group == 32 or group % 64 == 0)


def dequant_linear(layer, x: torch.Tensor, act: Optional[str] = None) -> torch.Tensor:
    """A packed linear (int4 or int8, a w4a8 ``wscale`` unused) off the
    kernels, as the reference's ``quantized_linear`` computes one that
    ``kernel_takes`` turns away: the weight dequantised in fp32 and
    rounded to x's dtype, the product accumulated in fp32, the bias added
    in fp32, the exact (erf) GELU in fp32, then one rounding to x's dtype.
    Plain torch on every device."""
    deq = dequantize_int4 if layer.bits == 4 else dequantize_int8
    w = deq(layer.q4 if layer.bits == 4 else layer.q8, layer.scales, layer.zeros, x.dtype)
    y = torch.matmul(x.float(), w.float())
    if layer.bias is not None:
        y = y + layer.bias.float()
    if act == "gelu":
        y = F.gelu(y)
    return y.to(x.dtype)


def dequant_route(m: int) -> str:
    """The main loop of kernels C and #13 for ``m`` rows, in bf16 and in
    fp32 alike: ``"sm90"`` (csrc/int4_matmul_sm90.cu; in fp32
    csrc/dequant_f32.cu) above ``SMALL_M``, else ``"gemv"``, the split-K
    GEMV (csrc/gemv_sm90.cu)."""
    return "sm90" if m > SMALL_M else "gemv"


def gemv_splits(k: int, n: int, group: int) -> int:
    """S, the blocks that split K for the M <= 16 GEMV of kernels C, #13 and
    E (csrc/gemv_sm90.cu): among the S <= 8 for which each split is whole
    64-k parts and groups, the one that minimises the waves of resident
    blocks a split costs, ceil((N / 128) S / GEMV_SLOTS) / S, plus
    ``GEMV_SPLIT_COST`` S for each split's own start and partial sum; the
    smaller S on a tie. A pure function of the shape, so the CPU tests hold
    it."""
    unit = math.lcm(GEMV_PART_K, group)
    tiles = n // N_TILE
    best, best_cost = 1, math.inf
    for s in range(1, GEMV_MAX_SPLITS + 1):
        if k % (s * unit):
            continue
        cost = -(-tiles * s // GEMV_SLOTS) / s + GEMV_SPLIT_COST * s
        if cost < best_cost - 1e-12:
            best, best_cost = s, cost
    return best


def dequant_kernel(name: str, m: int, k: int, k_w: int, n: int, groups: int,
                   dtype: torch.dtype = torch.bfloat16,
                   out_dtype: Optional[torch.dtype] = None) -> str:
    """The C entry that runs kernel C (``name`` int4_matmul) or #13
    (int8_matmul) at these sizes for x of ``dtype`` and y of ``out_dtype``
    (x's by default) on the main loop ``dequant_route`` picks: in bf16
    (its ``_f32out`` form for an fp32 y) or in fp32; or ValueError for
    what none takes: K = ``k_w`` a multiple of 64, N of 128, group K /
    groups 32 or a multiple of 64, at any M; TypeError for another dtype,
    or a bf16 y of fp32 x."""
    if k_w != k or not kernel_takes(k, n, groups):
        raise ValueError(f"{name}: K={k} must match the weight's {k_w} and be a multiple of "
                         f"{K_TILE}, N={n} a multiple of {N_TILE}, the group size K/{groups} "
                         f"32 or a multiple of 64")
    out_dtype = dtype if out_dtype is None else out_dtype
    if out_dtype not in (dtype, torch.float32):
        raise TypeError(f"{name}: y must be x's dtype or fp32, got {out_dtype} for {dtype} x")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: x must be bf16 or fp32 on the card, got {dtype}")
    route = "_sm90" if dequant_route(m) == "sm90" else ""
    if dtype == torch.float32:
        return f"dk_{name}{route}_f32"
    out = "_f32out" if out_dtype == torch.float32 else ""
    return f"dk_{name}{route}_bf16{out}"


def dequantize_int4(
    q4: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """(K/8, N) packed words -> (K, N) weights: nibbles to fp32, ``q * scale
    + zero`` in fp32 (a product and a sum, each rounded), then one rounding
    to ``dtype``."""
    k8, n = q4.shape
    shifts = torch.arange(0, 32, 4, dtype=torch.int32, device=q4.device)
    q = (q4[:, None, :] >> shifts[None, :, None]) & 0xF
    q = q.reshape(k8 * 8, n).float()
    g = q.shape[0] // scales.shape[0]
    s = scales.float().repeat_interleave(g, dim=0)
    z = zeros.float().repeat_interleave(g, dim=0)
    return (q * s + z).to(dtype)


def _plain(x: torch.Tensor, w: torch.Tensor, out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """x @ w (w already dequantised and rounded to x's dtype): one matmul in
    x's dtype (fp32 accumulation, one rounding), or for an fp32
    ``out_dtype`` the fp32 matmul with no rounding (the products of 16-bit
    values are exact in fp32)."""
    if out_dtype is None or out_dtype == x.dtype:
        return torch.matmul(x, w)
    if out_dtype != torch.float32:
        raise TypeError(f"y must be x's dtype or fp32, got {out_dtype} for {x.dtype} x")
    return torch.matmul(x.float(), w.float())


def int4_matmul_plain(
    x: torch.Tensor, q4: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain torch ``int4_matmul``: the weight dequantised and rounded to x's
    dtype, then one matmul (fp32 accumulation, one rounding to x's dtype,
    or none for an fp32 ``out_dtype``)."""
    return _plain(x, dequantize_int4(q4, scales, zeros, x.dtype), out_dtype)


def int4_matmul(
    x: torch.Tensor, q4: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """y[M, N] = x[M, K] @ dequant(q4, scales, zeros), in x's dtype, or in
    fp32 unrounded with ``out_dtype=torch.float32``.

    On CUDA: x bf16 or fp32 with a contiguous last axis and 16-byte aligned
    rows (other row strides, such as a slice of a wider activation, are
    read in place); q4 int32 (K/8, N), scales and zeros fp32 (K/g, N),
    contiguous.
    """
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q4, scales, zeros, out_dtype)
    if q4.dtype != torch.int32 or q4.ndim != 2:
        raise TypeError(f"int4_matmul: q4 must be int32 (K/8, N), got {q4.dtype} "
                        f"{tuple(q4.shape)}")
    return _launch(int4_matmul, x, q4, q4.shape[0] * 8, q4.shape[1], scales, zeros, out_dtype)


def _launch(wrapper, x: torch.Tensor, qw: torch.Tensor, k_w: int, n: int,
            scales: torch.Tensor, zeros: torch.Tensor,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Check what kernels C and #13 take and launch the entry of
    ``wrapper`` (int4_matmul or int8_matmul) for this M (``dequant_kernel``;
    the GEMV with ``gemv_splits``), counting it: x bf16 or fp32 (M, K) with
    a contiguous last axis and 16-byte aligned rows, K = ``k_w`` a multiple of
    64, N of 128, group 32 or a multiple of 64; the packed weight ``qw``,
    scales and zeros (K/g, N) fp32, contiguous; y in ``out_dtype`` (x's
    dtype by default, or fp32)."""
    name = wrapper.__name__
    if x.device.type != CARD:
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.ndim != 2:
        raise ValueError(f"{name}: x must be (M, K), got {tuple(x.shape)}")
    m, k = x.shape
    groups = scales.shape[0]
    out_dtype = x.dtype if out_dtype is None else out_dtype
    symbol = dequant_kernel(name, m, k, k_w, n, groups, x.dtype, out_dtype)
    group = k // groups
    if scales.dtype != torch.float32 or zeros.dtype != torch.float32:
        raise TypeError(f"{name}: scales and zeros must be fp32")
    for arg, t in (("weight", qw), ("scales", scales), ("zeros", zeros)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be contiguous and 16-byte aligned on "
                             f"{x.device}")
    if scales.shape != (groups, n) or zeros.shape != (groups, n):
        raise ValueError(f"{name}: scales and zeros must be ({groups}, {n})")
    if x.stride(1) != 1 or (x.stride(0) * x.element_size()) % 16 or x.data_ptr() % 16:
        raise ValueError(f"{name}: x needs a contiguous last axis and 16-byte aligned rows, "
                         f"got strides {x.stride()}")
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m:
        f32 = x.dtype == torch.float32
        gemv = dequant_route(m) == "gemv"
        split = ()
        if gemv:  # S blocks along K and their fp32 partial sums
            s = gemv_splits(k, n, group)
            partials = torch.empty(s * m * n, dtype=torch.float32, device=x.device)
            split = (s, partials.data_ptr())
        err = getattr(kernels.library(), symbol)(
            x.data_ptr(), qw.data_ptr(), scales.data_ptr(), zeros.data_ptr(), y.data_ptr(),
            m, n, k, group, x.stride(0), *split, kernels.stream_ptr(x.device),
        )
        kernels.check(err, name)
        wrapper.launches += 1
        wrapper.gemv_launches += gemv
        wrapper.f32_launches += f32
        wrapper.f32_gemv_launches += f32 and gemv
        wrapper.f32out_launches += not f32 and out_dtype == torch.float32
    return y


int4_matmul.launches = 0
int4_matmul.gemv_launches = 0  # of them, the M <= 16 GEMV's (bf16 or fp32 x)
int4_matmul.f32_launches = 0  # of them, on fp32 x
int4_matmul.f32_gemv_launches = 0  # of them, the fp32 GEMV's
int4_matmul.f32out_launches = 0  # of them, bf16 x to an fp32 y (the _f32out entries)


def dequantize_int8(
    q8: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """(K, N) uint8 -> (K, N) weights: ``q * scale + zero`` in fp32 (a
    product and a sum, each rounded), then one rounding to ``dtype``."""
    q = q8.float()
    g = q.shape[0] // scales.shape[0]
    s = scales.float().repeat_interleave(g, dim=0)
    z = zeros.float().repeat_interleave(g, dim=0)
    return (q * s + z).to(dtype)


def int8_matmul_plain(
    x: torch.Tensor, q8: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain torch ``int8_matmul``: the weight dequantised and rounded to x's
    dtype, then one matmul (fp32 accumulation, one rounding to x's dtype,
    or none for an fp32 ``out_dtype``)."""
    return _plain(x, dequantize_int8(q8, scales, zeros, x.dtype), out_dtype)


def int8_matmul(
    x: torch.Tensor, q8: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """y[M, N] = x[M, K] @ dequant(q8, scales, zeros), in x's dtype (or fp32
    unrounded with ``out_dtype=torch.float32``).

    On CUDA: as ``int4_matmul``, with q8 uint8 (K, N) contiguous.
    """
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q8, scales, zeros, out_dtype)
    if q8.dtype != torch.uint8 or q8.ndim != 2:
        raise TypeError(f"int8_matmul: q8 must be uint8 (K, N), got {q8.dtype} {tuple(q8.shape)}")
    return _launch(int8_matmul, x, q8, q8.shape[0], q8.shape[1], scales, zeros, out_dtype)


int8_matmul.launches = 0
int8_matmul.gemv_launches = 0
int8_matmul.f32_launches = 0
int8_matmul.f32_gemv_launches = 0
int8_matmul.f32out_launches = 0


def int4_linear(layer, x: torch.Tensor, act: Optional[str] = None) -> torch.Tensor:
    """Apply an int4 ``QuantizedLinear`` to x (..., K) -> (..., N), as the
    reference's ``int4_linear``: the product (kernel C) rounded to x's
    dtype, then the bias added in fp32 and rounded again, then the exact
    (erf) GELU in x's dtype."""
    return _weight_only_linear(int4_matmul, layer.q4, layer, x, act)


def int8_linear(layer, x: torch.Tensor, act: Optional[str] = None) -> torch.Tensor:
    """``int4_linear`` for an int8 ``QuantizedLinear`` (kernel #13), as the
    reference's ``int8_linear``."""
    return _weight_only_linear(int8_matmul, layer.q8, layer, x, act)


def _weight_only_linear(matmul, qw: torch.Tensor, layer, x: torch.Tensor,
                        act: Optional[str]) -> torch.Tensor:
    lead, k = x.shape[:-1], x.shape[-1]
    y = matmul(x.reshape(-1, k), qw, layer.scales, layer.zeros)
    y = y.reshape(*lead, y.shape[-1])
    if layer.bias is not None:
        y = (y.float() + layer.bias.float()).to(x.dtype)
    if act == "gelu":
        y = F.gelu(y)
    return y
