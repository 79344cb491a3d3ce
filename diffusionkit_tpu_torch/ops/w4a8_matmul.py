"""Kernel E: int4-packed weights x int8 activations on the int8 tensor cores.

Replaces the Pallas kernel ``diffusionkit_tpu/ops/w4a8_matmul.py:
w4a8_matmul`` and its four modes (epilogues on one main loop), which run
every block linear of the w4a8 FLUX model:

  plain       ``y = (x8 @ w8) * xscale * wscale + bias`` (ada, v, o, the text
              stream's q/k/v/o)
  norm_rope   plain, then per-128-column-head QK-RMSNorm and rotate-half
              RoPE in fp32 (the image and single-stream q/k)
  gelu_quant  plain, then the A&S-erf GELU and int8 per (row, 512-column
              tile): ``(y8, yscale)`` (every FFN's fc1)
  grouped_xs  activation scales per (row, 512-wide k group), each group's
              exact int32 partial rescaled into an fp32 sum (every fc2)

The packed int4 weight is requantised per tile onto the per-channel int8
grid ``w8 = clip(round_half_even(q * s8 + z8), -127, 127)``, with
``s8 = scales * (1 / wscale)`` and ``z8 = zeros * (1 / wscale)``, each a
separately rounded fp32 operation (``requant_w8_plain`` is the reference's
``dequant_w8``). ``w4a8_route`` picks the dataflow: mode plain at M <= 16
(the ``ada`` GEMVs) the split-K GEMV of ``csrc/gemv_sm90.cu`` (kernel C's,
``int4_matmul.gemv_splits`` blocks along K); mode plain above 16 rows the
reference's materialised dataflow, #10 ``dequant_w8`` then #11
``w8_matmul`` (the grid written once a call, then a requant-free int8
product), which the card's A/B found faster at every shape it timed
(``w4a8_route``); the other three modes ``csrc/w4a8_matmul_sm90.cu`` (TMA, int8
``wgmma``, the requantisation beside the products), which also still
takes mode plain at any M when asked (the private ``_route="sm90"``, by
which the tests and tools hold it); the notes in the sources say what
bounds each and how it is tiled.

``w4a8_matmul`` launches the kernel for a CUDA tensor (counting kernel E's
launches per mode, and the calls it routes to #10 then #11 in
``mat_launches``) and raises on what it does not take; a CPU tensor goes to
``w4a8_matmul_plain``, the same math in plain torch with the int32 product
computed exactly. The reference's TPU tile pickers (``_pick_kn_blocks``,
``pick_m_block``) and its N padding (``_maybe_pad_n``, bit-identical by its
own account and a no-op at FLUX's shapes) are not carried over.

Kernel #11 ``w8_matmul`` (the reference's ``w8_matmul``, ``_kernel_w8``) is
the w8a8 linear's product: an int8 (N, K) weight grid, ``y = (x8 @ w8^T) *
xscale * wscale + bias``, the epilogue in that order with the int32
accumulator kept on chip. ``w8_route`` picks its main loop: at M <= 16
with K a multiple of 256 and N of 64 (the `ada` and embedder projections)
the GEMV of ``csrc/gemv_sm90.cu``; at M > 16 ``csrc/w8_matmul_sm90.cu``
(TMA-fed int8 ``wgmma``; 64-deep k stages where K % 128 == 64);
``csrc/w8_matmul.cu`` otherwise. ``quantize_w8_matmul`` is the GEMV's
quantizing entry: a float x quantized in the kernel, bit for bit kernel D
then #11, so the `ada` projections of a w8a8 model need no launch of D. ``w8_matmul_plain`` and
``quantize_w8_matmul_plain`` are their plain versions.

Kernel #10 ``dequant_w8`` (the reference's ``dequant_w8_pallas``)
materialises the int8 grid of a packed layer, as (N, K), the layout
``w8_matmul`` reads (mode plain's route above 16 rows, once a call: the
weights stay int4 at rest); ``dequant_w8_plain`` is ``requant_w8_plain``
transposed. Kernel #16 ``int8_dot`` (the reference's bare
``tools/microbench_pallas_int8.py:pallas_int8_matmul``) is ``w8_matmul``'s
main loop storing the exact int32 product; ``int8_dot_plain`` computes it
exactly. The two tools that run them are ``diffusionkit_tpu_torch.tools``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import kernels
from .int4_matmul import W4A8_K_TILE as K_TILE
from .int4_matmul import gemv_splits, kernel_takes
from .w8a8 import ActQuant

# The activation-scale tile of the FFN hidden: fc1's gelu_quant column tile
# and fc2's grouped_xs k group. It is the reference's fc1 n block at every
# FLUX shape on the CPU and on a v5e (ops/chip.py would make it 1024 on a
# v6e), the value its CPU tests hold; fixed here.
SCALE_TILE = 512
HEAD_DIM = 128  # norm_rope's head width
MODES = {"plain": 0, "gelu_quant": 1, "grouped_xs": 2, "norm_rope": 3}
# Column tile of each mode's kernel configuration (csrc/w4a8_matmul_sm90.cu,
# csrc/gemv_sm90.cu).
N_TILE = {"plain": 128, "gelu_quant": SCALE_TILE, "grouped_xs": 128, "norm_rope": HEAD_DIM}
# Rows at or below which kernel E's mode plain runs the split-K GEMV (the
# `ada` projections); above them mode plain runs #10 then #11, the other
# modes the Hopper main loop.
SMALL_M = 16
# The C entry each route runs first: kernel E's two main loops, and #10's
# (then #11's, ``w8_matmul``) for the materialised dataflow.
_E_SYMBOLS = {"sm90": "dk_w4a8_matmul_sm90", "gemv": "dk_w4a8_matmul", "mat": "dk_dequant_w8"}


def w4a8_route(m: int, mode: str) -> str:
    """The dataflow of ``w4a8_matmul`` for ``m`` rows in ``mode``. Mode
    plain: ``"gemv"``, kernel E's split-K GEMV (csrc/gemv_sm90.cu), at M <=
    ``SMALL_M``; ``"mat"``, #10 ``dequant_w8`` then #11 ``w8_matmul``, above
    it. The other modes: ``"sm90"`` (csrc/w4a8_matmul_sm90.cu) at every M.

    "mat" rests on the A/B of ``tools/bench_w4a8_mat.py ab`` on an H100 (E
    at 1.40-1.83x its time, cold and warm) at K = N = 3072, every plain
    shape of the FLUX w4a8 paths (M = 256, 4096, 4352, 16384 and 16640 at
    group 64, 4352 at 32) and off them at M = 17, 32, 64, 128 and 192
    (group 64) and groups 128 and 256 (M = 256, 4352); chip_smoke.py
    checks the paths' shapes and ``AB_EDGES`` each run. Other K and N
    (no FLUX w4a8 plain linear has them) take "mat" unmeasured."""
    if mode != "plain":
        return "sm90"
    return "gemv" if m <= SMALL_M else "mat"


def w4a8_kernel(m: int, k: int, k8: int, n: int, groups: int, mode: str,
                route: Optional[str] = None) -> str:
    """The C entry that runs ``route`` (by default ``w4a8_route``'s) at
    these sizes, or ValueError for a route that does not take ``m`` rows in
    ``mode`` (``"gemv"`` and ``"mat"`` are mode plain's, ``"gemv"`` at M <=
    ``SMALL_M`` only) or a shape that kernel E does not take: K = 8 * k8 a
    multiple of 128, N of the mode's column tile, group K / groups 32, 64 or
    a multiple of 128, K a multiple of 512 for grouped_xs, at any M (#10
    then #11 take every such shape)."""
    if k8 * 8 != k or not kernel_takes(k, n, groups, wscale=True) or n % N_TILE[mode]:
        raise ValueError(f"w4a8_matmul: K={k} must be 8 * {k8} and a multiple of {K_TILE}, "
                         f"N={n} a multiple of {N_TILE[mode]} ({mode}), the group size "
                         f"K/{groups} 32, 64 or a multiple of {K_TILE}")
    if mode == "grouped_xs" and k % SCALE_TILE:
        raise ValueError(f"w4a8_matmul: grouped_xs needs K a multiple of {SCALE_TILE}, got {k}")
    route = route or w4a8_route(m, mode)
    if route not in _E_SYMBOLS or (route != "sm90" and mode != "plain") or (
            route == "gemv" and m > SMALL_M):
        raise ValueError(f"w4a8_matmul: route {route!r} does not take M={m} in mode {mode}")
    return _E_SYMBOLS[route]


def _div(num: float, t: torch.Tensor) -> torch.Tensor:
    """``num / t`` as one IEEE division on any device (torch computes a
    scalar divisor on CUDA as a reciprocal product, and ``num / t`` as
    ``reciprocal(t) * num``)."""
    return torch.full_like(t, num) / t


def scaled_affine(scales: torch.Tensor, zeros: torch.Tensor,
                  wscale: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(s8, z8)``: the group affine on the int8 grid, ``scales * (1 /
    wscale)`` and ``zeros * (1 / wscale)`` (the reciprocal first, then the
    product, as the reference's ``_scaled_affine``)."""
    rws = _div(1.0, wscale.float())
    return scales.float() * rws, zeros.float() * rws


def requant_w8_plain(q4: torch.Tensor, s8: torch.Tensor, z8: torch.Tensor) -> torch.Tensor:
    """(K/8, N) packed words -> (K, N) int8 grid: ``clip(round_half_even(q *
    s8 + z8), -127, 127)``, the product and the sum each rounded in fp32
    (the reference's ``dequant_w8``)."""
    k8, n = q4.shape
    shifts = torch.arange(0, 32, 4, dtype=torch.int32, device=q4.device)
    q = ((q4[:, None, :] >> shifts[None, :, None]) & 0xF).reshape(k8 * 8, n).float()
    g = q.shape[0] // s8.shape[0]
    y = q * s8.repeat_interleave(g, dim=0) + z8.repeat_interleave(g, dim=0)
    return torch.round(y).clamp_(-127, 127).to(torch.int8)


def _int_dot(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """The exact int32 product ``x8 @ w8`` as fp32 (one rounding, as the
    kernel's int -> float conversion): ``torch._int_mm`` on the card where
    its shape rules allow, else in float64, where every partial sum below
    2^53 is exact."""
    m, k = x8.shape
    if x8.is_cuda and m > 16 and k % 8 == 0 and w8.shape[1] % 8 == 0:
        return torch._int_mm(x8, w8).float()
    return (x8.double() @ w8.double()).float()


def gelu_as(x: torch.Tensor) -> torch.Tensor:
    """fp32 GELU with the Abramowitz-Stegun 7.1.26 erf, op for op as the
    reference's ``fused_quant._gelu_erf`` (its default form)."""
    a1, a2, a3, a4, a5 = 0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429
    z = x * 0.7071067811865476
    ax = z.abs()
    t = _div(1.0, 1.0 + 0.3275911 * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    erf = torch.sign(z) * (1.0 - poly * torch.exp(-ax * ax))
    return x * 0.5 * (1.0 + erf)


def w4a8_matmul_plain(
    x8: torch.Tensor, q4: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
    wscale: torch.Tensor, xscale: torch.Tensor, bias: Optional[torch.Tensor],
    mode: str = "plain", out_dtype: torch.dtype = torch.bfloat16,
    norm_w: Optional[torch.Tensor] = None, cos: Optional[torch.Tensor] = None,
    sin: Optional[torch.Tensor] = None, eps: float = 1e-6,
):
    """Plain torch ``w4a8_matmul``: the same math with the int32 product
    computed exactly and the fp32 epilogue in the kernel's order."""
    m, k = x8.shape
    n = q4.shape[1]
    s8, z8 = scaled_affine(scales, zeros, wscale)
    w8 = requant_w8_plain(q4, s8, z8)
    ws = wscale.float()
    b = bias.float() if bias is not None else torch.zeros(n, device=x8.device)
    if mode == "grouped_xs":
        acc = torch.zeros((m, n), dtype=torch.float32, device=x8.device)
        for kg in range(k // SCALE_TILE):
            ks = slice(kg * SCALE_TILE, (kg + 1) * SCALE_TILE)
            acc = acc + _int_dot(x8[:, ks].contiguous(), w8[ks]) * xscale[:, kg : kg + 1].float()
        return (acc * ws + b).to(out_dtype)
    y = _int_dot(x8, w8) * xscale.reshape(m, 1).float() * ws + b
    if mode == "plain":
        return y.to(out_dtype)
    if mode == "gelu_quant":
        g = gelu_as(y).reshape(m, n // SCALE_TILE, SCALE_TILE)
        amax = g.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
        y8 = torch.round(g * _div(127.0, amax)).clamp_(-127, 127).to(torch.int8)
        return y8.reshape(m, n), (amax / torch.full_like(amax, 127.0)).reshape(m, -1)
    if mode == "norm_rope":
        y = y.reshape(m, n // HEAD_DIM, HEAD_DIM)
        ms = (y * y).mean(dim=-1, keepdim=True)
        yn = y * torch.rsqrt(ms + eps) * norm_w.float()
        rows = torch.arange(m, device=x8.device) % cos.shape[0]
        c, s = cos[rows][:, None, :], sin[rows][:, None, :]
        x1, x2 = yn[..., : HEAD_DIM // 2], yn[..., HEAD_DIM // 2 :]
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
        return out.reshape(m, n).to(out_dtype)
    raise ValueError(f"w4a8_matmul: unknown mode {mode!r}")


def _contiguous_on(name: str, t: torch.Tensor, device, dtype, shape,
                   fn: str = "w4a8_matmul") -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} must be {dtype} {tuple(shape)} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} must be contiguous and 16-byte aligned")


def w4a8_matmul(
    x8: torch.Tensor, q4: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
    wscale: torch.Tensor, xscale: torch.Tensor, bias: Optional[torch.Tensor],
    mode: str = "plain", out_dtype: torch.dtype = torch.bfloat16,
    norm_w: Optional[torch.Tensor] = None, cos: Optional[torch.Tensor] = None,
    sin: Optional[torch.Tensor] = None, eps: float = 1e-6, _route: Optional[str] = None,
):
    """``(x8 @ requant(q4)) * xscale * wscale + bias`` with ``mode``'s
    epilogue (module docstring), on ``w4a8_route``'s dataflow (``_route``
    overrides it: ``"sm90"`` holds kernel E's Hopper loop at a plain shape
    in the tests and tools). x8 int8 (M, K); q4 int32 (K/8, N); scales,
    zeros fp32 (K/g, N); wscale fp32 (N,); xscale fp32 (M, 1), or (M, K/512)
    for grouped_xs; bias (N,) or None. norm_rope takes norm_w (128,) and the
    (S, 64) fp32 cos/sin tables, row m using table row m mod S. Returns y
    (M, N) in ``out_dtype``, or for gelu_quant ``(y8 (M, N) int8, yscale
    (M, N/512) fp32)``.

    On CUDA: K a multiple of 128, group 32, 64 or a multiple of 128, N a multiple
    of the mode's column tile (128; 512 for gelu_quant), K a multiple of 512
    for grouped_xs; norm_w bf16; the bias bf16 or fp32 and the output bf16
    or fp32, norm_rope's both bf16 (an fp32-upcast block's linears have
    both in fp32, its `ada` an fp32 bias and a bf16 output), except that
    mode plain's "mat" route (#11) takes its bias in the output dtype.
    """
    if mode not in MODES:
        raise ValueError(f"w4a8_matmul: unknown mode {mode!r}")
    if x8.device.type == "cpu":
        return w4a8_matmul_plain(x8, q4, scales, zeros, wscale, xscale, bias, mode, out_dtype,
                                 norm_w, cos, sin, eps)
    if x8.device.type != "cuda":
        raise ValueError(f"w4a8_matmul: unsupported device {x8.device}")
    if x8.dtype != torch.int8 or x8.ndim != 2 or q4.ndim != 2:
        raise TypeError(f"w4a8_matmul: x8 must be int8 (M, K) and q4 (K/8, N), got {x8.dtype} "
                        f"{tuple(x8.shape)}, {tuple(q4.shape)}")
    m, k = x8.shape
    k8, n = q4.shape
    groups = scales.shape[0]
    route = _route or w4a8_route(m, mode)
    symbol = w4a8_kernel(m, k, k8, n, groups, mode, route)
    if out_dtype not in _W8_OUT_TYPES or (mode == "norm_rope" and out_dtype != torch.bfloat16):
        raise TypeError(f"w4a8_matmul: the card's output is bf16 or fp32 (norm_rope: bf16), "
                        f"got {out_dtype}")
    dev = x8.device
    if q4.dtype != torch.int32:
        raise TypeError("w4a8_matmul: q4 must be int32 words")
    _contiguous_on("q4", q4, dev, torch.int32, (k8, n))
    _contiguous_on("scales", scales, dev, torch.float32, (groups, n))
    _contiguous_on("zeros", zeros, dev, torch.float32, (groups, n))
    _contiguous_on("wscale", wscale, dev, torch.float32, (n,))
    xs_cols = k // SCALE_TILE if mode == "grouped_xs" else 1
    if xscale.device != dev or xscale.dtype != torch.float32 or xscale.numel() != m * xs_cols \
            or not xscale.is_contiguous():
        raise ValueError(f"w4a8_matmul: xscale must be contiguous fp32 ({m}, {xs_cols}) on {dev}")
    if bias is not None:
        if bias.dtype not in _W8_OUT_TYPES or (route == "mat" and bias.dtype != out_dtype) or (
                mode == "norm_rope" and bias.dtype != torch.bfloat16):
            raise TypeError(f"w4a8_matmul: bias {bias.dtype}: bf16 or fp32 (norm_rope: bf16), "
                            f"and on the 'mat' route (#11) the output dtype {out_dtype}")
        _contiguous_on("bias", bias, dev, bias.dtype, (n,))
    if not x8.is_contiguous() or x8.data_ptr() % 16:
        raise ValueError("w4a8_matmul: x8 must be contiguous and 16-byte aligned")
    s_rows = 0
    if mode == "norm_rope":
        _contiguous_on("norm_w", norm_w, dev, torch.bfloat16, (HEAD_DIM,))
        s_rows = cos.shape[0]
        for name, t in (("cos", cos), ("sin", sin)):
            if t.shape != (s_rows, HEAD_DIM // 2) or t.dtype != torch.float32 or t.device != dev \
                    or not t.is_contiguous():
                raise ValueError(f"w4a8_matmul: {name} must be contiguous fp32 "
                                 f"(S, {HEAD_DIM // 2}) on {dev}")
    if route == "mat":
        return _mat(x8, q4, scales, zeros, wscale, xscale, bias, k // groups, out_dtype)
    if mode == "gelu_quant":
        y = torch.empty((m, n), dtype=torch.int8, device=dev)
        yscale = torch.empty((m, n // SCALE_TILE), dtype=torch.float32, device=dev)
    else:
        y = torch.empty((m, n), dtype=out_dtype, device=dev)
        yscale = None
    if m:
        ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
        group = k // groups
        bias_f32 = int(bias is not None and bias.dtype == torch.float32)
        out_f32 = int(y.dtype == torch.float32)
        fn = getattr(kernels.library(), symbol)
        if route == "gemv":  # S blocks along K and their int32 partial sums
            splits = gemv_splits(k, n, group)
            partials = torch.empty(splits * m * n, dtype=torch.int32, device=dev)
            err = fn(
                x8.data_ptr(), q4.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
                wscale.data_ptr(), xscale.data_ptr(), ptr(bias), bias_f32, y.data_ptr(), out_f32,
                m, n, k, group, k, splits, partials.data_ptr(), kernels.stream_ptr(dev),
            )
        else:
            err = fn(
                x8.data_ptr(), q4.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
                wscale.data_ptr(), xscale.data_ptr(), ptr(bias), bias_f32, ptr(norm_w), ptr(cos),
                ptr(sin), s_rows, y.data_ptr(), out_f32, ptr(yscale), MODES[mode], m, n, k, group,
                k, float(eps), kernels.stream_ptr(dev),
            )
        kernels.check(err, f"w4a8_matmul ({mode})")
        w4a8_matmul.launches += 1
        w4a8_matmul.mode_launches[mode] += 1
        w4a8_matmul.gemv_launches += route == "gemv"
        w4a8_matmul.f32_launches += bool(bias_f32 or out_f32)
    return (y, yscale) if mode == "gelu_quant" else y


w4a8_matmul.launches = 0  # kernel E's
w4a8_matmul.mode_launches = dict.fromkeys(MODES, 0)
w4a8_matmul.gemv_launches = 0  # of mode plain's, the M <= 16 GEMV's
w4a8_matmul.f32_launches = 0  # of kernel E's, those with an fp32 bias or output
w4a8_matmul.mat_launches = 0  # mode plain's calls run as #10 then #11 (not E's)


def w8_matmul_plain(
    x8: torch.Tensor, w8: torch.Tensor, wscale: torch.Tensor, xscale: torch.Tensor,
    bias: Optional[torch.Tensor], out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain torch ``w8_matmul``: the exact int32 product ``x8 @ w8^T``
    (``_int_dot``: ``torch._int_mm`` where its shape rules allow, else in
    float64), then ``w8_epilogue``."""
    return w8_epilogue(_int_dot(x8, w8.t()), xscale, wscale, bias, out_dtype)


def w8_epilogue(acc: torch.Tensor, xscale: torch.Tensor, wscale: torch.Tensor,
                bias: Optional[torch.Tensor], out_dtype: torch.dtype) -> torch.Tensor:
    """The int8 products' epilogue, in the reference's order: ``(acc *
    xscale) * wscale + bias``, each step rounded in fp32, one rounding to
    ``out_dtype``. ``acc`` (M, N) is the exact int32 product, as int32 or
    as its fp32 rounding (the same value); xscale (M, 1)."""
    y = acc.float() * xscale.reshape(-1, 1).float() * wscale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


_W8_KERNELS = {torch.bfloat16: "dk_w8_matmul_bf16", torch.float32: "dk_w8_matmul_f32"}
# Kernel #11's M <= 16 GEMV (csrc/gemv_sm90.cu w8_gemv): K in splits of
# whole 256-k parts (four warps' parts of 64-k chunks), N in 64-column
# tiles; a block keeps its int8 slab of x, M x (K / S + 64) bytes, in
# shared memory beside its partials and the epilogue's operands.
W8_GEMV_PART_K, W8_GEMV_N_TILE = 256, 64
# The most of K a block streams before K is split: at 2048 the split (the
# cluster's sum of its blocks' partials, ~2 us) and one block a tile took
# the same time on the H100 at (2, 2048, 1536) (PERF.md, section 6).
W8_GEMV_BLOCK_K = 2048
_W8_GEMV_SMEM = 227 * 1024
_W8_X_TYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
_W8_OUT_TYPES = {torch.bfloat16: 0, torch.float32: 1}


def w8_route(m: int, k: int, n: int) -> str:
    """Kernel #11's main loop for (M, K, N): ``"gemv"``, the GEMV
    (csrc/gemv_sm90.cu), at M <= ``SMALL_M`` with K a multiple of 256 and N
    of 64 (the `ada` and embedder projections) where a block's slab of x
    fits in its shared memory; above ``SMALL_M`` csrc/w8_matmul_sm90.cu,
    ``"sm90"`` (``w8_mm_sm90``) with K a multiple of 128, ``"sm90_k64"``
    (``w8_mm_sm90_k64``, 64-deep k stages: the SD3 x_embedder's K = 64)
    otherwise; else ``"tile"`` (csrc/w8_matmul.cu ``w8_mm``). ValueError
    for what none of them takes: K not a multiple of 64 or N not of 8."""
    if k <= 0 or k % 64 or n <= 0 or n % 8:
        raise ValueError(f"w8_matmul: K={k} must be a multiple of 64 and N={n} of 8")
    if (m <= SMALL_M and k % W8_GEMV_PART_K == 0 and n % W8_GEMV_N_TILE == 0
            and 16 * m * W8_GEMV_N_TILE + 16 * 8 * 4 + (2 * W8_GEMV_N_TILE + 16) * 4
            + m * (k // w8_gemv_splits(k) + 64) <= _W8_GEMV_SMEM):
        return "gemv"
    if m <= SMALL_M:
        return "tile"
    return "sm90" if k % K_TILE == 0 else "sm90_k64"


def w8_quantizes_in_gemv(m: int, k: int, n: int) -> bool:
    """True where a float x (M, K) against an (N, K) w8 takes the GEMV's
    quantizing entry (``quantize_w8_matmul``) in place of kernel D then
    #11: the GEMV's route, at 1 <= M."""
    return m >= 1 and k > 0 and k % 64 == 0 and n > 0 and n % 8 == 0 and (
        w8_route(m, k, n) == "gemv")


def w8_gemv_splits(k: int) -> int:
    """S, the blocks that split K for #11's GEMV (a thread-block cluster a
    column tile, at most 8): the fewest, each a whole number of 256-k
    parts, that leave a block at most ``W8_GEMV_BLOCK_K`` of K; one where
    no split does."""
    for s in range(1, 9):
        if k % (s * W8_GEMV_PART_K) == 0 and k // s <= W8_GEMV_BLOCK_K:
            return s
    return 1


def w8_matmul(
    x8: torch.Tensor, w8: torch.Tensor, wscale: torch.Tensor, xscale: torch.Tensor,
    bias: Optional[torch.Tensor], out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """``((x8 @ w8^T) * xscale) * wscale + bias`` -> (M, N) in ``out_dtype``.

    x8 int8 (M, K); w8 int8 (N, K); wscale fp32 (N,); xscale fp32 (M, 1);
    bias (N,) or None. On CUDA: everything contiguous and 16-byte aligned,
    K a multiple of 64, N of 8, the output bf16 or fp32 and the bias in the
    output dtype; the main loop ``w8_route`` picks (the GEMV's launches also
    counted in ``w8_matmul.gemv_launches``).
    """
    if x8.device.type == "cpu":
        return w8_matmul_plain(x8, w8, wscale, xscale, bias, out_dtype)
    if x8.device.type != "cuda":
        raise ValueError(f"w8_matmul: unsupported device {x8.device}")
    if x8.dtype != torch.int8 or x8.ndim != 2 or w8.ndim != 2:
        raise TypeError(f"w8_matmul: x8 must be int8 (M, K) and w8 (N, K), got {x8.dtype} "
                        f"{tuple(x8.shape)}, {tuple(w8.shape)}")
    if out_dtype not in _W8_KERNELS:
        raise TypeError(f"w8_matmul: output {out_dtype} not supported (bf16, fp32)")
    m, k = x8.shape
    n = w8.shape[0]
    route = w8_route(m, k, n)
    dev = x8.device
    _contiguous_on("x8", x8, dev, torch.int8, (m, k), "w8_matmul")
    _contiguous_on("w8", w8, dev, torch.int8, (n, k), "w8_matmul")
    _contiguous_on("wscale", wscale, dev, torch.float32, (n,), "w8_matmul")
    if xscale.device != dev or xscale.dtype != torch.float32 or xscale.numel() != m \
            or not xscale.is_contiguous():
        raise ValueError(f"w8_matmul: xscale must be contiguous fp32 ({m}, 1) on {dev}")
    if bias is not None:
        _contiguous_on("bias", bias, dev, out_dtype, (n,), "w8_matmul")
    y = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m:
        _w8_launch(x8, w8, wscale, xscale, bias, y, route == "gemv")
    return y


def _w8_launch(x8: torch.Tensor, w8: torch.Tensor, wscale: torch.Tensor, xscale: torch.Tensor,
               bias: Optional[torch.Tensor], y: torch.Tensor, gemv: bool) -> None:
    """#11 into ``y`` on checked operands: the GEMV or the output dtype's
    C entry (its main loop picked there as ``w8_route``'s), counted."""
    (m, k), n = x8.shape, w8.shape[0]
    bias_ptr = 0 if bias is None else bias.data_ptr()
    if gemv:
        err = _w8_gemv(x8, w8, wscale, xscale.data_ptr(), bias_ptr, y)
    else:
        err = getattr(kernels.library(), _W8_KERNELS[y.dtype])(
            x8.data_ptr(), w8.data_ptr(), wscale.data_ptr(), xscale.data_ptr(), bias_ptr,
            y.data_ptr(), m, n, k, kernels.stream_ptr(x8.device),
        )
    kernels.check(err, "w8_matmul")
    w8_matmul.launches += 1
    w8_matmul.gemv_launches += gemv
    w8_matmul.f32_launches += y.dtype == torch.float32


def _mat(x8: torch.Tensor, q4: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
         wscale: torch.Tensor, xscale: torch.Tensor, bias: Optional[torch.Tensor],
         group: int, out_dtype: torch.dtype) -> torch.Tensor:
    """Mode plain as #10 then #11 on operands ``w4a8_matmul`` has checked:
    the layer's (N, K) int8 grid, transient, from its scales, zeros and
    wscale (#10's C entry puts the affine on the grid itself), then #11 on
    it (above 16 rows, never its GEMV), out in ``out_dtype``; counted in
    ``w4a8_matmul.mat_launches`` besides #10's and #11's own counts. It
    skips the two wrappers' checks, which ``w4a8_matmul``'s cover."""
    y = torch.empty((x8.shape[0], q4.shape[1]), dtype=out_dtype, device=x8.device)
    w8 = _dequant_launch(q4, scales, zeros, wscale.data_ptr(), group)
    _w8_launch(x8, w8, wscale, xscale, bias, y, gemv=False)
    w4a8_matmul.mat_launches += 1
    return y


w8_matmul.launches = 0
w8_matmul.gemv_launches = 0  # of them, the M <= 16 GEMV's (either entry)
w8_matmul.f32_launches = 0  # of them, with an fp32 output
w8_matmul.quantizing_launches = 0  # of those, the quantizing entry's


def _w8_gemv(x: torch.Tensor, w8: torch.Tensor, wscale: torch.Tensor, xscale_ptr: int,
             bias_ptr: int, y: torch.Tensor) -> int:
    """Launch the GEMV of #11 (csrc/gemv_sm90.cu ``dk_w8_gemv``) on x
    (M, K) int8, or bf16 / fp32 to quantize in it, with ``w8_gemv_splits``
    blocks along K (one thread-block cluster a column tile, which sums its
    blocks' partials in their shared memory); its CUDA error."""
    (m, k), n = x.shape, w8.shape[0]
    return kernels.library().dk_w8_gemv(
        x.data_ptr(), _W8_X_TYPES[x.dtype], w8.data_ptr(), wscale.data_ptr(), xscale_ptr,
        bias_ptr, y.data_ptr(), _W8_OUT_TYPES[y.dtype], m, n, k, w8_gemv_splits(k),
        kernels.stream_ptr(x.device),
    )


def quantize_w8_matmul_plain(
    x: torch.Tensor, w8: torch.Tensor, wscale: torch.Tensor, bias: Optional[torch.Tensor],
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain torch ``quantize_w8_matmul``: kernel D's plain version
    (``fused_quant.quantize_plain``), then ``w8_matmul_plain``."""
    from .fused_quant import quantize_plain

    aq = quantize_plain(x)
    return w8_matmul_plain(aq.x8, w8, wscale, aq.xscale, bias, out_dtype)


def quantize_w8_matmul(
    x: torch.Tensor, w8: torch.Tensor, wscale: torch.Tensor, bias: Optional[torch.Tensor],
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """#11 on a float x (M, K): x quantized per row as kernel D quantizes
    it, then ``((x8 @ w8^T) * xscale) * wscale + bias`` -> (M, N) in
    ``out_dtype``, in one launch of the M <= 16 GEMV's quantizing entry:
    bit for bit ``quantize`` then ``w8_matmul``. Counted as a launch of
    ``w8_matmul`` and of its GEMV.

    On CUDA: x bf16 or fp32, contiguous and 16-byte aligned, at an (M, K, N)
    where ``w8_quantizes_in_gemv`` holds; w8, wscale and bias as
    ``w8_matmul`` takes them.
    """
    if x.device.type == "cpu":
        return quantize_w8_matmul_plain(x, w8, wscale, bias, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_w8_matmul: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or x.ndim != 2 or w8.ndim != 2:
        raise TypeError(f"quantize_w8_matmul: x must be bf16 or fp32 (M, K) and w8 (N, K), got "
                        f"{x.dtype} {tuple(x.shape)}, {tuple(w8.shape)}")
    if out_dtype not in _W8_OUT_TYPES:
        raise TypeError(f"quantize_w8_matmul: output {out_dtype} not supported (bf16, fp32)")
    m, k = x.shape
    n = w8.shape[0]
    if not w8_quantizes_in_gemv(m, k, n):
        raise ValueError(f"quantize_w8_matmul: (M, K, N) = {(m, k, n)} needs 1 <= M <= "
                         f"{SMALL_M}, K a multiple of 256 and N of 64")
    dev = x.device
    _contiguous_on("x", x, dev, x.dtype, (m, k), "quantize_w8_matmul")
    _contiguous_on("w8", w8, dev, torch.int8, (n, k), "quantize_w8_matmul")
    _contiguous_on("wscale", wscale, dev, torch.float32, (n,), "quantize_w8_matmul")
    if bias is not None:
        _contiguous_on("bias", bias, dev, out_dtype, (n,), "quantize_w8_matmul")
    y = torch.empty((m, n), dtype=out_dtype, device=dev)
    err = _w8_gemv(x, w8, wscale, 0, 0 if bias is None else bias.data_ptr(), y)
    kernels.check(err, "quantize_w8_matmul")
    w8_matmul.launches += 1
    w8_matmul.gemv_launches += 1
    w8_matmul.f32_launches += y.dtype == torch.float32
    w8_matmul.quantizing_launches += 1
    return y


def dequant_w8_plain(q4: torch.Tensor, s8: torch.Tensor, z8: torch.Tensor) -> torch.Tensor:
    """Plain torch ``dequant_w8``: the (K, N) grid of ``requant_w8_plain``,
    transposed to (N, K)."""
    return requant_w8_plain(q4, s8, z8).t().contiguous()


def dequant_w8(q4: torch.Tensor, s8: torch.Tensor, z8: torch.Tensor) -> torch.Tensor:
    """#10: packed int4 words q4 (K/8, N) (int32 bit views) and the group
    affine on the int8 grid, s8 and z8 fp32 (K/g, N) (``scaled_affine``),
    -> the int8 weight grid ``clip(round_half_even(q * s8 + z8), -127, 127)``
    as (N, K), kernel E's in-tile grid bit for bit. (Mode plain's "mat"
    route launches the kernel on the layer's scales, zeros and wscale:
    ``_mat``.)

    On CUDA: every tensor contiguous and 16-byte aligned, K a multiple of 8,
    N of 8, a group g that divides K.
    """
    if q4.device.type == "cpu":
        return dequant_w8_plain(q4, s8, z8)
    if q4.device.type != "cuda":
        raise ValueError(f"dequant_w8: unsupported device {q4.device}")
    if q4.dtype != torch.int32 or q4.ndim != 2 or s8.ndim != 2:
        raise TypeError(f"dequant_w8: q4 must be int32 words (K/8, N) and s8 (K/g, N), got "
                        f"{q4.dtype} {tuple(q4.shape)}, {tuple(s8.shape)}")
    k8, n = q4.shape
    k, groups = 8 * k8, s8.shape[0]
    if n % 8 or groups == 0 or k % groups:
        raise ValueError(f"dequant_w8: N={n} must be a multiple of 8 and the {groups} groups "
                         f"must divide K={k}")
    dev = q4.device
    _contiguous_on("q4", q4, dev, torch.int32, (k8, n), "dequant_w8")
    _contiguous_on("s8", s8, dev, torch.float32, (groups, n), "dequant_w8")
    _contiguous_on("z8", z8, dev, torch.float32, (groups, n), "dequant_w8")
    if not k8:
        return torch.empty((n, 0), dtype=torch.int8, device=dev)
    return _dequant_launch(q4, s8, z8, 0, k // groups)


def _dequant_launch(q4: torch.Tensor, a: torch.Tensor, b: torch.Tensor, wscale_ptr: int,
                    group: int) -> torch.Tensor:
    """#10's kernel on checked operands, counted: the (N, K) int8 grid of
    q4 with the affine (a, b) = (s8, z8), or with a wscale pointer the
    layer's (scales, zeros), divided by wscale on the card as
    ``scaled_affine`` divides them."""
    k8, n = q4.shape
    w8 = torch.empty((n, 8 * k8), dtype=torch.int8, device=q4.device)
    err = kernels.library().dk_dequant_w8(q4.data_ptr(), a.data_ptr(), b.data_ptr(), wscale_ptr,
                                          w8.data_ptr(), 8 * k8, n, group,
                                          kernels.stream_ptr(q4.device))
    kernels.check(err, "dequant_w8")
    dequant_w8.launches += 1
    return w8


dequant_w8.launches = 0


def w4a8_w8(q4: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor,
            wscale: torch.Tensor) -> torch.Tensor:
    """A w4a8 layer's (N, K) int8 weight grid, kernel E's in-tile grid bit
    for bit: #10 on the layer's scales, zeros and wscale on the card (as
    mode plain's "mat" route launches it), ``dequant_w8_plain`` of
    ``scaled_affine`` on the CPU. A row-parallel w4a8 linear, and a split
    one at a local shape E does not take, runs #16 on it
    (``ops/common.linear``). On CUDA: K a multiple of 8, N of 8, the
    groups dividing K (#10's rules, ``dequant_w8``)."""
    if q4.device.type == "cpu":
        return dequant_w8_plain(q4, *scaled_affine(scales, zeros, wscale))
    k8, n = q4.shape
    groups = scales.shape[0]
    if n % 8 or groups == 0 or (8 * k8) % groups:
        raise ValueError(f"w4a8_w8: N={n} must be a multiple of 8 and the {groups} groups "
                         f"must divide K={8 * k8}")
    dev = q4.device
    _contiguous_on("q4", q4, dev, torch.int32, (k8, n))
    _contiguous_on("scales", scales, dev, torch.float32, (groups, n))
    _contiguous_on("zeros", zeros, dev, torch.float32, (groups, n))
    _contiguous_on("wscale", wscale, dev, torch.float32, (n,))
    return _dequant_launch(q4, scales, zeros, wscale.data_ptr(), 8 * k8 // groups)


def int8_dot_plain(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Plain torch ``int8_dot``: the exact int32 product ``x8 @ w8^T``, in
    int64 on the CPU, in float64 on the card (which has no integer matmul
    but ``torch._int_mm``), where every partial sum below 2^53 is exact."""
    if x8.device.type == "cpu":
        return (x8.long() @ w8.long().t()).int()
    return (x8.double() @ w8.double().t()).int()


def int8_dot(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """#16: x8 int8 (M, K) @ w8 int8 (N, K)^T -> int32 (M, N), exact.

    On CUDA: both contiguous and 16-byte aligned, K a multiple of 64, N of
    8, any M (ragged M by predication, no padded copy).
    """
    if x8.device.type == "cpu":
        return int8_dot_plain(x8, w8)
    if x8.device.type != "cuda":
        raise ValueError(f"int8_dot: unsupported device {x8.device}")
    if x8.dtype != torch.int8 or x8.ndim != 2 or w8.ndim != 2:
        raise TypeError(f"int8_dot: x8 must be int8 (M, K) and w8 (N, K), got {x8.dtype} "
                        f"{tuple(x8.shape)}, {tuple(w8.shape)}")
    m, k = x8.shape
    n = w8.shape[0]
    if k % 64 or n % 8:
        raise ValueError(f"int8_dot: K={k} must be a multiple of 64 and N={n} of 8")
    dev = x8.device
    _contiguous_on("x8", x8, dev, torch.int8, (m, k), "int8_dot")
    _contiguous_on("w8", w8, dev, torch.int8, (n, k), "int8_dot")
    y = torch.empty((m, n), dtype=torch.int32, device=dev)
    if m:
        err = kernels.library().dk_int8_dot(x8.data_ptr(), w8.data_ptr(), y.data_ptr(), m, n, k,
                                            kernels.stream_ptr(dev))
        kernels.check(err, "int8_dot")
        int8_dot.launches += 1
    return y


int8_dot.launches = 0


def _act(x) -> ActQuant:
    """x as an ``ActQuant``: passed through, or quantized per row by
    ``fused_quant.quantize`` (kernel D on the card)."""
    if isinstance(x, ActQuant):
        return x
    from .w8a8 import quantize_float

    return quantize_float(x)


def w4a8_linear(layer, x, act: Optional[str] = None) -> torch.Tensor:
    """Apply a ``QuantizedLinear`` carrying ``wscale`` (mode plain): x
    (..., K) float, or an ``ActQuant`` used as it is -> (..., N) in x's
    dtype. ``act="gelu"`` applies the exact-erf GELU afterwards, in that
    dtype, as the reference does."""
    aq = _act(x)
    lead, k = aq.shape[:-1], aq.shape[-1]
    y = w4a8_matmul(aq.x8.reshape(-1, k), layer.q4, layer.scales, layer.zeros, layer.wscale,
                    aq.xscale.reshape(-1, 1), layer.bias, out_dtype=aq.dtype)
    y = y.reshape(*lead, y.shape[-1])
    return F.gelu(y) if act == "gelu" else y


def w4a8_qk_eligible(layer, head_dim: int) -> bool:
    """A q/k projection takes the fused QK-RMSNorm + RoPE epilogue when it
    is a w4a8 ``QuantizedLinear`` of a shape kernel E takes and the head is
    128 wide."""
    return _takes_w4a8(layer) and head_dim == HEAD_DIM


def _takes_w4a8(layer) -> bool:
    """A w4a8 ``QuantizedLinear`` of a shape kernel E takes
    (``int4_matmul.kernel_takes``)."""
    from .quantized import QuantizedLinear

    return isinstance(layer, QuantizedLinear) and layer.wscale is not None and kernel_takes(
        layer.in_features, layer.out_features, layer.scales.shape[0], wscale=True)


def w4a8_qk_linear(layer, x, norm_w: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """q/k projection with QK-RMSNorm and rotate-half RoPE in the epilogue
    (mode norm_rope): x (..., K) float or ``ActQuant``; cos/sin (S, 64) for
    the S rows of x's sequence. Returns (..., N) in x's dtype: numerically
    ``rms_norm_rope`` of the fp32 epilogue value, with one rounding."""
    aq = _act(x)
    lead, k = aq.shape[:-1], aq.shape[-1]
    y = w4a8_matmul(aq.x8.reshape(-1, k), layer.q4, layer.scales, layer.zeros, layer.wscale,
                    aq.xscale.reshape(-1, 1), layer.bias, mode="norm_rope", out_dtype=aq.dtype,
                    norm_w=norm_w, cos=cos, sin=sin, eps=eps)
    return y.reshape(*lead, y.shape[-1])


def w4a8_ffn_eligible(fc1, fc2) -> bool:
    """fc1 -> GELU -> fc2 runs as two fused w4a8 kernels with an int8
    hidden when both are w4a8 ``QuantizedLinear``s of shapes kernel E
    takes, fc1's N (fc2's K) is a multiple of the 512 scale tile, and fc2's
    group divides it."""
    if not (_takes_w4a8(fc1) and _takes_w4a8(fc2)):
        return False
    n1 = fc1.out_features
    return fc2.in_features == n1 and n1 % SCALE_TILE == 0 and SCALE_TILE % fc2.group_size == 0


def w4a8_ffn_gelu(fc1, fc2, x, group=None) -> torch.Tensor:
    """fc2(GELU(fc1(x))) with the hidden in int8 end to end: fc1 in mode
    gelu_quant (scales per (row, 512-column tile)), fc2 in mode grouped_xs
    on them. x (..., K) float or ``ActQuant``; returns (..., N2) in x's
    dtype. With a tensor-parallel ``group`` (fc1 column-, fc2
    row-parallel), fc2 writes its fp32 partial with no bias, the partials
    are summed over the group, then the bias is added and the sum rounded
    once."""
    from ..parallel.collectives import all_reduce_sum, group_size

    aq = _act(x)
    lead, k = aq.shape[:-1], aq.shape[-1]
    h8, hs = w4a8_matmul(aq.x8.reshape(-1, k), fc1.q4, fc1.scales, fc1.zeros, fc1.wscale,
                         aq.xscale.reshape(-1, 1), fc1.bias, mode="gelu_quant")
    if group_size(group) == 1:
        y = w4a8_matmul(h8, fc2.q4, fc2.scales, fc2.zeros, fc2.wscale, hs, fc2.bias,
                        mode="grouped_xs", out_dtype=aq.dtype)
    else:
        y = all_reduce_sum(w4a8_matmul(h8, fc2.q4, fc2.scales, fc2.zeros, fc2.wscale, hs, None,
                                       mode="grouped_xs", out_dtype=torch.float32), group)
        if fc2.bias is not None:
            y = y + fc2.bias.float()
        y = y.to(aq.dtype)
    return y.reshape(*lead, y.shape[-1])
