"""Shared building blocks on tensors: linear layers, MLPs, patchify.

Counterpart of ``diffusionkit_tpu/ops/common.py``. Float weights live in
``nn.Linear`` modules in torch's (out, in) layout and their GEMMs go to
``F.linear``, as the reference left them to XLA; int4 and int8 weights live
in ``ops/quantized.QuantizedLinear`` and go to kernels C and #13, or with a
w4a8 ``wscale`` to kernel E; w8a8 weights live in ``ops/w8a8.W8A8Linear``
and go to kernel #11.

Under tensor parallelism (``parallel/sharding.py``) a linear carries its
role in ``tp``. A column-parallel one runs as above on its local columns.
A row-parallel one holds K / n of the weight's input rows and takes this
rank's K / n of the input features; its partial products are summed over
the ``model`` group once, the bias added once after the sum, and the
result rounded once:

  w8a8, and w4a8 on its kernels   the input quantized by the two-pass D
                                  (the whole row's absmax), the exact
                                  int32 product by #16 (``int8_dot``; for
                                  w4a8 on #10's grid of the local rows),
                                  summed in int32, then #11's epilogue
                                  ``(acc * xscale) * wscale + bias``: the
                                  unsharded result bit for bit
  float                           each rank's product with an fp32
                                  output (a bf16 GEMM into fp32 on the
                                  card), summed in fp32, then the bias,
                                  one rounding
  int4, int8                      kernel C or #13 with an fp32 output
                                  (the products' fp32 sums, unrounded),
                                  summed in fp32, then the bias, one
                                  rounding
  w4a8 FFN (fc2 grouped_xs)       E's fp32 output with no bias, summed in
                                  fp32, then the bias, one rounding
  w4a8 at a local shape kernel E  as w4a8 on its kernels: #10's grid of
  does not take                   the local rows, #16, #11's epilogue

A split w4a8 FFN whose local hidden is not whole 512-column scale tiles
(SD3.5-large's 9728 over 2 and 4 ranks) keeps the fused pair's arithmetic
(``ffn_route`` "tiles"): fc1 on E in mode plain with an fp32 output, then
E's gelu_quant epilogue in two passes (``fused_quant.tile_absmax`` and
``tile_quantize``): each (row, tile)'s GELU absmax over this rank's part
of each tile that straddles a rank boundary, the max all-reduced over the
ranks for those tiles alone (one value a row and straddled tile:
``fused_quant.straddled_tiles``), the hidden quantized by it there and by
its own absmax in the tiles a rank holds whole; then fc2's fp32 sum
over the tiles in the unsharded order, as a chain over the ranks: a
tile's int32 product on #16 at the rank where it starts (the other ranks'
parts of it, the int8 hidden and weight columns, sent there), every
rank's products at once, then each scaled by its tile's scale and added
in turn, the running sum passed on from rank to rank, broadcast from the
last, then ``* wscale + bias``:
grouped_xs's result bit for bit, so the split FFN is the unsharded
gelu_quant then grouped_xs.

A column-parallel w4a8 linear at a local shape kernel E does not take
(SD3.5-large's widths over 2 and 4 ranks, ROADMAP.md) keeps E's arithmetic
the same way: its int8 activations (the input's ``ActQuant`` or D on the
whole rows), #10's grid, the exact int32 product on #16, #11's epilogue;
so the split model computes what the unsharded one does, as the
reference's split runs the whole-shape kernel. Unsplit, such a shape
takes ``dequant_linear`` (the reference's ``quantized_linear``).

A "gathered" linear (a fan-in linear whose leaves the axis does not all
divide) is whole on every rank and gathers its input first.

``linear_route`` and ``ffn_route`` are the dispatch rules themselves:
``linear`` and ``ffn_gelu`` branch on them, and the plan's listing
(``parallel/sharding.routes``) reads them on each rank's local layers.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_gather, all_reduce_max, all_reduce_sum, broadcast, recv, send
from .fused_quant import (
    gelu_quantize, quantize_two_pass, straddled_tiles, tile_absmax, tile_quantize,
)
from .int4_matmul import (
    dequant_linear, dequantize_int4, dequantize_int8, int4_linear, int4_matmul, int8_linear,
    int8_matmul, kernel_takes,
)
from .quantized import QuantizedLinear
from .w4a8_matmul import (
    SCALE_TILE, int8_dot, w4a8_ffn_eligible, w4a8_ffn_gelu, w4a8_linear, w4a8_matmul, w4a8_w8,
    w8_epilogue,
)
from .w8a8 import ActQuant, W8A8Linear, needs_act_quant, quantize_float, w8a8_linear


def linear_route(layer: nn.Module) -> str:
    """Where ``linear`` sends ``layer`` as it lies on this rank (its local
    shape and ``tp`` role): "#11" (w8a8), "E" (w4a8), "C" / "#13" (int4 /
    int8 weight-only), "#16 int32" and "#10 + #16 int32" (w8a8 and w4a8
    row-parallel: the int32 product summed over the group),
    "dequant_linear" (a packed shape its kernels do not take,
    ``kernel_takes``; a split w4a8 linear there keeps E's arithmetic on
    #10 and #16, module docstring), or "F.linear" (float)."""
    row = getattr(getattr(layer, "tp", None), "kind", None) == "row"
    if isinstance(layer, W8A8Linear):
        return "#16 int32" if row else "#11"
    if isinstance(layer, QuantizedLinear):
        w4a8 = layer.wscale is not None
        if not kernel_takes(layer.in_features, layer.out_features, layer.scales.shape[0], w4a8):
            return "dequant_linear"
        if w4a8:
            return "#10 + #16 int32" if row else "E"
        return "C" if layer.bits == 4 else "#13"
    return "F.linear"


def linear(layer: nn.Module, x, act: Optional[str] = None) -> torch.Tensor:
    """y = act(x @ W^T (+ b)), rounded to x's dtype BEFORE the activation.

    A ``W8A8Linear`` goes to ``w8a8_linear`` (kernel #11 on the card) and a
    ``QuantizedLinear`` with a w4a8 ``wscale`` to ``w4a8_linear`` (kernel
    E), both taking an ``ActQuant`` as it is; one without goes to
    ``int4_linear`` (kernel C), or at int8 ``int8_linear`` (#13), as the reference's
    ``linear`` hands quantized params to ``w8a8_linear`` and
    ``quantized_linear``. A packed linear of a shape its kernels do not
    take (``kernel_takes``, the rule their wrappers raise on: the MLX
    releases' N = 64 final layer) goes, w4a8 or not, to ``dequant_linear``,
    decided before any launch. Every other consumer of an ``ActQuant`` uses
    its ``to_float()``.

    The product runs in the promoted dtype of x and the weight (as the
    reference's ``jnp.dot`` does for a bf16 activation against fp32
    weights) and the result is cast back to x's dtype; with matching dtypes
    both casts are no-ops. ``act="gelu"`` is the exact erf GELU, applied to
    the rounded value.

    A row-parallel or gathered linear (its ``tp``; module docstring) takes
    this rank's slice of the input features.
    """
    tp = getattr(layer, "tp", None)
    if tp is not None and tp.kind == "gathered":
        return _whole_linear(layer, gather_features(x, tp.group), act)
    if tp is not None and tp.kind == "row":
        if act is not None:
            raise ValueError("a row-parallel linear takes no activation")
        return _row_linear(layer, x, tp.group)
    return _whole_linear(layer, x, act)


def gather_features(x, group):
    """A feature-split activation (a tensor or an ``ActQuant``, whose row
    scales are already the whole rows') gathered whole over ``group``."""
    if isinstance(x, ActQuant):
        orig = None if x.orig is None else all_gather(x.orig, -1, group)
        return ActQuant(all_gather(x.x8, -1, group), x.xscale, orig, x.out_dtype)
    return all_gather(x, -1, group)


def gather_output(layer: nn.Module, y: torch.Tensor) -> torch.Tensor:
    """A column-parallel linear's output gathered whole over its group (the
    modulation vectors); any other linear's as it is."""
    tp = getattr(layer, "tp", None)
    if tp is None or tp.kind != "col":
        return y
    return all_gather(y, -1, tp.group)


def _partial_fp32(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x2 @ w^T in fp32 with no rounding of the partial sums: a bf16 / fp16
    GEMM with an fp32 output on the card, the fp32 product elsewhere (the
    products of 16-bit values are exact in fp32)."""
    if x2.is_cuda and x2.dtype == w.dtype and x2.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(x2, w.t(), out_dtype=torch.float32)
    return F.linear(x2.float(), w.float())


def _split_w4a8_off_kernel(layer: nn.Module, route: str) -> bool:
    """A column- or row-parallel w4a8 linear at a local shape its kernels
    do not take (module docstring)."""
    return (route == "dequant_linear" and layer.wscale is not None
            and getattr(layer, "tp", None) is not None and layer.tp.kind in ("col", "row"))


def _w4a8_off_kernel(layer: nn.Module, x, act: Optional[str] = None) -> torch.Tensor:
    """A column-parallel w4a8 linear off E's shapes: E's arithmetic on #10's
    grid and #16, on x's int8 rows (module docstring)."""
    aq = x if isinstance(x, ActQuant) else quantize_float(x)
    lead, k = aq.shape[:-1], aq.shape[-1]
    acc = int8_dot(aq.x8.reshape(-1, k), w4a8_w8(layer.q4, layer.scales, layer.zeros,
                                                  layer.wscale))
    y = w8_epilogue(acc, aq.xscale.reshape(-1, 1), layer.wscale, layer.bias, aq.dtype)
    y = y.reshape(*lead, y.shape[-1])
    return F.gelu(y) if act == "gelu" else y


def _row_linear(layer: nn.Module, x, group) -> torch.Tensor:
    """A row-parallel linear on this rank's features (module docstring)."""
    route = linear_route(layer)
    if route.endswith("#16 int32") or _split_w4a8_off_kernel(layer, route):
        aq = x if isinstance(x, ActQuant) else quantize_two_pass(x, group)
        lead, k = aq.shape[:-1], aq.shape[-1]
        if isinstance(layer, W8A8Linear):
            w8 = layer.w8
            bias = None if layer.bias is None else layer.bias.to(aq.dtype)
        else:
            w8 = w4a8_w8(layer.q4, layer.scales, layer.zeros, layer.wscale)
            bias = layer.bias
        acc = all_reduce_sum(int8_dot(aq.x8.reshape(-1, k), w8), group)
        y = w8_epilogue(acc, aq.xscale.reshape(-1, 1), layer.wscale, bias, aq.dtype)
        return y.reshape(*lead, y.shape[-1])
    if isinstance(x, ActQuant):
        x = x.to_float()
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    if route in ("C", "#13"):
        matmul = int4_matmul if layer.bits == 4 else int8_matmul
        part = matmul(x2, layer.q4 if layer.bits == 4 else layer.q8, layer.scales, layer.zeros,
                      out_dtype=torch.float32)
    elif route == "dequant_linear":  # dequant_linear's product
        deq = dequantize_int4 if layer.bits == 4 else dequantize_int8
        w = deq(layer.q4 if layer.bits == 4 else layer.q8, layer.scales, layer.zeros, x.dtype)
        part = torch.matmul(x2.float(), w.float())
    else:
        ct = torch.promote_types(x.dtype, layer.weight.dtype)
        part = _partial_fp32(x2.to(ct), layer.weight.to(ct))
    y = all_reduce_sum(part.float().contiguous(), group)
    if layer.bias is not None:
        y = y + layer.bias.float()
    return y.to(x.dtype).reshape(*lead, y.shape[-1])


def _whole_linear(layer: nn.Module, x, act: Optional[str] = None) -> torch.Tensor:
    """``linear`` on a linear that holds its whole input rows."""
    route = linear_route(layer)
    if route == "#11":
        return w8a8_linear(layer, x, act)
    if route == "dequant_linear":
        if _split_w4a8_off_kernel(layer, route):
            return _w4a8_off_kernel(layer, x, act)
        return dequant_linear(layer, x.to_float() if isinstance(x, ActQuant) else x, act)
    if route == "E":
        return w4a8_linear(layer, x, act)
    if isinstance(x, ActQuant):
        x = x.to_float()
    if route in ("C", "#13"):
        return (int8_linear if layer.bits == 8 else int4_linear)(layer, x, act)
    w = layer.weight
    ct = torch.promote_types(x.dtype, w.dtype)
    b = layer.bias.to(ct) if layer.bias is not None else None
    y = F.linear(x.to(ct), w.to(ct), b).to(x.dtype)
    if act == "gelu":
        y = F.gelu(y)
    return y


class MLPSiLU(nn.Module):
    """Linear -> SiLU -> Linear (pooled-text and timestep adapters)."""

    def __init__(self, d_in: int, d_hidden: int, **kw):
        super().__init__()
        self.fc1 = nn.Linear(d_in, d_hidden, **kw)
        self.fc2 = nn.Linear(d_hidden, d_hidden, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.fc2, F.silu(linear(self.fc1, x)))


def ffn_gelu(fc1: nn.Module, fc2: nn.Module, x) -> torch.Tensor:
    """Transformer FFN with exact (erf) GELU; float, int4, int8, w4a8 or
    w8a8 layers.

    When fc2 quantizes its activations and fc1's width is a multiple of 128
    (the reference's ``fused_eligible``), the hidden never exists in float
    after the GELU: both legs w4a8 take ``w4a8_ffn_gelu`` (kernel E's
    gelu_quant then grouped_xs); any other such FFN (w8a8, or a w4a8 pair
    the fused chain does not take) runs ``fc2(gelu_quantize(fc1(x)))``,
    kernel #4 between the two products.

    Under tensor parallelism (fc1 column-, fc2 row-parallel) the rule reads
    fc1's whole width; the hidden is this rank's columns, quantized by #4's
    two-pass form (the whole row's absmax), and the w4a8 chain's fc2 sums
    its fp32 partials over the group before its bias."""
    route, tp2 = ffn_route(fc1, fc2), getattr(fc2, "tp", None)
    if route == "fused":
        return w4a8_ffn_gelu(fc1, fc2, x, None if tp2 is None else tp2.group)
    if route == "tiles":
        return _w4a8_ffn_tiles(fc1, fc2, x)
    if route == "#4":
        h = linear(fc1, x)
        split = tp2 is not None and tp2.kind != "col"
        return linear(fc2, quantize_two_pass(h, tp2.group, "erf") if split else gelu_quantize(h))
    return linear(fc2, linear(fc1, x, act="gelu"))


def ffn_route(fc1: nn.Module, fc2: nn.Module) -> str:
    """Where ``ffn_gelu`` sends fc1 -> GELU -> fc2 as they lie on this rank:
    "fused" (``w4a8_ffn_gelu``), "tiles" (a split w4a8 pair whose local
    hidden is not whole scale tiles: ``_w4a8_ffn_tiles``, module
    docstring), "#4" (fc1, kernel #4 or its two-pass form, fc2) or "float"
    (the GELU on fc1's float output); the 128 rule reads fc1's whole
    width."""
    tp1 = getattr(fc1, "tp", None)
    width = fc1.out_features * (tp1.n if tp1 is not None and tp1.kind == "col" else 1)
    if needs_act_quant(fc2) and width % 128 == 0:
        if w4a8_ffn_eligible(fc1, fc2):
            return "fused"
        if (tp1 is not None and tp1.kind == "col" and width % SCALE_TILE == 0
                and linear_route(fc1) == "E" and linear_route(fc2) == "#10 + #16 int32"
                and SCALE_TILE % fc2.group_size == 0 and fc1.out_features % 64 == 0):
            return "tiles"
        return "#4"
    return "float"


def _w4a8_ffn_tiles(fc1: nn.Module, fc2: nn.Module, x) -> torch.Tensor:
    """``ffn_gelu``'s "tiles" route (module docstring): fc1 column-, fc2
    row-parallel w4a8 over fc1's group, the hidden's scale tiles split
    between ranks."""
    tp = fc1.tp
    aq = x if isinstance(x, ActQuant) else quantize_float(x)
    lead, k = aq.shape[:-1], aq.shape[-1]
    x8 = aq.x8.reshape(-1, k)
    n1 = fc1.out_features
    bias1 = None if fc1.bias is None else fc1.bias.float()
    g = w4a8_matmul(x8, fc1.q4, fc1.scales, fc1.zeros, fc1.wscale, aq.xscale.reshape(-1, 1),
                    bias1, out_dtype=torch.float32)
    start = tp.index * n1
    amax = tile_absmax(g, start, tp.n * n1 // SCALE_TILE)
    idx = _straddled_index(tp.n * n1, tp.n, g.device)
    if idx is not None:  # only the tiles that straddle ranks need the others' maxima
        amax.index_copy_(1, idx, all_reduce_max(amax.index_select(1, idx), tp.group))
    h8, hs = tile_quantize(g, amax, start)
    w8 = w4a8_w8(fc2.q4, fc2.scales, fc2.zeros, fc2.wscale)
    y = _tile_chain(h8, w8, hs, start, tp) * fc2.wscale.float()
    if fc2.bias is not None:
        y = y + fc2.bias.float()
    return y.to(aq.dtype).reshape(*lead, y.shape[-1])


@functools.lru_cache(maxsize=None)
def _straddled_index(hidden: int, n: int, device: torch.device) -> Optional[torch.Tensor]:
    """``straddled_tiles`` of the layout as an index tensor on ``device``,
    made once a layout; None where no tile straddles."""
    shared = straddled_tiles(hidden, n)
    return torch.tensor(shared, device=device) if shared else None


def _tile_chain(h8: torch.Tensor, w8: torch.Tensor, hs: torch.Tensor, start: int,
                tp) -> torch.Tensor:
    """grouped_xs's fp32 sum over the scale tiles in their order, split
    over ``tp``'s ranks, each holding the hidden's columns (and fc2's rows)
    from ``start``: this rank's part of a tile that starts on an earlier
    rank goes there (the int8 columns of the hidden and of the weight);
    the tiles that start here take their int32 products on #16 (with the
    later ranks' parts), all ranks' at once; then the running sum comes
    from the previous rank, adds this rank's tiles in order and goes on to
    the next; the last rank's sum is broadcast to all."""
    n1 = h8.shape[1]
    owner = lambda t: (t * SCALE_TILE) // n1  # noqa: E731  the rank where tile t starts
    first, last = start // SCALE_TILE, (start + n1 - 1) // SCALE_TILE
    if owner(first) != tp.index:
        hi = min((first + 1) * SCALE_TILE, start + n1) - start
        send(h8[:, :hi], owner(first), tp.group)
        send(w8[:, :hi], owner(first), tp.group)
    m, n2 = h8.shape[0], w8.shape[0]
    parts = []
    for t in range(first, last + 1):
        if owner(t) != tp.index:
            continue
        lo, end = t * SCALE_TILE - start, (t + 1) * SCALE_TILE - start
        xs, ws = [h8[:, lo:min(end, n1)]], [w8[:, lo:min(end, n1)]]
        src = tp.index
        while end > (src + 1 - tp.index) * n1 and src + 1 < tp.n:  # the later ranks' parts
            src += 1
            k = min(end - (src - tp.index) * n1, n1)
            xs.append(recv((m, k), torch.int8, h8.device, src, tp.group))
            ws.append(recv((n2, k), torch.int8, h8.device, src, tp.group))
        parts.append((t, int8_dot(torch.cat(xs, dim=1).contiguous(),
                                  torch.cat(ws, dim=1).contiguous())))
    if tp.index:
        acc = recv((m, n2), torch.float32, h8.device, tp.index - 1, tp.group)
    else:
        acc = torch.zeros((m, n2), dtype=torch.float32, device=h8.device)
    for t, part in parts:
        acc = acc + part.float() * hs[:, t:t + 1]
    if tp.index + 1 < tp.n:
        send(acc, tp.index + 1, tp.group)
    return broadcast(acc, tp.n - 1, tp.group)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal frequency embedding in fp32: [cos | sin]."""
    half = dim // 2
    arange = torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(-math.log(max_period) * arange / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Space-to-depth: (B, H, W, C) -> (B, H/p * W/p, C*p*p), feature order
    (c, ph, pw) — the layout the SD3 patch conv folds into."""
    b, h, w, c = x.shape
    p = patch_size
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, (h // p) * (w // p), c * p * p)


def unpack_flux(x: torch.Tensor, latent_hw: Tuple[int, int], patch_size: int) -> torch.Tensor:
    """Inverse of FLUX packing: (B, S, c*p*p) -> (B, H, W, c), feature order
    (c, ph, pw)."""
    b, _, f = x.shape
    p = patch_size
    h, w = latent_hw[0] // p, latent_hw[1] // p
    c = f // (p * p)
    x = x.reshape(b, h, w, c, p, p).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * p, w * p, c)


def unpatchify_sd3(
    x: torch.Tensor, latent_hw: Tuple[int, int], patch_size: int, vae_latent_dim: int
) -> torch.Tensor:
    """SD3 unpatchify: (B, S, p*p*c) -> (B, H, W, c), feature order (ph, pw, c)."""
    b = x.shape[0]
    p = patch_size
    th, tw = latent_hw
    h, w = th // p, tw // p
    x = x.reshape(b, h, w, p, p, vae_latent_dim).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, th, tw, vae_latent_dim)
