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

A "gathered" linear (a fan-in linear whose leaves the axis does not all
divide) is whole on every rank and gathers its input first.

``linear_route`` and ``ffn_route`` are the dispatch rules themselves:
``linear`` and ``ffn_gelu`` branch on them, and the plan's listing
(``parallel/sharding.routes``) reads them on each rank's local layers.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_gather, all_reduce_sum
from .fused_quant import gelu_quantize, quantize_two_pass
from .int4_matmul import (
    dequant_linear, dequantize_int4, dequantize_int8, int4_linear, int4_matmul, int8_linear,
    int8_matmul, kernel_takes,
)
from .quantized import QuantizedLinear
from .w4a8_matmul import (
    int8_dot, w4a8_ffn_eligible, w4a8_ffn_gelu, w4a8_linear, w4a8_w8, w8_epilogue,
)
from .w8a8 import ActQuant, W8A8Linear, needs_act_quant, w8a8_linear


def linear_route(layer: nn.Module) -> str:
    """Where ``linear`` sends ``layer`` as it lies on this rank (its local
    shape and ``tp`` role): "#11" (w8a8), "E" (w4a8), "C" / "#13" (int4 /
    int8 weight-only), "#16 int32" and "#10 + #16 int32" (w8a8 and w4a8
    row-parallel: the int32 product summed over the group),
    "dequant_linear" (a packed shape its kernels do not take,
    ``kernel_takes``), or "F.linear" (float)."""
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


def _row_linear(layer: nn.Module, x, group) -> torch.Tensor:
    """A row-parallel linear on this rank's features (module docstring)."""
    route = linear_route(layer)
    if route.endswith("#16 int32"):
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
    if route == "#4":
        h = linear(fc1, x)
        split = tp2 is not None and tp2.kind != "col"
        return linear(fc2, quantize_two_pass(h, tp2.group, "erf") if split else gelu_quantize(h))
    return linear(fc2, linear(fc1, x, act="gelu"))


def ffn_route(fc1: nn.Module, fc2: nn.Module) -> str:
    """Where ``ffn_gelu`` sends fc1 -> GELU -> fc2 as they lie on this rank:
    "fused" (``w4a8_ffn_gelu``), "#4" (fc1, kernel #4 or its two-pass form,
    fc2) or "float" (the GELU on fc1's float output); the 128 rule reads
    fc1's whole width."""
    tp1 = getattr(fc1, "tp", None)
    width = fc1.out_features * (tp1.n if tp1 is not None and tp1.kind == "col" else 1)
    if needs_act_quant(fc2) and width % 128 == 0:
        return "fused" if w4a8_ffn_eligible(fc1, fc2) else "#4"
    return "float"


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
