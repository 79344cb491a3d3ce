"""Shared building blocks on tensors: linear layers, MLPs, patchify.

Counterpart of ``diffusionkit_tpu/ops/common.py``. Float weights live in
``nn.Linear`` modules in torch's (out, in) layout and their GEMMs go to
``F.linear``, as the reference left them to XLA; int4 and int8 weights live
in ``ops/quantized.QuantizedLinear`` and go to kernels C and #13, or with a
w4a8 ``wscale`` to kernel E; w8a8 weights live in ``ops/w8a8.W8A8Linear``
and go to kernel #11.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .fused_quant import gelu_quantize
from .int4_matmul import dequant_linear, int4_linear, int8_linear, kernel_takes
from .quantized import QuantizedLinear
from .w4a8_matmul import w4a8_ffn_eligible, w4a8_ffn_gelu, w4a8_linear
from .w8a8 import ActQuant, W8A8Linear, needs_act_quant, w8a8_linear


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
    """
    if isinstance(layer, W8A8Linear):
        return w8a8_linear(layer, x, act)
    if isinstance(layer, QuantizedLinear) and not kernel_takes(
            x.shape[-1], layer.out_features, layer.scales.shape[0], layer.wscale is not None):
        return dequant_linear(layer, x.to_float() if isinstance(x, ActQuant) else x, act)
    if needs_act_quant(layer):
        return w4a8_linear(layer, x, act)
    if isinstance(x, ActQuant):
        x = x.to_float()
    if isinstance(layer, QuantizedLinear):
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
    kernel #4 between the two products."""
    if needs_act_quant(fc2) and fc1.out_features % 128 == 0:
        if w4a8_ffn_eligible(fc1, fc2):
            return w4a8_ffn_gelu(fc1, fc2, x)
        return linear(fc2, gelu_quantize(linear(fc1, x)))
    return linear(fc2, linear(fc1, x, act="gelu"))


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
