"""Normalisation primitives with float32 statistics (plain torch).

Counterpart of ``diffusionkit_tpu/ops/norms.py``, with the same rounding
points: statistics and normalisation in fp32, one rounding to the input dtype
after the normalisation, and the affine or modulation applied in the input
dtype afterwards. The fused, single-rounding AdaLN form is kernel A
(``ops/fused_quant.mod_ln``).
"""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Weightless LayerNorm over the last axis."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def layer_norm_affine(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm with learned scale/offset (CLIP encoder layers)."""
    return layer_norm(x, eps) * weight + bias


def modulated_layer_norm(
    x: torch.Tensor,
    shift: torch.Tensor,
    residual_scale: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """AdaLN modulation ``norm(x) * (1 + scale) + shift``.

    The normalised tensor is rounded to x's dtype BEFORE the modulation, as
    the reference's non-fused branch does. ``shift``/``residual_scale`` are
    (batch, 1, hidden) against x's (batch, seq, hidden).
    """
    return layer_norm(x, eps) * (1.0 + residual_scale) + shift


def group_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int,
    eps: float = 1e-6,
) -> torch.Tensor:
    """GroupNorm over an NCHW tensor with explicit fp32 statistics.

    Statistics per (batch, group) over (channels-in-group, H, W); the
    normalised value is scaled and shifted in fp32 and rounded once.
    """
    b, c, h, w = x.shape
    x32 = x.float().reshape(b, num_groups, -1)
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    x32 = ((x32 - mean) * torch.rsqrt(var + eps)).reshape(b, c, h, w)
    y = x32 * weight.float()[:, None, None] + bias.float()[:, None, None]
    return y.to(x.dtype)
