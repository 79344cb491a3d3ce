"""Shared building blocks on tensors: linear layers, MLPs, patchify.

Counterpart of ``diffusionkit_tpu/ops/common.py``. Weights live in
``nn.Linear`` modules in torch's (out, in) layout; the GEMMs go to
``F.linear`` as the reference left them to XLA.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def linear(layer: nn.Linear, x: torch.Tensor, act: Optional[str] = None) -> torch.Tensor:
    """y = act(x @ W^T (+ b)), rounded to x's dtype BEFORE the activation.

    The product runs in the promoted dtype of x and the weight (as the
    reference's ``jnp.dot`` does for a bf16 activation against fp32
    weights) and the result is cast back to x's dtype; with matching dtypes
    both casts are no-ops. ``act="gelu"`` is the exact erf GELU, applied to
    the rounded value.
    """
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


def ffn_gelu(fc1: nn.Linear, fc2: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """Transformer FFN with exact (erf) GELU, float path."""
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
