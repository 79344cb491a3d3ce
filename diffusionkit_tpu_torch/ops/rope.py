"""Multi-axis rotary position embeddings for FLUX, in rotate-half form.

Counterpart of ``diffusionkit_tpu/ops/rope.py``. The fp32 cos/sin tables
are built with numpy on the host, exactly as the reference builds them, and
the rotation acts on the two contiguous halves of each head:
``[cos*x1 - sin*x2 | sin*x1 + cos*x2]``. Scores are invariant under one
column permutation applied to both q and k, so a checkpoint's interleaved
(even, odd) pairs are moved into halves once at load time
(``rope_head_permutation``) and no interleaved view is ever formed.

Positions: text tokens first, all at (0, 0, 0), so their rotation is the
identity; then image tokens in row-major (y, x) order. Axis i of
``axes_dim`` (16, 56, 56 for FLUX, summing to the head dim 128) rotates its
own slice of the head.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def rope_frequencies(
    latent_image_resolution: Tuple[int, int],
    text_sequence_length: int,
    axes_dim: Sequence[int],
    theta: int = 10000,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) fp32 tables of shape (S, head_dim // 2), S = text + H*W.
    Pair j of axis i rotates by ``position_i * theta^(-2j / axes_dim[i])``."""
    h, w = latent_image_resolution
    img_pos = np.zeros((h, w, 3), dtype=np.float32)
    img_pos[..., 1] = np.arange(h, dtype=np.float32)[:, None]
    img_pos[..., 2] = np.arange(w, dtype=np.float32)[None, :]
    positions = np.concatenate(
        [np.zeros((text_sequence_length, 3), np.float32), img_pos.reshape(-1, 3)], axis=0
    )
    angles = []
    for i, dim in enumerate(axes_dim):
        scale = np.arange(0, dim, 2, dtype=np.float32) / dim
        omega = 1.0 / (float(theta) ** scale)
        angles.append(positions[:, i : i + 1] * omega[None, :])
    ang = np.concatenate(angles, axis=-1)
    return (torch.from_numpy(np.cos(ang)).to(device), torch.from_numpy(np.sin(ang)).to(device))


def rope_head_permutation(head_dim: int) -> np.ndarray:
    """Half-layout -> interleaved-source index map: position j holds the
    checkpoint's pair-j even element, position D/2 + j its odd partner."""
    return np.concatenate([np.arange(0, head_dim, 2), np.arange(1, head_dim, 2)])


def _rotate(x32: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x32.shape[-1] // 2
    x1, x2 = x32[..., :half], x32[..., half:]
    return torch.cat([cos * x1 - sin * x2, sin * x1 + cos * x2], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate q or k (..., S, H, head_dim) in the half layout, in fp32; one
    rounding back to x's dtype. cos/sin broadcast against x's halves."""
    return _rotate(x.float(), cos, sin).to(x.dtype)


def rms_norm_rope(
    x: torch.Tensor, weight: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """QK-RMSNorm then rotate-half RoPE, fp32 end to end with one rounding
    (the separate calls would round the normed tensor in between)."""
    x32 = x.float()
    ms = x32.square().mean(dim=-1, keepdim=True)
    xn = x32 * torch.rsqrt(ms + eps) * weight.float()
    return _rotate(xn, cos, sin).to(x.dtype)
