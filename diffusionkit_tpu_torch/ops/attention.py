"""Scaled dot-product attention dispatch.

Counterpart of ``diffusionkit_tpu/ops/attention.py`` (single device): the
flash kernel (``ops/flash_attention.py``, kernel B) for long sequences on
the card, the materialised-score fp32-softmax ``xla_sdpa`` as the reference
path everywhere else. The ring and mesh branches wait for multi-GPU.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .flash_attention import SUPPORTED_HEAD_DIMS, flash_attention_bshd

# Sequence length above which the flash kernel is used.
FLASH_ATTN_THRESHOLD = 1024


def _check_layout(layout: str) -> None:
    if layout != "bshd":
        raise ValueError(f"only the bshd layout is ported, got {layout!r}")


def xla_sdpa(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    layout: str = "bshd",
) -> torch.Tensor:
    """Materialised-score SDPA over (B, S, H, D): fp32 scores and softmax, P
    rounded to v's dtype, fp32 P.V, one rounding to q's dtype."""
    _check_layout(layout)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    p = torch.softmax(s * scale, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    impl: Optional[str] = None,
    layout: str = "bshd",
) -> torch.Tensor:
    """Dispatching SDPA over (B, S, H, D).

    ``impl``: None/'auto', 'xla' or 'flash' (default from
    ``DIFFUSIONKIT_TPU_SDPA``). 'auto' takes the flash kernel for a CUDA
    tensor whose sequence exceeds FLASH_ATTN_THRESHOLD and whose head dim
    the kernel supports; 'flash' always takes it (on the CPU its plain
    version). The kernel raises on what it does not take (for now fp32).
    """
    _check_layout(layout)
    impl = impl or os.environ.get("DIFFUSIONKIT_TPU_SDPA", "auto")
    want_flash = impl == "flash" or (
        impl == "auto"
        and q.device.type == "cuda"
        and q.shape[1] > FLASH_ATTN_THRESHOLD
        and q.shape[-1] in SUPPORTED_HEAD_DIMS
    )
    if want_flash:
        return flash_attention_bshd(q, k, v, scale)
    return xla_sdpa(q, k, v, scale)
