"""Scaled dot-product attention dispatch.

Counterpart of ``diffusionkit_tpu/ops/attention.py``: the flash kernels
(``ops/flash_attention.py``: kernel B over (B, S, H, D), #15 over
(B, H, S, D)) for long sequences on the card, the materialised-score
fp32-softmax ``xla_sdpa`` as the reference path everywhere else, and
``impl="ring"``, context-parallel ring attention over a mesh's ``model``
axis (``parallel/ring_attention.py``).

Under a mesh the reference wraps its flash kernel in ``shard_map`` over the
head axis (``_flash_tp``), which the Megatron column plan has already
sharded. This port does not shard heads yet: a mesh leaves the model
replicated on every rank, and ``impl="flash"`` or auto runs the kernel on
the full heads, which gives ``_flash_tp``'s result. The head split comes
with tensor parallelism.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .flash_attention import flash_attention, flash_attention_bshd

# Sequence length above which the flash kernel is used.
FLASH_ATTN_THRESHOLD = 1024


def flash_eligible(head_dim: int) -> bool:
    """The reference's ``flash_ok``: the head dims its dispatch sends to the
    flash kernel. A head dim that passes here but that the kernels do not
    take yet raises from ``ops/flash_attention``; it never falls back."""
    return head_dim in (64, 128, 256) or head_dim % 128 == 0


def _check_layout(layout: str) -> None:
    if layout not in ("bhsd", "bshd"):
        raise ValueError(f"layout must be 'bhsd' or 'bshd', got {layout!r}")


def xla_sdpa(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    layout: str = "bhsd",
) -> torch.Tensor:
    """Materialised-score SDPA over (B, H, S, D) or, with ``layout="bshd"``,
    (B, S, H, D): fp32 scores and softmax, P rounded to v's dtype, fp32 P.V,
    one rounding to q's dtype."""
    _check_layout(layout)
    if layout == "bshd":
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        p = torch.softmax(s * scale, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
        return out.to(q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    p = torch.softmax(s * scale, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    impl: Optional[str] = None,
    mesh=None,
    layout: str = "bhsd",
) -> torch.Tensor:
    """Dispatching SDPA, the reference's ``sdpa``.

    ``impl``: None/'auto', 'xla', 'flash' (default from
    ``DIFFUSIONKIT_TPU_SDPA``), or 'ring' (a mesh required). 'auto' takes
    the flash kernel for a CUDA tensor whose sequence exceeds
    FLASH_ATTN_THRESHOLD and whose head dim passes ``flash_eligible``;
    'flash' always takes it (on the CPU its plain version). The kernels
    raise on what they do not take.
    ``mesh``: a ``torch.distributed`` DeviceMesh with a ``model`` axis
    (``parallel.create_mesh``); enables 'ring'. The flash kernel runs on the
    full, replicated heads under it (module docstring).
    ``layout``: 'bhsd' (B, H, S, D) or 'bshd' (B, S, H, D), the layout the
    model's head split yields, which kernel B reads in place. With
    ``DIFFUSIONKIT_TPU_ATTN_LAYOUT=bhsd`` (the reference's A/B switch) a
    bshd call that would take kernel B takes #15 instead, through
    transposed views.
    """
    _check_layout(layout)
    impl = impl or os.environ.get("DIFFUSIONKIT_TPU_SDPA", "auto")
    bshd = layout == "bshd"
    if impl == "ring":
        if mesh is None:
            raise ValueError("sdpa impl='ring' requires a mesh")
        from ..parallel.ring_attention import ring_attention

        if bshd:
            # The ring shards the sequence axis of the (B, H, S, D) form.
            return ring_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  scale, mesh).transpose(1, 2)
        return ring_attention(q, k, v, scale, mesh)
    seq = q.shape[1] if bshd else q.shape[-2]
    head_dim = q.shape[-1]
    want_flash = impl == "flash" or (
        impl == "auto"
        and q.device.type == "cuda"
        and seq > FLASH_ATTN_THRESHOLD
        and flash_eligible(head_dim)
    )
    if not want_flash:
        return xla_sdpa(q, k, v, scale, layout)
    # The reference's bshd kernel takes head dims that divide 128 or that
    # 128 divides; the others, and every head under the switch, go to the
    # (B, H, S, D) kernel through transposes.
    bshd_ok = head_dim % 128 == 0 or 128 % head_dim == 0
    if os.environ.get("DIFFUSIONKIT_TPU_ATTN_LAYOUT") == "bhsd":
        bshd_ok = False
    if bshd and bshd_ok:
        return flash_attention_bshd(q, k, v, scale)
    if bshd:
        return flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               scale).transpose(1, 2)
    return flash_attention(q, k, v, scale)
