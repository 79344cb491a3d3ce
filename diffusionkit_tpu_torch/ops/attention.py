"""Scaled dot-product attention dispatch.

Counterpart of ``diffusionkit_tpu/ops/attention.py``: the flash kernels
(``ops/flash_attention.py``: kernel B over (B, S, H, D), #15 over
(B, H, S, D)) for long sequences on the card, the materialised-score
fp32-softmax ``xla_sdpa`` as the reference path everywhere else, and
``impl="ring"``, context-parallel ring attention over a mesh's ``model``
axis (``parallel/ring_attention.py``).

Under a mesh the reference wraps its flash kernel in ``shard_map`` over the
head axis (``_flash_tp``), which the Megatron column plan has already
sharded. Here a model sharded over the mesh's ``model`` axis
(``parallel/sharding.py``) gives each rank q/k/v of its own heads
(``head_group``, the group they are split over), and the same kernels B
and #15 run on them as they are, with no wrapper and no collective. The
reference takes the flash kernel under a mesh only where the model axis
divides the heads; where it does not, the model gathers every head and
this dispatch sends them to ``xla_sdpa``, as the reference's does. The
ring (``impl="ring"``) splits the sequence over ``model`` with whole
heads, as the reference's ``seq_spec`` does: split heads are gathered over
the group before it and this rank's kept after it.
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
    head_group=None,
) -> torch.Tensor:
    """Dispatching SDPA, the reference's ``sdpa``.

    ``impl``: None/'auto', 'xla', 'flash' (default from
    ``DIFFUSIONKIT_TPU_SDPA``), or 'ring' (a mesh required). 'auto' takes
    the flash kernel for a CUDA tensor whose sequence exceeds
    FLASH_ATTN_THRESHOLD and whose head dim passes ``flash_eligible``;
    'flash' always takes it (on the CPU its plain version). The kernels
    raise on what they do not take.
    ``mesh``: a ``torch.distributed`` DeviceMesh with a ``model`` axis
    (``parallel.create_mesh``); enables 'ring'. ``head_group``: the
    process group over which q/k/v hold this rank's heads, or None where
    they hold every head; with whole heads under a mesh whose model axis
    does not divide them, 'flash' and auto take ``xla_sdpa`` (module
    docstring).
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
        from ..parallel.collectives import all_gather, group_size
        from ..parallel.ring_attention import ring_attention

        heads = 2 if bshd else 1
        n = group_size(head_group)
        if n > 1:  # the ring takes whole heads
            q, k, v = (all_gather(t, heads, head_group) for t in (q, k, v))
        if bshd:
            # The ring shards the sequence axis of the (B, H, S, D) form.
            out = ring_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                 scale, mesh).transpose(1, 2)
        else:
            out = ring_attention(q, k, v, scale, mesh)
        if n > 1:
            local = out.shape[heads] // n
            out = out.narrow(heads, torch.distributed.get_rank(head_group) * local, local)
        return out
    seq = q.shape[1] if bshd else q.shape[-2]
    head_dim = q.shape[-1]
    want_flash = impl == "flash" or (
        impl == "auto"
        and q.device.type == "cuda"
        and seq > FLASH_ATTN_THRESHOLD
        and flash_eligible(head_dim)
    )
    if want_flash and mesh is not None and head_group is None:
        from ..parallel.mesh import axis_size

        # The reference's rule: flash under a mesh only where the model
        # axis divides the heads.
        want_flash = q.shape[2 if bshd else 1] % axis_size(mesh, "model") == 0
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
