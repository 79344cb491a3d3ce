"""Kernel B: non-causal flash attention over (B, S, H, D).

Replaces the Pallas kernel
``diffusionkit_tpu/ops/flash_attention.py:flash_attention_bshd``, which runs
the SD3 joint attention (24 heads of d=64 over 1024 + 154 tokens at 512²),
FLUX's joint attention (24 heads of d=128 over 256 + 4096 tokens at 1024²)
and the VAE mid-block attention (one head of d=512).
The CUDA source is ``csrc/flash_attention.cu``: compute-bound at the SD3
shape, tensor-core (mma.sync) products with an in-register online softmax,
the bshd layout read in place through strides; see the note there.

``flash_attention_bshd`` launches the kernel for a CUDA tensor and raises on
what the kernel does not take (bf16, d in ``SUPPORTED_HEAD_DIMS``); a CPU
tensor goes to ``flash_attention_bshd_plain``, the same numerics in plain
torch with the score matrix materialised.
"""

from __future__ import annotations

import torch

from . import kernels

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (64, 128, 512)


def flash_attention_bshd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """Plain torch version of the kernel's math: fp32 scores, the row max
    unscaled with ``scale`` folded into the exponent, P rounded to v's dtype
    before P.V with fp32 accumulation, divided by the fp32 row sum and
    rounded once."""
    if not scale > 0:
        raise ValueError(f"flash_attention_bshd requires scale > 0, got {scale}")
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp((s - m) * scale)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    return (pv / l).permute(0, 2, 1, 3).to(q.dtype).contiguous()


def flash_attention_bshd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, S, H, D) inputs; returns a
    contiguous (B, S, H, D) tensor in q's dtype.

    On CUDA: bf16, D in SUPPORTED_HEAD_DIMS, a contiguous head dim and
    16-byte aligned rows; other strides are read in place.
    """
    if q.device.type == "cpu":
        return flash_attention_bshd_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bshd: unsupported device {q.device}")
    if not scale > 0:
        raise ValueError(f"flash_attention_bshd requires scale > 0, got {scale}")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_attention_bshd: q, k, v must share one (B, S, H, D) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, s, h, d = q.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention_bshd: head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise TypeError(f"flash_attention_bshd: {name} must be bf16 on {q.device}")
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention_bshd: {name} needs a contiguous head dim and 16-byte "
                f"aligned rows, got strides {t.stride()}"
            )
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    err = kernels.library().dk_flash_attn_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d,
        *strides, float(scale), kernels.stream_ptr(q.device),
    )
    kernels.check(err, "flash_attention_bshd")
    flash_attention_bshd.launches += 1
    return out


flash_attention_bshd.launches = 0
