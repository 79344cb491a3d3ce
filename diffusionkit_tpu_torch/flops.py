"""Analytic per-step FLOP accounting for MMDiT denoising.

The same branch-weighted count as ``diffusionkit_tpu/flops.py``: in a
dual-stream block the image branch's projections see only image tokens and
the text branch's only text tokens; joint attention is counted over the
concatenated sequence. 1 MAC = 2 FLOPs; elementwise work is ignored.
"""

from __future__ import annotations

from typing import Dict, Tuple

from .config import MMDiTConfig


def mmdit_step_flops(
    config: MMDiTConfig,
    latent_hw: Tuple[int, int],
    txt_tokens: int,
    batch: int = 1,
    cfg: bool = True,
) -> Dict[str, float]:
    """FLOPs of ONE denoise step (one MMDiT forward over the model batch).

    Args:
      latent_hw: latent spatial dims (H_lat, W_lat) — e.g. (64, 64) for 512².
      txt_tokens: conditioning sequence length (SD3 without T5: 77+77=154).
      batch: number of images.
      cfg: whether the model batch is doubled for classifier-free guidance.
    """
    H = config.hidden_size
    m = config.mlp_ratio
    p = config.patch_size
    s_img = (latent_hw[0] // p) * (latent_hw[1] // p)
    s_txt = txt_tokens
    s_joint = s_img + s_txt
    rows = batch * (2 if cfg else 1)

    # Dual-stream blocks, per-token projection MACs per branch:
    # qkv 3H^2, o H^2, mlp (2m)H^2; ada is 6H^2 per batch row per branch.
    mm_tok = (3 + 1 + 2 * m) * H * H
    n_mm_full = config.depth_multimodal - (1 if config.depth_unified == 0 else 0)
    macs_mm = n_mm_full * rows * ((s_img + s_txt) * mm_tok + 2 * 6 * H * H)
    # Joint attention: QK^T + PV, each s_joint^2 * H MACs per row.
    macs_attn_mm = config.depth_multimodal * rows * 2 * s_joint * s_joint * H

    # SD3 final block: image branch full; text branch K/V-only.
    macs_mm_final = 0.0
    if config.depth_unified == 0:
        macs_mm_final = rows * (s_img * mm_tok + s_txt * 3 * H * H + (6 + 2) * H * H)

    uni_tok = (3 + 1 + 2 * m) * H * H
    n_ada_uni = 3 if config.parallel_mlp_for_unified_blocks else 6
    macs_uni = config.depth_unified * rows * (s_joint * uni_tok + n_ada_uni * H * H)
    macs_attn_uni = config.depth_unified * rows * 2 * s_joint * s_joint * H

    patch_in = config.vae_latent_dim * p * p
    macs_io = rows * (
        s_img * patch_in * H
        + s_txt * config.token_level_text_embed_dim * H
        + 4 * H * H
        + 2 * H * H
        + s_img * H * patch_in
    )

    total_macs = (
        macs_mm + macs_attn_mm + macs_mm_final + macs_uni + macs_attn_uni + macs_io
    )
    return {
        "total": 2.0 * total_macs,
        "projections": 2.0 * (macs_mm + macs_mm_final + macs_uni + macs_io),
        "attention": 2.0 * (macs_attn_mm + macs_attn_uni),
        "img_tokens": float(s_img),
        "txt_tokens": float(s_txt),
        "model_batch": float(rows),
    }


# Dense bf16 tensor-core peak FLOP/s by device name (NVIDIA data sheets, SXM
# parts at their full power limit; a card set below it peaks lower).
_PEAK_BF16 = {
    "h100": 989e12,
    "h200": 989e12,
}


def device_peak_flops(device_name: str) -> float:
    """bf16 peak for a device name such as ``torch.cuda.get_device_name()``;
    0.0 if unknown."""
    s = device_name.lower()
    for key, peak in _PEAK_BF16.items():
        if key in s:
            return peak
    return 0.0
