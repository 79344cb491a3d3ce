"""The benchmark's fixed arithmetic: operation counts, peaks and roofline bounds.

Frozen copies, so that a later change to the program cannot move the
yardstick:

- ``mmdit_step_flops`` from ``diffusionkit_tpu_torch/flops.py`` at commit
  c82efae, split further into the linear layers and the joint attention;
- ``PEAK``, ``HBM`` and ``bound`` from ``chip_smoke.py`` (lines 1013-1030)
  at commit c82efae.

Peaks are NVIDIA's data-sheet figures of one H100 SXM at its 700 W limit,
dense rates.
"""

from __future__ import annotations

from typing import Dict, Tuple

PEAK = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12, "tf32x3": 495e12 / 3}
HBM = 3.35e12  # bytes/s


def bound(ops: float, peak: str, nbytes: float) -> Tuple[float, str]:
    """(seconds, what sets it): the larger of ``ops`` at the peak rate of
    their type and ``nbytes`` (each input read once, each output written
    once) at the memory rate."""
    t_ops, t_bytes = ops / PEAK[peak], nbytes / HBM
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def mmdit_step_flops(m: Dict, latent_hw: Tuple[int, int], txt_tokens: int, batch: int = 1,
                     cfg: bool = True) -> Dict[str, float]:
    """FLOPs of one denoise step (one MMDiT forward over the model batch),
    branch-weighted: a dual-stream block's image projections see only image
    tokens and its text projections only text tokens; joint attention is
    counted over the joint sequence; 1 MAC = 2 FLOPs; elementwise work is
    left out. ``m`` is a configuration's ``mmdit`` group (hidden_size,
    depth_multimodal, depth_unified, mlp_ratio, patch_size,
    vae_latent_dim, token_level_text_embed_dim,
    parallel_mlp_for_unified_blocks)."""
    H, mr, p = m["hidden_size"], m["mlp_ratio"], m["patch_size"]
    depth_mm, depth_uni = m["depth_multimodal"], m["depth_unified"]
    s_img = (latent_hw[0] // p) * (latent_hw[1] // p)
    s_txt = txt_tokens
    s_joint = s_img + s_txt
    rows = batch * (2 if cfg else 1)

    mm_tok = (3 + 1 + 2 * mr) * H * H
    n_mm_full = depth_mm - (1 if depth_uni == 0 else 0)
    macs_mm = n_mm_full * rows * ((s_img + s_txt) * mm_tok + 2 * 6 * H * H)
    macs_attn_mm = depth_mm * rows * 2 * s_joint * s_joint * H
    macs_mm_final = 0.0
    if depth_uni == 0:  # SD3's last block: the text branch is K/V only
        macs_mm_final = rows * (s_img * mm_tok + s_txt * 3 * H * H + (6 + 2) * H * H)
    n_ada_uni = 3 if m["parallel_mlp_for_unified_blocks"] else 6
    macs_uni = depth_uni * rows * (s_joint * mm_tok + n_ada_uni * H * H)
    macs_attn_uni = depth_uni * rows * 2 * s_joint * s_joint * H
    patch_in = m["vae_latent_dim"] * p * p
    macs_io = rows * (s_img * patch_in * H + s_txt * m["token_level_text_embed_dim"] * H
                      + 4 * H * H + 2 * H * H + s_img * H * patch_in)
    blocks = macs_mm + macs_mm_final + macs_uni
    return {
        "total": 2.0 * (blocks + macs_io + macs_attn_mm + macs_attn_uni),
        "block_linears": 2.0 * blocks,
        "io_linears": 2.0 * macs_io,
        "attention": 2.0 * (macs_attn_mm + macs_attn_uni),
        "img_tokens": float(s_img),
        "txt_tokens": float(s_txt),
        "model_batch": float(rows),
    }


def block_linear_params(m: Dict) -> float:
    """Weights of the blocks' linear layers (q, k, v, o, fc1, fc2, ada), read
    once a step."""
    H, mr = m["hidden_size"], m["mlp_ratio"]
    per = (4 + 2 * mr) * H * H
    n_mm_full = m["depth_multimodal"] - (1 if m["depth_unified"] == 0 else 0)
    params = n_mm_full * 2 * (per + 6 * H * H)
    if m["depth_unified"] == 0:
        params += per + 6 * H * H + 3 * H * H + 2 * H * H
    n_ada_uni = 3 if m["parallel_mlp_for_unified_blocks"] else 6
    params += m["depth_unified"] * (per + n_ada_uni * H * H)
    return float(params)


def step_least_seconds(m: Dict, latent_hw, txt_tokens: int, batch: int, cfg: bool,
                       linear_peak: str, weight_bytes: float) -> Dict[str, float]:
    """The least time of one step's parts: the linear layers at the peak of
    the type they compute in (the blocks' at ``linear_peak``, the float
    embedders and final layer at bf16) or by their bytes, whichever is
    larger, and the joint attention at the bf16 peak or its bytes."""
    f = mmdit_step_flops(m, latent_hw, txt_tokens, batch, cfg)
    H = m["hidden_size"]
    rows, s_img, s_txt = f["model_batch"], f["img_tokens"], f["txt_tokens"]
    s_joint = s_img + s_txt
    # activations in and out of every block linear in bf16, once
    n_blocks = m["depth_multimodal"] + m["depth_unified"]
    act_bytes = 2 * rows * s_joint * H * (2 * 4 + 2 * m["mlp_ratio"] + 2) * n_blocks
    lin_bytes = block_linear_params(m) * weight_bytes + act_bytes
    t_blocks, _ = bound(f["block_linears"], linear_peak, lin_bytes)
    t_io, _ = bound(f["io_linears"], "bf16", 0.0)
    heads_d = H  # heads x head_dim
    attn_bytes = 4 * 2 * rows * s_joint * heads_d * n_blocks  # q, k, v read, o written
    t_attn, _ = bound(f["attention"], "bf16", attn_bytes)
    return {"linears": t_blocks + t_io, "attention": t_attn,
            "step": t_blocks + t_io + t_attn, "flops": f["total"]}


def cell_step(ctx: Dict) -> Dict[str, float]:
    """The least seconds of one denoise step of a cell (``step_least_seconds``
    at its shapes, its configuration's linear peak and weight bytes)."""
    cfg, t = ctx["config"], ctx["cell"]["traffic"]
    m = cfg["mmdit"]
    return step_least_seconds(m, (t["height"] // 8, t["width"] // 8), cfg["txt_tokens"],
                              ctx["cell"].get("model_batch", t.get("batch", 1)), t["cfg"] > 1,
                              cfg["linear_peak"], cfg["linear_weight_bytes"])
