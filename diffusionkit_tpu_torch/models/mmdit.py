"""Multi-modal Diffusion Transformer (MMDiT), SD3 path, as ``nn.Module``s.

Counterpart of ``diffusionkit_tpu/models/mmdit.py``: the stacked block
parameters and ``lax.scan`` become an ``nn.ModuleList`` walked by a Python
loop. Same math and sequence order: SD3 concatenates [image, text] for the
joint attention; the last dual-stream block's text branch is K/V-only
(``final=True``: two modulation vectors, no o-projection or MLP). The AdaLN
LayerNorm sites go to kernel A (``ops/fused_quant.mod_ln``) and the joint
attention to kernel B through ``ops/attention.sdpa``.

RoPE, QK-norm, the unified (single-stream) blocks and the fp32-upcast block
segments wait for the FLUX and SD3.5 slices; building such a config raises.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import MMDiTConfig, PositionalEncoding
from ..ops.attention import sdpa
from ..ops.common import MLPSiLU, ffn_gelu, linear, patchify, timestep_embedding, unpatchify_sd3
from ..ops.fused_quant import mod_ln
from ..ops.norms import modulated_layer_norm


def _mod_ln_maybe_fused(
    x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor, eps: float
) -> torch.Tensor:
    """AdaLN LayerNorm site: kernel A where the reference's fused Pallas
    ``mod_ln`` is eligible (hidden a multiple of 128, a (B, S, H) tensor)
    and the tensor is on the card; else the plain ``modulated_layer_norm``.
    (The float branch of the reference's ``_mod_ln_maybe_quant``.)"""
    if x.is_cuda and x.ndim == 3 and x.shape[-1] % 128 == 0:
        return mod_ln(x, shift, scale, eps)
    return modulated_layer_norm(x, shift, scale, eps)


class BlockBranch(nn.Module):
    """One stream (image or text) of a dual-stream block."""

    def __init__(self, config: MMDiTConfig, num_mod: int, with_mlp: bool = True):
        super().__init__()
        H, dt = config.hidden_size, config.dtype
        self.num_mod = num_mod
        self.q = nn.Linear(H, H, dtype=dt)
        # No key bias: redundant under softmax shift invariance.
        self.k = nn.Linear(H, H, bias=False, dtype=dt)
        self.v = nn.Linear(H, H, dtype=dt)
        self.ada = nn.Linear(H, num_mod * H, dtype=dt)
        if with_mlp:
            self.o = nn.Linear(H, H, dtype=dt)
            self.fc1 = nn.Linear(H, H * config.mlp_ratio, dtype=dt)
            self.fc2 = nn.Linear(H * config.mlp_ratio, H, dtype=dt)

    def modulation(self, c: torch.Tensor) -> List[torch.Tensor]:
        """adaLN_modulation: SiLU -> Linear -> split into (B, 1, H) views."""
        y = linear(self.ada, F.silu(c))
        return [p[:, None, :] for p in y.chunk(self.num_mod, dim=-1)]

    def qkv(self, x: torch.Tensor, num_heads: int):
        b, s, h = x.shape
        return tuple(
            linear(layer, x).reshape(b, s, num_heads, h // num_heads)
            for layer in (self.q, self.k, self.v)
        )


class MMBlock(nn.Module):
    """Dual-stream block with joint attention over [image, text]."""

    def __init__(self, config: MMDiTConfig, final: bool = False):
        super().__init__()
        self.config = config
        self.final = final
        self.img = BlockBranch(config, 6)
        self.txt = BlockBranch(config, 2 if final else 6, with_mlp=not final)

    def forward(
        self, img: torch.Tensor, txt: torch.Tensor, c: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        eps = cfg.layer_norm_eps
        img_mods = self.img.modulation(c)
        txt_mods = self.txt.modulation(c)

        img_h = _mod_ln_maybe_fused(img, img_mods[0], img_mods[1], eps)
        txt_h = _mod_ln_maybe_fused(txt, txt_mods[0], txt_mods[1], eps)
        q_i, k_i, v_i = self.img.qkv(img_h, cfg.num_heads)
        q_t, k_t, v_t = self.txt.qkv(txt_h, cfg.num_heads)
        q = torch.cat([q_i, q_t], dim=1)
        k = torch.cat([k_i, k_t], dim=1)
        v = torch.cat([v_i, v_t], dim=1)
        o = sdpa(q, k, v, scale=1.0 / (cfg.head_dim**0.5), layout="bshd")
        o = o.flatten(2)
        img_len = img.shape[1]
        o_img, o_txt = o[:, :img_len], o[:, img_len:]

        img = img + img_mods[2] * linear(self.img.o, o_img)
        img = img + img_mods[5] * ffn_gelu(
            self.img.fc1, self.img.fc2,
            _mod_ln_maybe_fused(img, img_mods[3], img_mods[4], eps),
        )
        if self.final:
            return img, txt
        txt = txt + txt_mods[2] * linear(self.txt.o, o_txt)
        txt = txt + txt_mods[5] * ffn_gelu(
            self.txt.fc1, self.txt.fc2,
            _mod_ln_maybe_fused(txt, txt_mods[3], txt_mods[4], eps),
        )
        return img, txt


class FinalLayer(nn.Module):
    """2-vector AdaLN + linear to patch features."""

    def __init__(self, config: MMDiTConfig):
        super().__init__()
        H, dt = config.hidden_size, config.dtype
        self.ada = nn.Linear(H, 2 * H, dtype=dt)
        self.linear = nn.Linear(H, config.patch_size**2 * config.vae_latent_dim, dtype=dt)


class MMDiT(nn.Module):
    """SD3 MMDiT: forward(latent NHWC, token embeddings, pooled, timestep)
    -> velocity prediction NHWC."""

    def __init__(self, config: MMDiTConfig):
        super().__init__()
        if (
            config.depth_unified
            or config.pos_embed_type != PositionalEncoding.LearnedInputEmbedding
            or config.use_qk_norm
            or config.upcast_multimodal_blocks
            or config.guidance_embed
        ):
            raise NotImplementedError(
                "only the SD3 MMDiT path (learned pos-embed, no QK-norm, no "
                "unified blocks, no upcast segments) is ported"
            )
        self.config = config
        H, dt = config.hidden_size, config.dtype
        patch_in = config.vae_latent_dim * config.patch_size**2
        self.x_embedder = nn.Linear(patch_in, H, dtype=dt)
        self.context_embedder = nn.Linear(config.token_level_text_embed_dim, H, dtype=dt)
        self.y_embedder = MLPSiLU(config.pooled_text_embed_dim, H, dtype=dt)
        self.t_embedder = MLPSiLU(config.frequency_embed_dim, H, dtype=dt)
        self.pos_embed = nn.Parameter(
            torch.empty(config.max_latent_resolution**2, H, dtype=dt)
        )
        self.mm_blocks = nn.ModuleList(
            MMBlock(config) for _ in range(config.depth_multimodal - 1)
        )
        self.mm_final = MMBlock(config, final=True)
        self.final_layer = FinalLayer(config)

    def forward(
        self,
        latent: torch.Tensor,
        token_level_text_embeddings: torch.Tensor,
        pooled_text_embeddings: torch.Tensor,
        timestep: torch.Tensor,
    ) -> torch.Tensor:
        cfg = self.config
        b, lh, lw, _ = latent.shape
        dt, p = cfg.dtype, cfg.patch_size

        txt = linear(self.context_embedder, token_level_text_embeddings.to(dt))
        x = linear(self.x_embedder, patchify(latent.to(dt), p))

        # Center-cropped learned position table; its size comes from the
        # weights (SD3-medium and SD3.5 ship different table sizes).
        h, w = lh // p, lw // p
        maxhw = int(round(self.pos_embed.shape[0] ** 0.5))
        y0, x0 = (maxhw - h) // 2, (maxhw - w) // 2
        pos = self.pos_embed.reshape(maxhw, maxhw, cfg.hidden_size)
        x = x + pos[y0 : y0 + h, x0 : x0 + w].reshape(1, h * w, -1).to(dt)

        t_emb = self.t_embedder(
            timestep_embedding(timestep, cfg.frequency_embed_dim, cfg.max_period).to(dt)
        )
        c = t_emb + self.y_embedder(pooled_text_embeddings.to(dt))

        for block in self.mm_blocks:
            x, txt = block(x, txt, c)
        x, _ = self.mm_final(x, txt, c)

        fl = self.final_layer
        shift, scale = (m[:, None, :] for m in linear(fl.ada, F.silu(c)).chunk(2, dim=-1))
        x = _mod_ln_maybe_fused(x, shift, scale, cfg.layer_norm_eps)
        x = linear(fl.linear, x)
        return unpatchify_sd3(x, (lh, lw), p, cfg.vae_latent_dim)


def init_mmdit(
    config: MMDiTConfig, generator: torch.Generator, device="cpu", std: float = 0.02
) -> MMDiT:
    """Random MMDiT with checkpoint-compatible shapes, built directly on
    ``device``: weights ~ N(0, std) from ``generator`` (which must live on
    that device), biases zero."""
    with torch.device("meta"):
        model = MMDiT(config)
    model.to_empty(device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, std, generator=generator)
    return model.eval()
