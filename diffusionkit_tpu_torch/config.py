"""Model configurations and named presets, with torch dtypes.

Counterpart of ``diffusionkit_tpu/config.py``: the numeric values are the
checkpoint-compatibility spec and are identical; only ``dtype`` is a torch
dtype. SD3-medium and FLUX.1 (schnell and dev) build; SD3.5-large waits for
its fp32-upcast block segments.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


class PositionalEncoding(enum.Enum):
    LearnedInputEmbedding = 1
    PreSDPARope = 2


@dataclass(frozen=True)
class MMDiTConfig:
    """Multi-modal Diffusion Transformer configuration.

    ``hidden_size`` follows the SD3 convention of ``64 * depth_multimodal``
    unless overridden.
    """

    num_heads: int = 24
    depth_multimodal: int = 24
    depth_unified: int = 0
    parallel_mlp_for_unified_blocks: bool = True
    mlp_ratio: int = 4
    vae_latent_dim: int = 16
    layer_norm_eps: float = 1e-6
    pos_embed_type: PositionalEncoding = PositionalEncoding.LearnedInputEmbedding
    rope_axes_dim: Optional[Tuple[int, ...]] = None
    use_qk_norm: bool = False
    upcast_multimodal_blocks: Tuple[int, ...] = ()
    upcast_unified_blocks: Tuple[int, ...] = ()

    hidden_size_override: Optional[int] = None

    max_latent_resolution: int = 192
    patch_size: int = 2
    patchify_via_reshape: bool = False

    pooled_text_embed_dim: int = 2048  # SD3: 768+1280; FLUX: 768
    token_level_text_embed_dim: int = 4096

    frequency_embed_dim: int = 256
    max_period: int = 10000

    dtype: torch.dtype = torch.bfloat16

    guidance_embed: bool = False

    @property
    def hidden_size(self) -> int:
        return self.hidden_size_override or (64 * self.depth_multimodal)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


SD3_2b = MMDiTConfig(depth_multimodal=24, num_heads=24)

SD3_8b = MMDiTConfig(
    depth_multimodal=38,
    num_heads=38,
    upcast_multimodal_blocks=(35,),
    use_qk_norm=True,
)

FLUX_SCHNELL = MMDiTConfig(
    num_heads=24,
    depth_multimodal=19,
    depth_unified=38,
    parallel_mlp_for_unified_blocks=True,
    hidden_size_override=3072,
    patchify_via_reshape=True,
    pos_embed_type=PositionalEncoding.PreSDPARope,
    rope_axes_dim=(16, 56, 56),
    pooled_text_embed_dim=768,
    use_qk_norm=True,
)

FLUX_DEV = MMDiTConfig(
    num_heads=24,
    depth_multimodal=19,
    depth_unified=38,
    parallel_mlp_for_unified_blocks=True,
    hidden_size_override=3072,
    patchify_via_reshape=True,
    pos_embed_type=PositionalEncoding.PreSDPARope,
    rope_axes_dim=(16, 56, 56),
    pooled_text_embed_dim=768,
    use_qk_norm=True,
    guidance_embed=True,
)


@dataclass(frozen=True)
class VAEDecoderConfig:
    """SD3/FLUX 16-channel VAE decoder."""

    in_channels: int = 16
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 3
    resnet_groups: int = 32


@dataclass(frozen=True)
class CLIPTextModelConfig:
    """CLIP text encoder."""

    num_layers: int = 23
    model_dims: int = 1024
    num_heads: int = 16
    max_length: int = 77
    vocab_size: int = 49408
    projection_dim: Optional[int] = None
    hidden_act: str = "quick_gelu"


CLIP_L = CLIPTextModelConfig(
    num_layers=12,
    model_dims=768,
    num_heads=12,
    projection_dim=None,
    hidden_act="quick_gelu",
)

CLIP_G = CLIPTextModelConfig(
    num_layers=32,
    model_dims=1280,
    num_heads=20,
    projection_dim=1280,
    hidden_act="gelu",
)


@dataclass(frozen=True)
class T5Config:
    """T5 encoder config; defaults are google/t5-v1_1-xxl."""

    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "gated-gelu"
    decoder_start_token_id: int = 0


T5_XXL = T5Config()
