"""Model configurations and named presets, with torch dtypes.

Counterpart of ``diffusionkit_tpu/config.py``: the numeric values are the
checkpoint-compatibility spec and are identical; only ``dtype`` is a torch
dtype. Every preset builds: SD3-medium, SD3.5-large (with its fp32-upcast
block 35) and FLUX.1 (schnell and dev).

Below the presets, the port's own copy of the reference's per-version
tables (``diffusionkit_tpu/model_io.py``'s ``MMDIT_CONFIG``,
``QUANTIZED_CKPT``, ``T5_MAX_LENGTH``, ``DEPTH``, ``MAX_LATENT_RESOLUTION``)
and of its CLI's per-version ``HEIGHT`` / ``WIDTH`` / ``SHIFT``
(``diffusionkit_tpu/scripts/generate_images.py``): values only, keyed by
``model_version``. The checkpoint file tables and the loaders are in
``model_io.py``.
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
class AutoencoderConfig:
    """Generic SD VAE (the ``models/vae.Autoencoder``)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels_out: int = 8
    latent_channels_in: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


@dataclass(frozen=True)
class VAEDecoderConfig:
    """SD3/FLUX 16-channel VAE decoder."""

    in_channels: int = 16
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 3
    resnet_groups: int = 32


@dataclass(frozen=True)
class VAEEncoderConfig:
    """SD3/FLUX VAE encoder, 3 -> 32 channels (mean and logvar)."""

    in_channels: int = 3
    out_channels: int = 32
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
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


# -- per-version tables (values of the reference's model_io.py and CLI) ---------

SD3_MEDIUM = "argmaxinc/mlx-stable-diffusion-3-medium"
SD35_LARGE = "argmaxinc/mlx-stable-diffusion-3.5-large"
SD35_LARGE_4BIT = "argmaxinc/mlx-stable-diffusion-3.5-large-4bit-quantized"
FLUX_SCHNELL_VERSION = "argmaxinc/mlx-FLUX.1-schnell"
FLUX_SCHNELL_4BIT = "argmaxinc/mlx-FLUX.1-schnell-4bit-quantized"
FLUX_DEV_VERSION = "argmaxinc/mlx-FLUX.1-dev"

MMDIT_CONFIG = {
    SD3_MEDIUM: SD3_2b,
    SD35_LARGE: SD3_8b,
    SD35_LARGE_4BIT: SD3_8b,
    FLUX_SCHNELL_VERSION: FLUX_SCHNELL,
    FLUX_SCHNELL_4BIT: FLUX_SCHNELL,
    # FLUX.1-dev gets its own config (guidance embedding on), as in the
    # reference's table (its upstream loads dev with schnell's).
    FLUX_DEV_VERSION: FLUX_DEV,
}

# Versions whose checkpoint is already packed at 4 bits (group 64): a
# quantize mode passes their packed linears through.
QUANTIZED_CKPT = {SD35_LARGE_4BIT, FLUX_SCHNELL_4BIT}

# T5 token rows by version: FLUX pads its T5 tokens to this length; SD3's
# T5 tokenizer is built with it.
T5_MAX_LENGTH = {
    SD3_MEDIUM: 512,
    SD35_LARGE: 512,
    SD35_LARGE_4BIT: 512,
    FLUX_SCHNELL_VERSION: 256,
    FLUX_SCHNELL_4BIT: 256,
    FLUX_DEV_VERSION: 512,
}

DEPTH = {SD3_MEDIUM: 24, SD35_LARGE: 38, SD35_LARGE_4BIT: 38}

MAX_LATENT_RESOLUTION = {SD3_MEDIUM: 96, SD35_LARGE: 192, SD35_LARGE_4BIT: 192}

# The CLI's per-version image size and schedule shift.
HEIGHT = {
    SD3_MEDIUM: 512,
    SD35_LARGE: 1024,
    SD35_LARGE_4BIT: 1024,
    FLUX_SCHNELL_VERSION: 512,
    FLUX_SCHNELL_4BIT: 512,
    FLUX_DEV_VERSION: 512,
}
WIDTH = dict(HEIGHT)
SHIFT = {
    SD3_MEDIUM: 3.0,
    SD35_LARGE: 3.0,
    SD35_LARGE_4BIT: 3.0,
    FLUX_SCHNELL_VERSION: 1.0,
    FLUX_SCHNELL_4BIT: 1.0,
    FLUX_DEV_VERSION: 1.0,
}
