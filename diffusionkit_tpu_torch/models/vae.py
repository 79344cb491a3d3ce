"""SD3/FLUX VAE decoder and encoder, and the generic SD ``Autoencoder``, as
``nn.Module``s.

Counterpart of ``diffusionkit_tpu/models/vae.py``. The public ``forward``s
take and return NHWC like the reference; inside, the feature maps are NCHW
for ``F.conv2d`` (the reference left convolutions to XLA). GroupNorm
statistics run in fp32 (``ops/norms.group_norm``); the mid-block attention
is one head of the full channel width (512) through ``ops/attention.sdpa``,
which takes kernel B on the card above 1024 positions (in bf16, or in fp32
for an fp32 model).

``VAEEncoder`` (img2img's RGB -> 32-channel mean and logvar) downsamples
as the reference does: an asymmetric pad of one pixel on the bottom and
right, then a stride-2 valid convolution. The pipelines run it in fp32
whatever ``a16`` says, as the reference does. ``Autoencoder`` is the
reference's generic SD VAE: the same encoder and decoder with 1x1
``quant_proj`` / ``post_quant_proj`` projections (held as linears), the
decoder at ``layers_per_block + 1`` resnets a block, ``encode`` folding the
scaling factor into the mean and the logvar and ``decode`` dividing it
back out.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import AutoencoderConfig, VAEDecoderConfig, VAEEncoderConfig
from ..ops.attention import sdpa
from ..ops.common import linear
from ..ops.norms import group_norm


def conv2d(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Convolution in x's dtype (the kernel and bias are cast to it)."""
    return F.conv2d(
        x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
        stride=conv.stride, padding=conv.padding,
    )


def _gn(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    return group_norm(x, norm.weight, norm.bias, norm.num_groups, norm.eps)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, dtype: torch.dtype):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-6, dtype=dtype)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, dtype=dtype)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-6, dtype=dtype)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, dtype=dtype)
        # A 1x1 projection applied per pixel, stored as a linear layer.
        self.conv_shortcut = nn.Linear(cin, cout, dtype=dtype) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d(self.conv1, F.silu(_gn(self.norm1, x)))
        y = conv2d(self.conv2, F.silu(_gn(self.norm2, y)))
        if self.conv_shortcut is not None:
            x = linear(self.conv_shortcut, x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return x + y


class AttnBlock(nn.Module):
    """Single-head GroupNorm attention over all positions."""

    def __init__(self, c: int, groups: int, dtype: torch.dtype):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, c, eps=1e-6, dtype=dtype)
        self.query_proj = nn.Linear(c, c, dtype=dtype)
        self.key_proj = nn.Linear(c, c, dtype=dtype)
        self.value_proj = nn.Linear(c, c, dtype=dtype)
        self.out_proj = nn.Linear(c, c, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = _gn(self.group_norm, x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = (
            linear(layer, y).reshape(b, h * w, 1, c)
            for layer in (self.query_proj, self.key_proj, self.value_proj)
        )
        o = sdpa(q, k, v, scale=1.0 / math.sqrt(c), layout="bshd").to(x.dtype)
        o = linear(self.out_proj, o.reshape(b, h, w, c))
        return x + o.permute(0, 3, 1, 2)


class UpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n_resnets: int, upsample: bool,
                 groups: int, dtype: torch.dtype):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(cin if j == 0 else cout, cout, groups, dtype) for j in range(n_resnets)
        )
        self.upsample = nn.Conv2d(cout, cout, 3, padding=1, dtype=dtype) if upsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if self.upsample is not None:
            x = conv2d(self.upsample, F.interpolate(x, scale_factor=2, mode="nearest"))
        return x


class VAEDecoder(nn.Module):
    """forward(latents NHWC) -> RGB in about [-1, 1], NHWC."""

    def __init__(self, config: VAEDecoderConfig = VAEDecoderConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        boc, g = config.block_out_channels, config.resnet_groups
        self.conv_in = nn.Conv2d(config.in_channels, boc[-1], 3, padding=1, dtype=dtype)
        self.mid_blocks = nn.ModuleList([
            ResnetBlock(boc[-1], boc[-1], g, dtype),
            AttnBlock(boc[-1], g, dtype),
            ResnetBlock(boc[-1], boc[-1], g, dtype),
        ])
        channels = list(reversed(boc))
        channels = [channels[0]] + channels
        blocks = []
        for i, (cin, cout) in enumerate(zip(channels, channels[1:])):
            blocks.insert(0, UpBlock(cin, cout, config.layers_per_block,
                                     i < len(boc) - 1, g, dtype))
        # Stored outermost-resolution-first, applied in reverse.
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(g, boc[0], eps=1e-6, dtype=dtype)
        self.conv_out = nn.Conv2d(boc[0], config.out_channels, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv2d(self.conv_in, x.permute(0, 3, 1, 2).contiguous())
        for block in self.mid_blocks:
            x = block(x)
        for block in reversed(self.up_blocks):
            x = block(x)
        x = conv2d(self.conv_out, F.silu(_gn(self.conv_norm_out, x)))
        return x.permute(0, 2, 3, 1)


class DownBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n_resnets: int, downsample: bool,
                 groups: int, dtype: torch.dtype):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(cin if j == 0 else cout, cout, groups, dtype) for j in range(n_resnets)
        )
        self.downsample = (nn.Conv2d(cout, cout, 3, stride=2, padding=0, dtype=dtype)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if self.downsample is not None:
            # One pixel of zeros below and to the right, then a valid
            # stride-2 convolution (not a symmetric padding=1).
            x = conv2d(self.downsample, F.pad(x, (0, 1, 0, 1)))
        return x


class VAEEncoder(nn.Module):
    """forward(RGB NHWC in [-1, 1]) -> (mean, logvar) concatenated along
    the channels, NHWC at an eighth of the resolution."""

    def __init__(self, config: VAEEncoderConfig = VAEEncoderConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        boc, g = config.block_out_channels, config.resnet_groups
        self.conv_in = nn.Conv2d(config.in_channels, boc[0], 3, padding=1, dtype=dtype)
        channels = [boc[0]] + list(boc)
        self.down_blocks = nn.ModuleList(
            DownBlock(cin, cout, config.layers_per_block, i < len(boc) - 1, g, dtype)
            for i, (cin, cout) in enumerate(zip(channels, channels[1:]))
        )
        self.mid_blocks = nn.ModuleList([
            ResnetBlock(boc[-1], boc[-1], g, dtype),
            AttnBlock(boc[-1], g, dtype),
            ResnetBlock(boc[-1], boc[-1], g, dtype),
        ])
        self.conv_norm_out = nn.GroupNorm(g, boc[-1], eps=1e-6, dtype=dtype)
        self.conv_out = nn.Conv2d(boc[-1], config.out_channels, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv2d(self.conv_in, x.permute(0, 3, 1, 2).contiguous())
        for block in self.down_blocks:
            x = block(x)
        for block in self.mid_blocks:
            x = block(x)
        x = conv2d(self.conv_out, F.silu(_gn(self.conv_norm_out, x)))
        return x.permute(0, 2, 3, 1)


def _autoencoder_enc_config(config: AutoencoderConfig) -> VAEEncoderConfig:
    return VAEEncoderConfig(
        in_channels=config.in_channels,
        out_channels=config.latent_channels_out,
        block_out_channels=tuple(config.block_out_channels),
        layers_per_block=config.layers_per_block,
        resnet_groups=config.norm_num_groups,
    )


def _autoencoder_dec_config(config: AutoencoderConfig) -> VAEDecoderConfig:
    # The reference's decoder runs one resnet more a block than its encoder.
    return VAEDecoderConfig(
        in_channels=config.latent_channels_in,
        out_channels=config.out_channels,
        block_out_channels=tuple(config.block_out_channels),
        layers_per_block=config.layers_per_block + 1,
        resnet_groups=config.norm_num_groups,
    )


class Autoencoder(nn.Module):
    """The generic SD VAE: ``encode`` (RGB NHWC -> mean, logvar),
    ``decode`` (latents NHWC -> RGB NHWC) and ``forward(x, generator)``,
    the round trip through a reparameterised sample."""

    def __init__(self, config: AutoencoderConfig = AutoencoderConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.encoder = VAEEncoder(_autoencoder_enc_config(config), dtype)
        self.decoder = VAEDecoder(_autoencoder_dec_config(config), dtype)
        self.quant_proj = nn.Linear(config.latent_channels_out, config.latent_channels_out,
                                    dtype=dtype)
        self.post_quant_proj = nn.Linear(config.latent_channels_in, config.latent_channels_in,
                                         dtype=dtype)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, logvar), the scaling factor folded in: the mean times it,
        the logvar plus 2 log of it."""
        h = linear(self.quant_proj, self.encoder(x))
        mean, logvar = h.chunk(2, dim=-1)
        sf = self.config.scaling_factor
        return mean * sf, logvar + 2.0 * math.log(sf)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        # A tensor divisor: the reference's IEEE division (torch on CUDA
        # multiplies by a rounded reciprocal of a scalar one).
        z = z / torch.full_like(z, self.config.scaling_factor)
        return self.decoder(linear(self.post_quant_proj, z))

    def forward(self, x: torch.Tensor, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The round trip: z = mean + exp(logvar / 2) * noise, the noise
        drawn from ``generator`` (on x's device), and its decode."""
        mean, logvar = self.encode(x)
        noise = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
        z = noise * torch.exp(0.5 * logvar) + mean
        return {"x_hat": self.decode(z), "z": z, "mean": mean, "logvar": logvar}


@torch.no_grad()
def _init_random(model: nn.Module, generator: torch.Generator, device) -> nn.Module:
    """Variance-preserving weights (std 1/sqrt(fan_in)), so random latents
    decode to an image with visible structure rather than a flat grey;
    biases zero, GroupNorms identity."""
    model.to_empty(device=device)
    for module in model.modules():
        if isinstance(module, nn.GroupNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, (nn.Linear, nn.Conv2d)):
            fan_in = module.weight[0].numel()
            module.weight.normal_(0.0, fan_in**-0.5, generator=generator)
            module.bias.zero_()
    return model.eval()


def init_vae_decoder(
    config: VAEDecoderConfig, generator: torch.Generator, device="cuda",
    dtype: torch.dtype = torch.float32,
) -> VAEDecoder:
    """Random decoder on ``device`` from ``generator`` (``_init_random``)."""
    with torch.device("meta"):
        model = VAEDecoder(config, dtype)
    return _init_random(model, generator, device)


def init_vae_encoder(
    config: VAEEncoderConfig, generator: torch.Generator, device="cuda",
    dtype: torch.dtype = torch.float32,
) -> VAEEncoder:
    """Random encoder on ``device`` from ``generator`` (``_init_random``)."""
    with torch.device("meta"):
        model = VAEEncoder(config, dtype)
    return _init_random(model, generator, device)


def init_autoencoder(
    config: AutoencoderConfig, generator: torch.Generator, device="cuda",
    dtype: torch.dtype = torch.float32,
) -> Autoencoder:
    """Random generic autoencoder on ``device`` from ``generator``
    (``_init_random``)."""
    with torch.device("meta"):
        model = Autoencoder(config, dtype)
    return _init_random(model, generator, device)
