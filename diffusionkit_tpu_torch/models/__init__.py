from .clip import CLIPOutput, CLIPTextModel, init_clip
from .mmdit import MMDiT, init_mmdit
from .t5 import T5Encoder, init_t5
from .vae import (
    Autoencoder, VAEDecoder, VAEEncoder, init_autoencoder, init_vae_decoder, init_vae_encoder,
)

__all__ = [
    "CLIPOutput", "CLIPTextModel", "init_clip",
    "MMDiT", "init_mmdit",
    "T5Encoder", "init_t5",
    "Autoencoder", "VAEDecoder", "VAEEncoder", "init_autoencoder", "init_vae_decoder",
    "init_vae_encoder",
]
