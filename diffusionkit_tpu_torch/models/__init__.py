from .clip import CLIPOutput, CLIPTextModel, init_clip
from .mmdit import MMDiT, init_mmdit
from .vae import VAEDecoder, init_vae_decoder

__all__ = [
    "CLIPOutput", "CLIPTextModel", "init_clip",
    "MMDiT", "init_mmdit",
    "VAEDecoder", "init_vae_decoder",
]
