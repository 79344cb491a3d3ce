"""diffusionkit_tpu_torch: the PyTorch / CUDA port of diffusionkit_tpu.

A second package beside the JAX one, for one NVIDIA H100. It never imports
jax. Plain tensor code is PyTorch; the Pallas kernels of the SD3-medium and
FLUX.1-schnell txt2img paths in bf16, int4, int8, w4a8 and w8a8 are
hand-written CUDA for sm_90a (``csrc/``): the flash attention
(``ops/flash_attention.py``), the fused AdaLN LayerNorm and the row-wise
int8 quantizers (``ops/fused_quant.py``), the int4 and int8 dequant-matmuls
(``ops/int4_matmul.py``) and the int8 tensor-core matmuls of the w4a8 and
w8a8 linears (``ops/w4a8_matmul.py``). ``parallel/`` holds the
``torch.distributed`` meshes, the Megatron tensor-parallel shard plan of
the MMDiT and the T5 and its collectives (the pipelines also split the
image batch over a mesh's data axis), and the context-parallel ring
attention (``sdpa_impl="ring"``), whose chunk kernel sits beside the flash
attention.
``model_io`` reads safetensors checkpoints into the VAE modules (the
decoder, img2img's encoder and the generic ``Autoencoder``).
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401
    CLIP_G, CLIP_L, FLUX_DEV, FLUX_SCHNELL, SD3_2b, T5_XXL, AutoencoderConfig, MMDiTConfig,
    T5Config, VAEDecoderConfig, VAEEncoderConfig,
)
from .parallel import create_mesh, init_distributed, local_mesh  # noqa: F401
from .pipeline import DiffusionPipeline, FluxLatentFormat, FluxPipeline, SD3LatentFormat  # noqa: F401
from .sampler import FluxSampler, ModelSamplingDiscreteFlow  # noqa: F401
