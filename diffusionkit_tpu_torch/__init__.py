"""diffusionkit_tpu_torch: the PyTorch / CUDA port of diffusionkit_tpu.

A second package beside the JAX one, for one NVIDIA H100. It never imports
jax. Plain tensor code is PyTorch; the two Pallas kernels of the SD3-medium
txt2img path are hand-written CUDA for sm_90a (``csrc/``): the flash
attention (``ops/flash_attention.py``) and the fused AdaLN LayerNorm
(``ops/fused_quant.py``).
"""

__version__ = "0.1.0"

from .config import CLIP_G, CLIP_L, SD3_2b, MMDiTConfig, VAEDecoderConfig  # noqa: F401
from .pipeline import DiffusionPipeline, SD3LatentFormat  # noqa: F401
from .sampler import ModelSamplingDiscreteFlow  # noqa: F401
