"""SD3 txt2img pipeline: text encoding, CFG + Euler denoising, VAE decoding.

Counterpart of ``diffusionkit_tpu/pipeline.py:DiffusionPipeline`` (txt2img).
The denoise loop is a per-step Python loop that synchronises the device
after each step, so ``iter_time`` holds real per-step times. Noise is drawn
with numpy in NCHW and transposed to NHWC, as in the reference, so one seed
gives the same starting latents in both packages.

Models are plain attributes (``mmdit``, ``decoder``, ``clip_l``, ``clip_g``
and the two tokenizers), set by the caller: the checkpoint loaders wait, and
``models.init_*`` build random ones. Every model stays resident; the
reference's phase-lazy loading, ``use_scan``, mesh, batch chunking, T5 and
img2img wait for later slices.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .models.clip import CLIPTextModel
from .models.mmdit import MMDiT
from .models.vae import VAEDecoder
from .sampler import FlowSchedule, ModelSamplingDiscreteFlow
from .tokenizer import tokenize_batch
from .utils import bytes2gigabytes, device_memory_stats, get_logger

logger = get_logger(__name__)


@dataclass(frozen=True)
class LatentFormat:
    scale_factor: float = 1.0
    shift_factor: float = 0.0

    def process_out(self, latent):
        return (latent / self.scale_factor) + self.shift_factor


SD3LatentFormat = partial(LatentFormat, 1.5305, 0.0609)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cfg_euler_step(
    model: MMDiT,
    x: torch.Tensor,
    sigma: np.float32,
    sigma_next: np.float32,
    conditioning: torch.Tensor,
    pooled: torch.Tensor,
    cfg_weight: float,
    cfg_on: bool,
) -> torch.Tensor:
    """One CFG + Euler step on fp32 latents x (N, H, W, C).

    With CFG the model batch is [x, x] against conditioning rows
    [positive, negative]. All scalars are fp32 values, as on the reference's
    device.
    """
    n = x.shape[0]
    xin = torch.cat([x, x]) if cfg_on else x
    timestep = torch.full(
        (xin.shape[0],), float(np.float32(sigma) * np.float32(1000.0)),
        dtype=torch.float32, device=x.device,
    )
    out = model(xin, conditioning, pooled, timestep).float()
    denoised = xin - out * float(sigma)
    if cfg_on:
        eps_text, eps_neg = denoised[:n], denoised[n:]
        denoised = eps_neg + float(np.float32(cfg_weight)) * (eps_text - eps_neg)
    # Euler: d = (x - denoised) / sigma; x += d * (sigma_next - sigma).
    d = (x - denoised) / float(sigma)
    return x + d * float(np.float32(sigma_next) - np.float32(sigma))


def _assemble_sd3_conditioning(h_l, h_g, p_l, p_g) -> Tuple[torch.Tensor, torch.Tensor]:
    """Penultimate CLIP-L/G hidden states concatenated and zero-padded to
    4096 features, followed by the (zero, T5 off) T5 rows; pooled outputs
    concatenated."""
    conditioning = torch.cat([h_l, h_g], dim=-1)
    pooled = torch.cat([p_l, p_g], dim=-1)
    b, s, d = conditioning.shape
    conditioning = torch.cat([conditioning, conditioning.new_zeros(b, s, 4096 - d)], dim=-1)
    return torch.cat([conditioning, torch.zeros_like(conditioning)], dim=1), pooled


def _prep_conditioning(conditioning, pooled, cfg_on: bool, dtype):
    """Rows [positive, negative] with CFG, the positive row alone without."""
    if cfg_on:
        if conditioning.shape[0] == 1:
            conditioning = conditioning.repeat(2, 1, 1)
            pooled = pooled.repeat(2, 1)
    else:
        conditioning, pooled = conditioning[:1], pooled[:1]
    return conditioning.to(dtype), pooled.to(dtype)


class DiffusionPipeline:
    """SD3-family txt2img with the reference's public surface:
    ``generate_image(text, num_steps, cfg_weight, negative_text,
    latent_size, seed, verbose)`` plus the ``encode_text`` /
    ``denoise_latents`` phase methods. The models carry their own weight
    dtypes; ``a16`` selects bf16 VAE activations; ``shift=3.0`` is the SD3
    production schedule."""

    def __init__(
        self,
        shift: float = 3.0,
        a16: bool = True,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.activation_dtype = torch.bfloat16 if a16 else torch.float32
        self.sampler: FlowSchedule = ModelSamplingDiscreteFlow(shift=shift)
        self.latent_format = SD3LatentFormat()
        self.mmdit: Optional[MMDiT] = None
        self.decoder: Optional[VAEDecoder] = None
        self.clip_l: Optional[CLIPTextModel] = None
        self.clip_g: Optional[CLIPTextModel] = None
        self.tokenizer_l = None
        self.tokenizer_g = None

    # -- text encoding -------------------------------------------------------

    @torch.inference_mode()
    def encode_text(self, text: str, cfg_weight: float = 7.5, negative_text: str = ""):
        neg = negative_text if cfg_weight > 1 else None
        outs = []
        for tokenizer, clip in ((self.tokenizer_l, self.clip_l), (self.tokenizer_g, self.clip_g)):
            tokens = torch.from_numpy(tokenize_batch(tokenizer, text, neg)).to(
                self.device, torch.long
            )
            outs.append(clip(tokens))
        out_l, out_g = outs
        return _assemble_sd3_conditioning(
            out_l.hidden_states[-2], out_g.hidden_states[-2],
            out_l.pooled_output, out_g.pooled_output,
        )

    # -- noise / sigma helpers -----------------------------------------------

    def get_noise(self, seed: int, x_T: np.ndarray) -> np.ndarray:
        """Seeded numpy noise drawn in NCHW then transposed to NHWC."""
        np.random.seed(seed)
        b, h, w, c = x_T.shape
        noise = np.random.randn(b, c, h, w)
        return noise.transpose(0, 2, 3, 1).astype(np.float32)

    def get_sigmas(self, num_steps: int) -> np.ndarray:
        return self.sampler.get_sigmas(num_steps)

    def get_empty_latent(self, *shape) -> np.ndarray:
        return np.full([1, *shape, 16], 0.0609, np.float32)

    # -- denoising -----------------------------------------------------------

    @torch.inference_mode()
    def denoise_latents(
        self,
        conditioning: torch.Tensor,
        pooled_conditioning: torch.Tensor,
        num_steps: int = 2,
        cfg_weight: float = 0.0,
        latent_size: Tuple[int, int] = (64, 64),
        seed=None,
    ) -> Tuple[torch.Tensor, List[float]]:
        seed = int(time.time()) if seed is None else int(seed)
        logger.info("Seed: %s", seed)
        x_T = self.get_empty_latent(*latent_size)
        noise = self.get_noise(seed, x_T)
        sigmas = self.get_sigmas(num_steps)
        noise_scaled = np.asarray(
            self.sampler.noise_scaling(
                sigmas[0], noise, x_T, self.sampler.max_denoise(sigmas)
            ),
            np.float32,
        )
        cfg_on = cfg_weight > 1
        conditioning, pooled_conditioning = _prep_conditioning(
            conditioning, pooled_conditioning, cfg_on, self.mmdit.config.dtype
        )
        x = torch.from_numpy(noise_scaled).to(self.device)
        iter_time: List[float] = []
        for i in range(len(sigmas) - 1):
            t0 = time.perf_counter()
            x = _cfg_euler_step(
                self.mmdit, x, sigmas[i], sigmas[i + 1], conditioning,
                pooled_conditioning, cfg_weight, cfg_on,
            )
            _sync(self.device)
            iter_time.append(time.perf_counter() - t0)
        return self.latent_format.process_out(x), iter_time

    # -- decoding ------------------------------------------------------------

    @torch.inference_mode()
    def decode_latents_to_u8(self, latents: torch.Tensor) -> torch.Tensor:
        """uint8 pixels (N, H, W, 3) decoded on the device: the VAE in the
        activation dtype, then ``floor(clip(x/2 + 0.5, 0, 1) * 255)``."""
        x = self.decoder(latents.to(self.activation_dtype))
        x = torch.clamp(x / 2 + 0.5, 0.0, 1.0)
        return torch.floor(x * 255.0).to(torch.uint8)

    # -- end to end ----------------------------------------------------------

    def _mem(self) -> Dict[str, Optional[float]]:
        stats = device_memory_stats(self.device)
        return {
            k: (round(bytes2gigabytes(v), 3) if v is not None else None)
            for k, v in stats.items()
        }

    def generate_image(
        self,
        text: str,
        num_steps: int = 2,
        cfg_weight: float = 0.0,
        negative_text: str = "",
        latent_size: Tuple[int, int] = (64, 64),
        seed=None,
        verbose: bool = True,
    ):
        """txt2img; returns (PIL image, phase log)."""
        from PIL import Image

        start_time = time.perf_counter()
        if latent_size[0] % 2 or latent_size[1] % 2:
            raise ValueError("Latent sizes must be divisible by 2 (patch size)")
        log: Dict[str, Any] = {
            "text_encoding": {"pre": self._mem(), "post": {}, "time": None},
            "denoising": {"pre": {}, "post": {}, "time": None, "iter_time": []},
            "decoding": {"pre": {}, "post": {}, "time": None},
            "peak_memory": 0.0,
        }

        def phase_end(name: str, t0: float) -> None:
            _sync(self.device)
            log[name]["time"] = time.perf_counter() - t0
            log[name]["post"] = self._mem()
            peak = log[name]["post"].get("peak_memory")
            if peak:
                log["peak_memory"] = max(log["peak_memory"], peak)
            if verbose:
                logger.info("%s time: %.3fs", name, log[name]["time"])

        t0 = time.perf_counter()
        conditioning, pooled = self.encode_text(text, cfg_weight, negative_text)
        phase_end("text_encoding", t0)

        log["denoising"]["pre"] = self._mem()
        t0 = time.perf_counter()
        latents, iter_time = self.denoise_latents(
            conditioning, pooled, num_steps=num_steps, cfg_weight=cfg_weight,
            latent_size=latent_size, seed=seed,
        )
        log["denoising"]["iter_time"] = iter_time
        phase_end("denoising", t0)

        log["decoding"]["pre"] = self._mem()
        t0 = time.perf_counter()
        pixels = self.decode_latents_to_u8(latents)
        phase_end("decoding", t0)

        x = pixels.cpu().numpy()
        log["total_time"] = time.perf_counter() - start_time
        if verbose:
            logger.info("Total time: %.3fs, peak memory %.3f GB",
                        log["total_time"], log["peak_memory"])
        return Image.fromarray(x[0]), log
