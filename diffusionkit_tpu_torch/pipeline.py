"""txt2img pipelines: text encoding, CFG + Euler denoising, VAE decoding.

Counterparts of ``diffusionkit_tpu/pipeline.py:DiffusionPipeline`` (SD3,
txt2img) and ``FluxPipeline`` (FLUX.1: CLIP-L pooled + T5 tokens, the FLUX
schedule and latent format, FLUX-dev's guidance). The denoise loop is a
per-step Python loop that synchronises the device after each step, so
``iter_time`` holds real per-step times. Noise is drawn with numpy in NCHW
and transposed to NHWC, as in the reference, so one seed gives the same
starting latents in both packages.

Models are plain attributes (``mmdit``, ``decoder``, ``clip_l``, ``clip_g``,
``t5`` and the tokenizers), set by the caller: the checkpoint loaders wait,
and ``models.init_*`` build random ones. ``quantize_mmdit`` converts an
assigned MMDiT on its own device, as the reference's quantize-at-load does:

  "int4" (or True), "int8"  weight-only, the min/max grid (GPTQ waits); an
                            already packed model passes through
  "w4a8"                    int4, then every int4 linear's per-channel
                            ``wscale``
  "w8a8"                    every eligible linear to ``W8A8Linear``, float
                            or packed (``w8a8_module_``)
  "<mode>-mixed"            ``MIXED_OVERRIDES`` on a float model: ``ada``
                            at int8, the final layer and embedders float

``FluxPipeline(quantize_t5=True)`` gives an assigned T5 the SmoothQuant
fold (``ops/smoothquant.smooth_t5``, calibrated with ``t5_tokenizer`` if it
is set by then) and converts it to w8a8. Every model stays resident; the
reference's phase-lazy loading, quantized-tree disk cache,
``DIFFUSIONKIT_TPU_T5_SMOOTH`` switch, ``use_scan``, tensor-parallel
loading and the data-parallel batch under a mesh, batch chunking, T5 for
SD3 and img2img wait for later slices.
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
from .models.t5 import T5Encoder
from .models.vae import VAEDecoder
from .ops.quantized import MIXED_OVERRIDES, QuantizedLinear, add_wscale_, quantize_module_
from .ops.smoothquant import smooth_t5
from .ops.w8a8 import W8A8Linear, w8a8_module_
from .sampler import FlowSchedule, FluxSampler, ModelSamplingDiscreteFlow
from .tokenizer import tokenize_batch
from .utils import bytes2gigabytes, device_memory_stats, get_logger

logger = get_logger(__name__)


@dataclass(frozen=True)
class LatentFormat:
    scale_factor: float = 1.0
    shift_factor: float = 0.0

    def process_out(self, latent):
        # A tensor divisor: torch computes a scalar one on CUDA as a product
        # with its reciprocal, which is not the reference's IEEE division.
        return (latent / torch.full_like(latent, self.scale_factor)) + self.shift_factor


SD3LatentFormat = partial(LatentFormat, 1.5305, 0.0609)
FluxLatentFormat = partial(LatentFormat, 0.3611, 0.1159)


QUANT_MODES = ("int4", "int8", "w4a8", "w8a8")


def parse_quant_mode(mode) -> Tuple[Optional[str], bool]:
    """``quantize_mmdit`` -> (base mode or None, mixed): False -> (None,
    False), True -> ("int4", False), "w4a8-mixed" -> ("w4a8", True). An
    unknown mode raises."""
    if mode is False or mode is None:
        return None, False
    if mode is True:
        return "int4", False
    if isinstance(mode, str):
        base = mode[: -len("-mixed")] if mode.endswith("-mixed") else mode
        if base in QUANT_MODES:
            return base, base != mode
    raise ValueError(f"quantize_mmdit={mode!r}: one of False, True, "
                     f"{', '.join(QUANT_MODES)}, or one of those with '-mixed'")


def _holds(model: torch.nn.Module, types) -> bool:
    return any(isinstance(m, types) for m in model.modules())


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
    guidance: Optional[float] = None,
    sdpa_impl: Optional[str] = None,
    mesh=None,
) -> torch.Tensor:
    """One CFG + Euler step on fp32 latents x (N, H, W, C).

    With CFG the model batch is [x, x] against conditioning rows
    [positive, negative]. All scalars are fp32 values, as on the reference's
    device. ``guidance`` (FLUX-dev) is broadcast over the model batch;
    ``sdpa_impl`` and ``mesh`` go to the model's attention.
    """
    n = x.shape[0]
    xin = torch.cat([x, x]) if cfg_on else x
    timestep = torch.full(
        (xin.shape[0],), float(np.float32(sigma) * np.float32(1000.0)),
        dtype=torch.float32, device=x.device,
    )
    g = None if guidance is None else torch.full(
        (xin.shape[0],), float(np.float32(guidance)), dtype=torch.float32, device=x.device)
    out = model(xin, conditioning, pooled, timestep, g, sdpa_impl=sdpa_impl, mesh=mesh).float()
    denoised = xin - out * float(sigma)
    if cfg_on:
        eps_text, eps_neg = denoised[:n], denoised[n:]
        denoised = eps_neg + float(np.float32(cfg_weight)) * (eps_text - eps_neg)
    # Euler: d = (x - denoised) / sigma; x += d * (sigma_next - sigma). The
    # divisor is a tensor, so the card divides (as the reference does)
    # rather than multiplying by a rounded reciprocal.
    d = (x - denoised) / torch.full_like(x, float(sigma))
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
    production schedule. ``quantize_mmdit`` (module docstring) converts the
    assigned MMDiT; weight-only modes pack at group ``quantize_group_size``
    (the reference's quantize-at-load, with the min/max grid until GPTQ is
    ported).

    ``sdpa_impl`` (None/'auto', 'xla', 'flash' or 'ring') and ``mesh`` (a
    ``parallel.create_mesh`` / ``local_mesh`` DeviceMesh) go to every MMDiT
    attention, as in the reference: ``sdpa_impl="ring"`` runs context-
    parallel ring attention over the mesh's model axis. Every model stays
    replicated on each rank, so the denoised result is the reference's
    tensor-parallel one up to the order of sums; tensor-parallel loading and
    the data-parallel split of the image batch come in a later slice."""

    def __init__(
        self,
        shift: float = 3.0,
        a16: bool = True,
        device="cuda",
        quantize_mmdit=False,
        quantize_group_size: int = 32,
        sdpa_impl: Optional[str] = None,
        mesh=None,
    ):
        self.quant_mode, self.quant_mixed = parse_quant_mode(quantize_mmdit)
        self.sdpa_impl = sdpa_impl
        self.mesh = mesh
        self.device = torch.device(device)
        self.activation_dtype = torch.bfloat16 if a16 else torch.float32
        self.sampler: FlowSchedule = ModelSamplingDiscreteFlow(shift=shift)
        self.latent_format = SD3LatentFormat()
        self.quantize_group_size = quantize_group_size
        self._mmdit: Optional[MMDiT] = None
        self.decoder: Optional[VAEDecoder] = None
        self.clip_l: Optional[CLIPTextModel] = None
        self.clip_g: Optional[CLIPTextModel] = None
        self.tokenizer_l = None
        self.tokenizer_g = None

    @property
    def mmdit(self) -> Optional[MMDiT]:
        return self._mmdit

    @mmdit.setter
    def mmdit(self, model: Optional[MMDiT]) -> None:
        mode = self.quant_mode
        if model is not None and mode == "w8a8":
            # Float and packed linears alike (the reference's w8a8_tree also
            # re-expresses a 4-bit checkpoint); the -mixed overrides do not
            # apply to w8a8, as in the reference.
            w8a8_module_(model)
        elif model is not None and mode:
            # A model that holds packed linears is a pre-quantized one (the
            # MLX 4-bit file, or a random packed init): it passes through,
            # as the reference skips quantize_tree for such checkpoints.
            if not _holds(model, (QuantizedLinear, W8A8Linear)):
                quantize_module_(model, self.quantize_group_size, bits=8 if mode == "int8" else 4,
                                 overrides=MIXED_OVERRIDES if self.quant_mixed else None)
            if mode == "w4a8":
                add_wscale_(model)
        self._mmdit = model

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
        guidance: Optional[float] = None,
    ) -> Tuple[torch.Tensor, List[float]]:
        """``guidance``: FLUX-dev's distilled guidance scale (3.5 when not
        given); ignored by models without a guidance embedding."""
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
        g = None
        if self.mmdit.config.guidance_embed:
            g = 3.5 if guidance is None else guidance
        x = torch.from_numpy(noise_scaled).to(self.device)
        iter_time: List[float] = []
        for i in range(len(sigmas) - 1):
            t0 = time.perf_counter()
            x = _cfg_euler_step(
                self.mmdit, x, sigmas[i], sigmas[i + 1], conditioning,
                pooled_conditioning, cfg_weight, cfg_on, g, self.sdpa_impl, self.mesh,
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


class FluxPipeline(DiffusionPipeline):
    """FLUX.1 txt2img: CLIP-L pooled output and T5 token embeddings (no
    CLIP-G), positive row only, T5 tokens zero-padded to ``t5_max_length``
    (256 for FLUX.1-schnell, 512 for FLUX.1-dev); the FLUX sigma schedule
    (``shift=1.0``) and latent format. ``quantize_t5``: the w8a8 T5 with
    its SmoothQuant fold (module docstring)."""

    def __init__(
        self,
        shift: float = 1.0,
        a16: bool = True,
        device="cuda",
        quantize_mmdit=False,
        quantize_group_size: int = 32,
        t5_max_length: int = 256,
        quantize_t5: bool = False,
        sdpa_impl: Optional[str] = None,
        mesh=None,
    ):
        super().__init__(shift=shift, a16=a16, device=device, quantize_mmdit=quantize_mmdit,
                         quantize_group_size=quantize_group_size, sdpa_impl=sdpa_impl,
                         mesh=mesh)
        self.sampler = FluxSampler(shift=shift)
        self.latent_format = FluxLatentFormat()
        self.t5_max_length = t5_max_length
        self.quantize_t5 = quantize_t5
        self.t5_tokenizer = None
        self._t5: Optional[T5Encoder] = None

    @property
    def t5(self) -> Optional[T5Encoder]:
        return self._t5

    @t5.setter
    def t5(self, model: Optional[T5Encoder]) -> None:
        if model is not None and self.quantize_t5 and not _holds(model, W8A8Linear):
            # In place on the model's device: the SmoothQuant fold first
            # (exact in float), then every eligible linear to w8a8.
            smooth_t5(model, self.t5_tokenizer)
            w8a8_module_(model)
        self._t5 = model

    @torch.inference_mode()
    def encode_text(self, text: str, cfg_weight: float = 7.5, negative_text: str = ""):
        neg = negative_text if cfg_weight > 1 else None
        tokens_l = tokenize_batch(self.tokenizer_l, text, neg)[:1]
        pooled = self.clip_l(torch.from_numpy(tokens_l).to(self.device, torch.long)).pooled_output
        tokens_t5 = tokenize_batch(self.t5_tokenizer, text, neg)
        padded = np.zeros((1, self.t5_max_length), dtype=np.int64)
        padded[:, : tokens_t5.shape[1]] = tokens_t5[:1]
        conditioning = self.t5(torch.from_numpy(padded).to(self.device))
        return conditioning, pooled
