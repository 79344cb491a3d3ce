"""txt2img and img2img pipelines: text encoding, VAE encoding of a source
image, CFG + Euler denoising, VAE decoding.

Counterparts of ``diffusionkit_tpu/pipeline.py:DiffusionPipeline`` (SD3 and
SD3.5: CLIP-L/G and, with ``use_t5``, T5 tokens) and ``FluxPipeline``
(FLUX.1: CLIP-L pooled + T5 tokens, the FLUX schedule and latent format,
FLUX-dev's guidance). ``model_version`` names the reference's
model version (``config.MMDIT_CONFIG``'s keys; the reference's defaults),
which sets the T5 length (``config.T5_MAX_LENGTH``). Noise is drawn with numpy
in NCHW and transposed to NHWC, as in the reference, so one seed gives the
same starting latents in both packages; ``num_images`` draws the batch's
noise in one seeded call, so image 0 is the single-image run's.

img2img, as in the reference: ``generate_image(..., image_path=...,
denoise=...)`` reads the image (``read_image``: LANCZOS down to a multiple
of 64, [-1, 1] in fp32 on the host), encodes it on the device in fp32
(``encode_image_to_latents``: the VAE encoder's mean plus its clipped
standard deviation times noise drawn with the request's seed), takes the
latents back to the host for ``LatentFormat.process_in`` and the noise
scaling, and runs the schedule from its sigma ``int(num_steps * (1 -
denoise))`` on: about the last ``num_steps * denoise`` steps. The
encoder is the ``encoder`` attribute; when it is None at the first img2img
request it is loaded from the model's checkpoint
(``model_io.load_vae_encoder``, through ``local_ckpt``,
``DIFFUSIONKIT_TPU_CKPT_DIR`` or the hub), as the reference loads it.

The denoise loop, as in the reference, runs in one of two ways:

  use_scan=True (default)   the reference's ``_denoise_scan``. On a CUDA
                            device one CFG + Euler step is captured as a
                            CUDA graph (``graphs.StepGraph``) whose step
                            reads its sigmas at a device step index that it
                            advances itself; the host issues one replay a
                            step and synchronises once a request. Graphs are
                            cached by what the capture baked in (the model
                            config, CFG, ``sdpa_impl``, the mesh, the
                            shapes and dtypes of the latents and the
                            conditioning, whether ``guidance`` is given,
                            ``DIFFUSIONKIT_TPU_SDPA``,
                            ``DIFFUSIONKIT_TPU_ATTN_LAYOUT`` and TF32); the
                            ``mmdit`` setter drops them. ``iter_time`` is
                            the schedule's time over n, as in the
                            reference. On the CPU the same step runs in a
                            Python loop with no synchronisation.
  use_scan=False            a Python loop that synchronises after every step,
                            so ``iter_time`` holds real per-step times.

Both run one step body (``_scan_step``) on the same buffers, so on the card
they launch the same kernels in the same order. A mesh of more than one
rank runs the step uncaptured and logs it: NCCL inside a capture waits for
a machine with two cards. A denoise batch larger than the activation budget
(``_denoise_chunk_images``: ``utils.hbm_scale`` of 512² images at 64x64
latents, ``DIFFUSIONKIT_TPU_DENOISE_BATCH`` overrides it) runs in chunks
(``_run_denoise_chunks``), and a batch decodes in chunks
(``_decode_batched_u8``). ``generate_images_batched`` runs N prompts in one
schedule, the serving fast path.

Models are loaded from their checkpoints as in the reference
(``model_io``: the MMDiT in its sgm, BFL or MLX 4-bit namespace, CLIP-L/G
and T5-XXL from the HF files, the VAE; ``local_ckpt``, then
``DIFFUSIONKIT_TPU_CKPT_DIR``, then the hub), with every float weight in
``w16``'s dtype (bf16, or fp32 with ``w16=False``; ``a16`` is the VAE's
activation dtype). ``load=True`` loads at construction: the text encoders
under ``low_memory_mode`` (the default), everything without it. Each
request then loads what is missing before its phase (``load_text_encoders``,
``load_mmdit``, ``load_decoder``; ``check_and_load_models`` all of them)
and, under ``low_memory_mode``, drops each model after its phase, so the
device holds one phase's models at a time. A model or tokenizer is loaded
only where its attribute is None: a caller may assign any of them (the
T5 tokenizer, say, where its sentencepiece model is not on the machine)
and the loaders fetch the rest. Reloading the MMDiT goes through the
``mmdit`` setter, which drops the captured graphs, so under
``low_memory_mode`` every request captures its graph again; the phase log
holds the load and capture times. ``quantize_mmdit`` converts the MMDiT
on its own device, as the reference's quantize-at-load does:

  "int4" (or True)          weight-only int4: a float model by GPTQ
                            (``ops/gptq.gptq_quantize_mmdit``, calibrated
                            on its own batch), or with
                            ``DIFFUSIONKIT_TPU_GPTQ=0`` on the ALS grid
                            (``DIFFUSIONKIT_TPU_QUANT_REFINE=0``: min/max);
                            a failure of GPTQ itself, at any layer, puts
                            the whole float model on that grid with a
                            warning (the linears GPTQ may replace are kept
                            on the host while it runs; a kernel or CUDA
                            error propagates); an already packed model (the
                            4-bit releases) passes through
  "int8"                    weight-only int8 on the min/max grid
  "w4a8"                    int4, then every int4 linear's per-channel
                            ``wscale``
  "w8a8"                    every eligible linear to ``W8A8Linear``, float
                            or packed (``w8a8_module_``)
  "<mode>-mixed"            ``MIXED_OVERRIDES`` on a float model: ``ada``
                            at int8, the final layer and embedders float

``quantizer`` records the last conversion: {"name": "gptq", "als",
"minmax", "w8a8", "packed" (passed through) or "cached", "seconds"}; a
request that loads the MMDiT logs it as ``quantizer`` and
``quantize_time``. A quantized MMDiT loaded from its file is kept in the
reference's disk cache (``model_io.quant_cache_path``; under
``DIFFUSIONKIT_TPU_CACHE_DIR``, off with ``DIFFUSIONKIT_TPU_QUANT_CACHE=0``),
read before the float file, so under ``low_memory_mode`` only the first
request converts; an ALS or min/max model is never filed under a GPTQ tag.

``quantize_t5=True`` gives the T5 the SmoothQuant fold
(``ops/smoothquant.smooth_t5``, calibrated with ``t5_tokenizer`` if it is
set by then; ``DIFFUSIONKIT_TPU_T5_SMOOTH=0`` skips it) and converts it to
w8a8 on the device; a T5 loaded from its file is cached the same way.

Under a mesh (``parallel.create_mesh``; the reference's ``mesh``) the MMDiT
and the T5 are tensor-parallel over its ``model`` axis: every model that
lands on either (the setters, ``load_mmdit`` from the file or the cache,
``load_t5``) is sharded by the reference's Megatron plan
(``parallel/sharding.shard_module_``) after any conversion, which runs on
the whole model as the reference's does (a quantized model is filed in
the cache whole). A model read from a file or the cache is read to the
host and only this rank's slices go to the device. CLIP and the VAE stay
whole on every rank. The image batch is data-parallel over its ``data``
axis: ``denoise_latents(num_images=n)`` and ``generate_images_batched``
give each data rank a contiguous chunk of the n images (ragged where the
axis does not divide n, each with its CFG pair), every rank draws the whole
batch's noise from the seeds and takes its rows, ``generate_images_batched``
encodes a rank's own prompts only, and the latents are all-gathered over
``data`` before decoding, so every rank returns all n images.
"""

from __future__ import annotations

import gc
import os
import time
from dataclasses import dataclass
from functools import partial
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import model_io
from .config import FLUX_SCHNELL_VERSION, SD3_MEDIUM, T5_MAX_LENGTH
from .graphs import StepGraph
from .models.clip import CLIPTextModel
from .models.mmdit import MMDiT
from .models.t5 import T5Encoder
from .models.vae import VAEDecoder, VAEEncoder
from .ops import kernels
from .ops.gptq import eligible, gptq_quantize_mmdit
from .ops.quantized import (
    MIXED_OVERRIDES,
    QUANT_VERSION,
    QuantizedLinear,
    add_wscale_,
    quantize_module_,
    refine_default,
)
from .ops.smoothquant import smooth_t5
from .ops.w8a8 import W8A8Linear, w8a8_module_
from .parallel.collectives import all_gather
from .parallel.mesh import axis_index, axis_size, group
from .parallel.sharding import shard_module_
from .sampler import FlowSchedule, FluxSampler, ModelSamplingDiscreteFlow
from .tokenizer import tokenize_batch
from .utils import bytes2gigabytes, device_memory_stats, get_logger, hbm_scale

logger = get_logger(__name__)


@dataclass(frozen=True)
class LatentFormat:
    scale_factor: float = 1.0
    shift_factor: float = 0.0

    def process_in(self, latent: np.ndarray) -> np.ndarray:
        """Host numpy, as in the reference: the encoded latents into the
        denoiser's space."""
        return (latent - self.shift_factor) * self.scale_factor

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


def _device_error(e: BaseException) -> bool:
    """A kernel build or launch error, or an error of the CUDA runtime:
    what the GPTQ fallback must not swallow."""
    return isinstance(e, (kernels.KernelError, torch.OutOfMemoryError,
                          getattr(torch, "AcceleratorError", ()))) or (
        isinstance(e, RuntimeError) and "CUDA" in str(e))


def _host_linears(model: torch.nn.Module, group_size: int) -> list:
    """(parent, attribute, weight, bias) of every linear of ``model`` that
    GPTQ may replace (``ops.gptq.eligible``), its tensors copied to the
    host."""
    kept = []
    for parent in model.modules():
        for attr, layer in parent.named_children():
            if eligible(layer, group_size):
                bias = None if layer.bias is None else layer.bias.detach().cpu()
                kept.append((parent, attr, layer.weight.detach().cpu(), bias))
    return kept


def _restore_linears(kept: list, device: torch.device) -> None:
    """Each linear of ``kept`` that was replaced put back as the float
    ``nn.Linear`` it was, on ``device``."""
    for parent, attr, weight, bias in kept:
        if isinstance(getattr(parent, attr), torch.nn.Linear):
            continue
        layer = torch.nn.Linear(weight.shape[1], weight.shape[0], bias=bias is not None,
                                device="meta")
        layer.weight = torch.nn.Parameter(weight.to(device))
        if bias is not None:
            layer.bias = torch.nn.Parameter(bias.to(device))
        setattr(parent, attr, layer)


def _cfg_euler_step(
    model: MMDiT,
    x: torch.Tensor,
    sigma: torch.Tensor,
    sigma_next: torch.Tensor,
    conditioning: torch.Tensor,
    pooled: torch.Tensor,
    cfg_weight: torch.Tensor,
    cfg_on: bool,
    guidance: Optional[torch.Tensor] = None,
    sdpa_impl: Optional[str] = None,
    mesh=None,
) -> torch.Tensor:
    """One CFG + Euler step on fp32 latents x (N, H, W, C).

    With CFG the model batch is [x, x] against conditioning rows
    [positive*N, negative*N]. ``sigma``, ``sigma_next``, ``cfg_weight`` and
    ``guidance`` (FLUX-dev, broadcast over the model batch) are fp32 0-d
    tensors on x's device, as the reference's traced arrays are, so one
    captured step takes any step's sigmas. ``sdpa_impl`` and ``mesh`` go to
    the model's attention.
    """
    n = x.shape[0]
    xin = torch.cat([x, x]) if cfg_on else x
    timestep = (sigma * 1000.0).expand(xin.shape[0])
    g = None if guidance is None else guidance.expand(xin.shape[0])
    out = model(xin, conditioning, pooled, timestep, g, sdpa_impl=sdpa_impl, mesh=mesh).float()
    denoised = xin - out * sigma
    if cfg_on:
        eps_text, eps_neg = denoised[:n], denoised[n:]
        denoised = eps_neg + cfg_weight * (eps_text - eps_neg)
    # Euler: d = (x - denoised) / sigma; x += d * (sigma_next - sigma). The
    # divisor is a device tensor, not a CPU scalar, so the card divides (as
    # the reference does) rather than multiplying by a rounded reciprocal.
    d = (x - denoised) / sigma
    return x + d * (sigma_next - sigma)


def _encode_step(encoder: VAEEncoder, image: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The encoder's (mean, logvar) of ``image`` (NHWC in [-1, 1]) and a
    sample from it: mean + exp(logvar / 2) * ``noise``, the logvar clipped
    to [-30, 20]."""
    mean, logvar = encoder(image).chunk(2, dim=-1)
    logvar = torch.clamp(logvar, -30.0, 20.0)
    return mean + torch.exp(0.5 * logvar) * noise


def _scan_step(model, x, sigmas, idx, conditioning, pooled, cfg_weight, cfg_on, guidance,
               sdpa_impl, mesh) -> None:
    """The scan body, in place: step i of the schedule, where ``idx`` is
    the int64 device pair (i, i + 1) into the fp32 ``sigmas``; x becomes
    the step's output and idx advances. It reads nothing on the host, so a
    CUDA graph of one call replays as the next step."""
    sigma, sigma_next = sigmas.index_select(0, idx).unbind()
    x.copy_(_cfg_euler_step(model, x, sigma, sigma_next, conditioning, pooled, cfg_weight,
                            cfg_on, guidance, sdpa_impl, mesh))
    idx.add_(1)


class _Scan:
    """A denoise schedule's static buffers (latents, conditioning, the
    scalars, the sigmas and the step index) and its step on them; on the
    card, unless ``capture`` is off, the step's CUDA graph. ``n_sigmas`` is
    the longest schedule (steps + 1) the buffers take."""

    def __init__(self, model, x, conditioning, pooled, guidance, n_sigmas: int, cfg_on: bool,
                 sdpa_impl, mesh, capture: bool):
        dev = x.device
        self.n_sigmas = n_sigmas
        self.x = torch.empty_like(x, memory_format=torch.contiguous_format)
        self.conditioning = torch.empty_like(conditioning, memory_format=torch.contiguous_format)
        self.pooled = torch.empty_like(pooled, memory_format=torch.contiguous_format)
        self.cfg_weight = torch.zeros((), dtype=torch.float32, device=dev)
        self.guidance = None if guidance is None else torch.zeros((), dtype=torch.float32,
                                                                   device=dev)
        self.sigmas = torch.zeros(n_sigmas, dtype=torch.float32, device=dev)
        self.idx = torch.zeros(2, dtype=torch.int64, device=dev)
        self.step = partial(_scan_step, model, self.x, self.sigmas, self.idx, self.conditioning,
                            self.pooled, self.cfg_weight, cfg_on, self.guidance, sdpa_impl, mesh)
        self.graph = StepGraph(self.step, dev) if capture and dev.type == "cuda" else None

    def load(self, x, conditioning, pooled, cfg_weight: float, guidance, sigmas: np.ndarray):
        """The request's inputs into the buffers; the index back to step 0."""
        self.x.copy_(x)
        self.conditioning.copy_(conditioning)
        self.pooled.copy_(pooled)
        self.cfg_weight.fill_(float(np.float32(cfg_weight)))
        if self.guidance is not None:
            self.guidance.fill_(float(np.float32(guidance)))
        self.sigmas[: len(sigmas)].copy_(torch.from_numpy(np.asarray(sigmas, np.float32)))
        self.idx.copy_(torch.arange(2))

    def run(self, steps: int) -> None:
        """``steps`` steps with no host synchronisation: the graph's
        replays on the card, the step in a loop elsewhere."""
        if self.graph is not None:
            self.graph.run(steps)
        else:
            for _ in range(steps):
                self.step()


def _save_cache(model: torch.nn.Module, cache: Path) -> None:
    """``model`` filed in the quantized-model cache; a full disk only
    warns (the cache is optional)."""
    try:
        model_io.save_module_cache(model, cache)
    except OSError as e:
        logger.warning("quant cache write failed: %s", e)


def _assemble_sd3_conditioning(h_l, h_g, p_l, p_g, t5_cond=None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Penultimate CLIP-L/G hidden states concatenated and zero-padded to
    4096 features, followed by the T5 rows (in the CLIP rows' dtype, their
    features zero-padded to 4096 where a small T5 has fewer; with T5 off,
    as many zero rows as CLIP's); pooled outputs concatenated."""
    conditioning = torch.cat([h_l, h_g], dim=-1)
    pooled = torch.cat([p_l, p_g], dim=-1)
    b, s, d = conditioning.shape
    conditioning = torch.cat([conditioning, conditioning.new_zeros(b, s, 4096 - d)], dim=-1)
    if t5_cond is None:
        t5c = torch.zeros_like(conditioning)
    else:
        t5c = t5_cond.to(conditioning.dtype)
        pad = conditioning.shape[-1] - t5c.shape[-1]
        if pad > 0:
            t5c = torch.cat([t5c, t5c.new_zeros(*t5c.shape[:-1], pad)], dim=-1)
    return torch.cat([conditioning, t5c], dim=1), pooled


def _prep_conditioning(conditioning, pooled, cfg_on: bool, num_images: int, dtype):
    """The denoise batch's conditioning rows: with CFG [positive*N,
    negative*N], matching the [x, x] latent doubling; without, the positive
    row N times."""
    if cfg_on:
        if conditioning.shape[0] == 1:
            conditioning = conditioning.repeat(2, 1, 1)
            pooled = pooled.repeat(2, 1)
        if num_images > 1:
            conditioning = conditioning.repeat_interleave(num_images, dim=0)
            pooled = pooled.repeat_interleave(num_images, dim=0)
    else:
        conditioning, pooled = conditioning[:1], pooled[:1]
        if num_images > 1:
            conditioning = conditioning.repeat(num_images, 1, 1)
            pooled = pooled.repeat(num_images, 1)
    return conditioning.to(dtype), pooled.to(dtype)


def _chunk_cond(cond, pooled, i: int, j: int, n: int, cfg_on: bool):
    """Images i..j of an n-image batch's conditioning rows, the CFG layout
    [positive, negative] kept within the chunk."""
    if cfg_on:
        return (torch.cat([cond[i:j], cond[n + i : n + j]]),
                torch.cat([pooled[i:j], pooled[n + i : n + j]]))
    return cond[i:j], pooled[i:j]


class DiffusionPipeline:
    """SD3-family (SD3-medium, SD3.5-large) txt2img and img2img with the
    reference's public surface:
    ``generate_image(text, num_steps, cfg_weight, negative_text,
    latent_size, seed, verbose, image_path, denoise, num_images, guidance,
    profile_dir)``, ``generate_images_batched`` and the ``encode_text`` /
    ``encode_image_to_latents`` / ``denoise_latents`` phase methods.
    ``use_scan`` (default True) runs the denoise schedule as the
    reference's scan, a CUDA graph of one step on the card;
    ``use_scan=False`` the per-step synced loop (module docstring).
    ``w16`` (default on) loads every model's float weights in bf16, else
    fp32; ``a16`` selects bf16 VAE activations; ``shift=3.0`` is the SD3
    production schedule. ``load`` and ``low_memory_mode`` (both on by
    default, as in the reference) load the models from their checkpoints
    and drop each after its phase (module docstring).
    ``quantize_mmdit`` (module docstring) converts the assigned or loaded
    MMDiT; weight-only modes pack at group ``quantize_group_size`` (the
    reference's quantize-at-load: GPTQ for int4 and w4a8 by default).
    ``model_version`` (default SD3-medium) and ``use_t5`` (default on, as
    the reference's; ``t5`` and ``t5_tokenizer`` must then be
    assigned, the tokenizer built with ``t5_max_length`` tokens) add the T5
    rows to the conditioning: 77 CLIP + 512 T5 tokens for SD3 and SD3.5.
    ``quantize_t5``: the w8a8 T5 (module docstring). ``local_ckpt``: the
    checkpoint file the MMDiT, the VAE decoder and the VAE encoder (at the
    first img2img request) are loaded from, as the reference's
    ``local_ckpt``.

    ``sdpa_impl`` (None/'auto', 'xla', 'flash' or 'ring') and ``mesh`` (a
    ``parallel.create_mesh`` / ``local_mesh`` DeviceMesh) go to every MMDiT
    attention, as in the reference: ``sdpa_impl="ring"`` runs context-
    parallel ring attention over the mesh's model axis. Under the mesh the
    MMDiT and the T5 are sharded over its ``model`` axis and the image
    batch split over its ``data`` axis (module docstring); a one-rank mesh
    runs as no mesh does."""

    clip_g_needed = True
    t5_forced = False

    def __init__(
        self,
        w16: bool = True,
        shift: float = 3.0,
        use_t5: bool = True,
        model_version: str = SD3_MEDIUM,
        low_memory_mode: bool = True,
        a16: bool = True,
        load: bool = True,
        device="cuda",
        quantize_mmdit=False,
        quantize_t5: bool = False,
        quantize_group_size: int = 32,
        sdpa_impl: Optional[str] = None,
        mesh=None,
        use_scan: bool = True,
        local_ckpt: Optional[str] = None,
    ):
        if model_version not in T5_MAX_LENGTH:
            raise ValueError(f"model_version={model_version!r}: one of {sorted(T5_MAX_LENGTH)}")
        self.model_version = model_version
        self.local_ckpt = local_ckpt
        self.use_t5 = use_t5 or self.t5_forced
        self.quantize_t5 = quantize_t5
        self.quant_mode, self.quant_mixed = parse_quant_mode(quantize_mmdit)
        self.sdpa_impl = sdpa_impl
        self.mesh = mesh
        self.use_scan = use_scan
        self._scans: Dict[tuple, _Scan] = {}
        self.device = torch.device(device)
        self.dtype = torch.bfloat16 if w16 else torch.float32
        self.low_memory_mode = low_memory_mode
        self.activation_dtype = torch.bfloat16 if a16 else torch.float32
        self.sampler: FlowSchedule = ModelSamplingDiscreteFlow(shift=shift)
        self.latent_format = SD3LatentFormat()
        self.quantize_group_size = quantize_group_size
        self._mmdit: Optional[MMDiT] = None
        self.decoder: Optional[VAEDecoder] = None
        self.encoder: Optional[VAEEncoder] = None
        self.clip_l: Optional[CLIPTextModel] = None
        self.clip_g: Optional[CLIPTextModel] = None
        self.tokenizer_l = None
        self.tokenizer_g = None
        self.t5_tokenizer = None
        self._t5: Optional[T5Encoder] = None
        self.quantizer: Optional[Dict[str, Any]] = None
        if load:
            if low_memory_mode:
                self.load_text_encoders()
            else:
                self.check_and_load_models()

    @property
    def t5_max_length(self) -> int:
        """The T5 token rows of this model version (``T5_MAX_LENGTH``)."""
        return T5_MAX_LENGTH[self.model_version]

    @property
    def t5(self) -> Optional[T5Encoder]:
        return self._t5

    @t5.setter
    def t5(self, model: Optional[T5Encoder]) -> None:
        self._set_t5(model)

    def _set_t5(self, model: Optional[T5Encoder], cache: Optional[Path] = None) -> None:
        """The T5, converted for ``quantize_t5``, filed whole in ``cache``
        (if given) and sharded over the mesh's model axis."""
        if model is not None and self.quantize_t5 and not _holds(model, W8A8Linear):
            # In place on the model's device: the SmoothQuant fold first
            # (exact in float), then every eligible linear to w8a8.
            if os.environ.get("DIFFUSIONKIT_TPU_T5_SMOOTH", "1") != "0":
                smooth_t5(model, self.t5_tokenizer)
            w8a8_module_(model)
        if model is not None and cache is not None:
            _save_cache(model, cache)
        if model is not None:
            self._shard(model)
        self._t5 = model

    @property
    def mmdit(self) -> Optional[MMDiT]:
        return self._mmdit

    @mmdit.setter
    def mmdit(self, model: Optional[MMDiT]) -> None:
        self._set_mmdit(model)

    def _set_mmdit(self, model: Optional[MMDiT], cache: Optional[Path] = None) -> None:
        """The MMDiT, converted for ``quantize_mmdit``, filed whole in
        ``cache`` (if given) and sharded over the mesh's model axis; the
        captured graphs dropped."""
        if model is not None and self.quant_mode:
            t0 = time.perf_counter()
            name = self._quantize(model)
            _sync(self.device)
            self.quantizer = {"name": name, "seconds": time.perf_counter() - t0}
        if model is not None and cache is not None:
            if self.quantizer["name"] != "gptq" and "_gptq1_" in cache.name:
                cache = cache.with_name(cache.name.replace("_gptq1_", "_gptq0_"))
            _save_cache(model, cache)
        if model is not None:
            self._shard(model)
        self._scans.clear()  # the graphs captured the old model's weights
        self._mmdit = model

    # -- the mesh -----------------------------------------------------------------

    def _model_split(self) -> bool:
        """Whether the mesh splits the MMDiT and the T5 (a model axis of
        more than one rank)."""
        return axis_size(self.mesh, "model") > 1

    def _shard(self, model: torch.nn.Module) -> None:
        """``model`` sharded over the mesh's model axis, on the device (in
        place); nothing without such an axis."""
        if self._model_split():
            shard_module_(model, self.mesh, self.device)

    def _host_or_device(self) -> torch.device:
        """Where a model read from a file lands first: the host where the
        mesh splits it (only the rank's slices go to the device), else
        the device."""
        return torch.device("cpu") if self._model_split() else self.device

    def _data_rows(self, n: int) -> Tuple[int, int]:
        """This data rank's contiguous chunk [lo, hi) of n images: the
        first n mod d ranks one more (``np.array_split``'s chunks)."""
        d, r = axis_size(self.mesh, "data"), axis_index(self.mesh, "data")
        q, rem = divmod(n, d)
        lo = r * q + min(r, rem)
        return lo, lo + q + (r < rem)

    def _gather_images(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """Every data rank's chunk of the n images (``_data_rows``)
        gathered in order, on every rank; chunks padded to the largest
        for the all-gather and cut after it."""
        d = axis_size(self.mesh, "data")
        if d == 1:
            return x
        per = -(-n // d)
        if x.shape[0] < per:
            x = torch.cat([x, x.new_zeros(per - x.shape[0], *x.shape[1:])])
        parts = all_gather(x, 0, group(self.mesh, "data")).split(per)
        sizes = [n // d + (r < n % d) for r in range(d)]
        return torch.cat([part[:size] for part, size in zip(parts, sizes)])

    def _quantize(self, model: MMDiT) -> str:
        """``model`` converted in place for ``quantize_mmdit``; the name of
        the quantizer that ran (``quantizer``)."""
        mode = self.quant_mode
        if mode == "w8a8":
            # Float and packed linears alike (the reference's w8a8_tree also
            # re-expresses a 4-bit checkpoint); the -mixed overrides do not
            # apply to w8a8, as in the reference.
            w8a8_module_(model)
            return "w8a8"
        # A model that holds packed linears is a pre-quantized one (the MLX
        # 4-bit file, a random packed init or the cache): it passes through,
        # as the reference skips quantize_tree for such checkpoints.
        name = "packed"
        if not _holds(model, (QuantizedLinear, W8A8Linear)):
            bits = 8 if mode == "int8" else 4
            overrides = MIXED_OVERRIDES if self.quant_mixed else None
            name = None
            if bits == 4 and os.environ.get("DIFFUSIONKIT_TPU_GPTQ", "1") != "0":
                # GPTQ swaps linears in place, layer by layer: the float
                # ones it may replace are kept on the host, so a failure
                # partway puts the whole float model on the ALS grid, as
                # the reference's functional fallback does.
                kept = _host_linears(model, self.quantize_group_size)
                try:
                    gptq_quantize_mmdit(model, bits=4, group_size=self.quantize_group_size,
                                        overrides=overrides)
                    name = "gptq"
                except Exception as e:
                    if _device_error(e):
                        raise
                    logger.warning("GPTQ quantization failed (%s); falling back to the ALS grid",
                                   e)
                    gc.collect()
                    _restore_linears(kept, self.device)
                del kept
            if name is None:
                quantize_module_(model, self.quantize_group_size, bits=bits, overrides=overrides)
                name = "als" if refine_default(bits) else "minmax"
        if mode == "w4a8":
            add_wscale_(model)
        return name

    # -- loading models ---------------------------------------------------------

    def _mode_tag(self) -> str:
        return self.quant_mode + ("-mixed" if self.quant_mixed else "")

    def _dtype_name(self) -> str:
        return str(self.dtype).replace("torch.", "")

    def _mmdit_cache(self) -> Optional[Path]:
        """The quantized MMDiT's cache file (the reference's tag), or None
        when nothing is quantized, the cache is off or the source is not
        resolved."""
        if not self.quant_mode:
            return None
        refine = os.environ.get("DIFFUSIONKIT_TPU_QUANT_REFINE", "1")
        gptq = "1" if os.environ.get("DIFFUSIONKIT_TPU_GPTQ", "1") != "0" else "0"
        tag = (f"mmdit_{self.model_version}_{self._mode_tag()}_g{self.quantize_group_size}"
               f"_{self._dtype_name()}_q{QUANT_VERSION}_r{refine}_gptq{gptq}")
        try:
            src = model_io._resolve(self.model_version, model_io.MMDIT_CKPT[self.model_version],
                                    self.local_ckpt)
            return model_io.quant_cache_path(tag, src)
        except Exception as e:
            logger.info("no quantized-MMDiT cache (%s)", e)
            return None

    def load_mmdit(self) -> None:
        """The MMDiT from ``model_version``'s checkpoint (``local_ckpt``
        first), in ``w16``'s dtype, on the device, through the ``mmdit``
        setter (which quantizes it for ``quantize_mmdit``). With
        ``quantize_mmdit`` the cache is read first and written after a
        conversion."""
        cache = self._mmdit_cache()
        if cache is not None and cache.exists():
            logger.info("Loading quantized MMDiT from cache %s", cache)
            t0 = time.perf_counter()
            model = model_io.load_mmdit_cache(cache, self.model_version, self.dtype,
                                              device=self._host_or_device())
            if model is not None:
                self.mmdit = model
                _sync(self.device)
                self.quantizer = {"name": "cached", "seconds": time.perf_counter() - t0}
                return
        # A conversion runs on the whole model on the device, then shards.
        device = self.device if self.quant_mode else self._host_or_device()
        model, _ = model_io.load_mmdit(self.model_version, self.dtype, self.local_ckpt,
                                       device=device)
        self._set_mmdit(model, cache)

    def load_decoder(self) -> None:
        """The VAE decoder, in ``w16``'s dtype (its activations in ``a16``'s)."""
        self.decoder = model_io.load_vae_decoder(self.model_version, self.dtype, self.local_ckpt,
                                                 device=self.device)

    def load_text_encoders(self) -> None:
        """CLIP-L, CLIP-G (where the pipeline reads it), T5 with ``use_t5``
        and their tokenizers, each where its attribute is None; the T5
        tokenizer before the T5, whose setter may calibrate with it."""
        if self.clip_l is None:
            self.clip_l, _ = model_io.load_text_encoder("clip_l", self.dtype, device=self.device)
        if self.tokenizer_l is None:
            self.tokenizer_l = model_io.load_tokenizer("l", pad_with_eos=True)
        if self.clip_g_needed:
            if self.clip_g is None:
                self.clip_g, _ = model_io.load_text_encoder("clip_g", self.dtype,
                                                            device=self.device)
            if self.tokenizer_g is None:
                self.tokenizer_g = model_io.load_tokenizer("g", pad_with_eos=False)
        if self.use_t5:
            if self.t5_tokenizer is None:
                self.t5_tokenizer = model_io.load_t5_tokenizer(self.t5_max_length)
            if self.t5 is None:
                self.load_t5()

    def _t5_cache(self) -> Optional[Path]:
        """The w8a8 T5's cache file (the reference's tag), or None."""
        if not self.quantize_t5:
            return None
        smooth = "smooth" if os.environ.get("DIFFUSIONKIT_TPU_T5_SMOOTH", "1") != "0" else "plain"
        tag = f"t5_w8a8_{smooth}_{self._dtype_name()}_q{QUANT_VERSION}"
        try:
            return model_io.quant_cache_path(tag, model_io._resolve_aux(model_io.AUX_FILES["t5"]))
        except Exception as e:
            logger.info("no quantized-T5 cache (%s)", e)
            return None

    def load_t5(self) -> None:
        """T5-XXL from its file through the ``t5`` setter; under
        ``quantize_t5`` from the cache when it is there, else converted and
        then cached."""
        cache = self._t5_cache()
        if cache is not None and cache.exists():
            logger.info("Loading quantized T5 from cache %s", cache)
            model = model_io.load_t5_cache(cache, self.dtype, device=self._host_or_device())
            if model is not None:
                self.t5 = model
                return
        device = self.device if self.quantize_t5 else self._host_or_device()
        self._set_t5(model_io.load_t5_encoder(self.dtype, device=device), cache)

    def check_and_load_models(self) -> None:
        """Every model the pipeline runs, where it is None."""
        if self.mmdit is None:
            self.load_mmdit()
        if self.decoder is None:
            self.load_decoder()
        self.load_text_encoders()

    def unload_t5(self) -> None:
        """Drop the T5 and its tokenizer, and encode without T5 from now on."""
        self.t5 = None
        self.t5_tokenizer = None
        gc.collect()
        self.use_t5 = False

    def ensure_models_are_loaded(self) -> None:
        """Wait until every copy of weights to the device has finished."""
        _sync(self.device)

    def _drop(self, *names: str) -> None:
        """Under ``low_memory_mode``, the named models set to None (their
        device memory freed with the last reference)."""
        if self.low_memory_mode:
            for name in names:
                setattr(self, name, None)
            gc.collect()

    def _load_for(self, name: str, load) -> float:
        """``load()`` if the model ``name`` is None; its seconds (device
        copies finished), or 0.0."""
        if getattr(self, name) is not None:
            return 0.0
        t0 = time.perf_counter()
        load()
        _sync(self.device)
        return time.perf_counter() - t0

    # -- text encoding -------------------------------------------------------

    @torch.inference_mode()
    def encode_text(self, text: str, cfg_weight: float = 7.5, negative_text: str = ""):
        neg = negative_text if cfg_weight > 1 else None
        if self.use_t5 and (self.t5 is None or self.t5_tokenizer is None):
            raise ValueError("use_t5=True: assign t5 and t5_tokenizer (or pass use_t5=False)")
        outs = []
        for tokenizer, clip in ((self.tokenizer_l, self.clip_l), (self.tokenizer_g, self.clip_g)):
            tokens = torch.from_numpy(tokenize_batch(tokenizer, text, neg)).to(
                self.device, torch.long
            )
            outs.append(clip(tokens))
        out_l, out_g = outs
        t5_cond = None
        if self.use_t5:
            tokens = tokenize_batch(self.t5_tokenizer, text, neg)
            t5_cond = self.t5(torch.from_numpy(tokens).to(self.device, torch.long))
        return _assemble_sd3_conditioning(
            out_l.hidden_states[-2], out_g.hidden_states[-2],
            out_l.pooled_output, out_g.pooled_output, t5_cond,
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

    def max_denoise(self, sigmas) -> bool:
        return self.sampler.max_denoise(sigmas)

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
        image_path: Optional[str] = None,
        denoise: float = 1.0,
        num_images: int = 1,
        guidance: Optional[float] = None,
    ) -> Tuple[torch.Tensor, List[float]]:
        """The denoised latents (num_images, H, W, C) and ``iter_time``.
        With ``image_path`` (img2img) the latents start from the image's
        (``encode_image_to_latents``, at the image's size) and the schedule
        runs from its sigma ``int(num_steps * (1 - denoise))`` on; without,
        ``denoise`` is 1.
        ``guidance``: FLUX-dev's distilled guidance scale (3.5 when not
        given); ignored by models without a guidance embedding."""
        seed = int(time.time()) if seed is None else int(seed)
        logger.info("Seed: %s", seed)
        # The starting latents in host numpy, as in the reference: the
        # encoded image comes back from the device once.
        if image_path is None:
            denoise = 1.0
            x_T = self.get_empty_latent(*latent_size)
        else:
            x_T = self.encode_image_to_latents(image_path, seed=seed).cpu().numpy()
            x_T = self.latent_format.process_in(x_T)
        if num_images > 1:
            x_T = np.tile(x_T, (num_images, 1, 1, 1))
        # The batch's noise in one seeded call: numpy fills C-order, so
        # image 0's noise is the num_images=1 run's.
        noise = self.get_noise(seed, x_T)
        sigmas = self.get_sigmas(num_steps)[int(num_steps * (1 - denoise)):]
        noise_scaled = np.asarray(
            self.sampler.noise_scaling(
                sigmas[0], noise, x_T, self.max_denoise(sigmas)
            ),
            np.float32,
        )
        cfg_on = cfg_weight > 1
        # This data rank's images; every rank drew the whole batch's noise.
        lo, hi = self._data_rows(num_images)
        conditioning, pooled_conditioning = _prep_conditioning(
            conditioning, pooled_conditioning, cfg_on, hi - lo, self.mmdit.config.dtype
        )
        g = None
        if self.mmdit.config.guidance_embed:
            g = 3.5 if guidance is None else guidance
        x0 = torch.from_numpy(noise_scaled[lo:hi]).to(self.device)
        n_iter = len(sigmas) - 1
        if hi == lo:  # more data ranks than images: nothing to denoise here
            x, iter_time = x0, [0.0] * n_iter
        elif self.use_scan:
            t0 = time.perf_counter()
            # The chunk size follows the latent_size argument, not an
            # img2img image's own size, as in the reference.
            x = self._run_denoise_chunks(
                lambda x, c, p: self._denoise_scan(x, sigmas, c, p, cfg_weight, g, cfg_on),
                x0, conditioning, pooled_conditioning, hi - lo,
                self._denoise_chunk_images(latent_size), cfg_on,
            )
            _sync(self.device)
            iter_time = [round((time.perf_counter() - t0) / max(n_iter, 1), 4)] * n_iter
        else:
            x, iter_time = self._denoise_loop(x0, sigmas, conditioning, pooled_conditioning,
                                              cfg_weight, g, cfg_on)
        return self.latent_format.process_out(self._gather_images(x, num_images)), iter_time

    def _scan(self, x, conditioning, pooled, guidance, n_sigmas: int, cfg_on: bool) -> _Scan:
        """The cached schedule for these inputs, made (and on the card
        captured at its first run) when none fits."""
        key = (
            self.mmdit.config, cfg_on, self.sdpa_impl, id(self.mesh),
            tuple(x.shape), x.dtype, tuple(conditioning.shape), conditioning.dtype,
            tuple(pooled.shape), pooled.dtype, guidance is not None,
            os.environ.get("DIFFUSIONKIT_TPU_SDPA"), os.environ.get("DIFFUSIONKIT_TPU_ATTN_LAYOUT"),
            torch.backends.cuda.matmul.allow_tf32,
        )
        scan = self._scans.get(key)
        if scan is None or scan.n_sigmas < n_sigmas:
            capture = self.mesh is None or self.mesh.size() == 1
            if not capture and x.device.type == "cuda":
                logger.info("mesh of %d ranks: the denoise step runs uncaptured (NCCL inside a "
                            "CUDA graph capture waits for a machine with two cards)",
                            self.mesh.size())
            scan = _Scan(self.mmdit, x, conditioning, pooled, guidance, n_sigmas, cfg_on,
                         self.sdpa_impl, self.mesh, capture)
            self._scans[key] = scan
        return scan

    def _denoise_scan(self, x, sigmas: np.ndarray, conditioning, pooled, cfg_weight: float,
                      guidance: Optional[float], cfg_on: bool) -> torch.Tensor:
        """The reference's ``_denoise_scan``: the whole schedule with no
        host synchronisation; on the card the cached step graph replayed
        once a step. Returns new latents (the buffers stay the graph's)."""
        scan = self._scan(x, conditioning, pooled, guidance, len(sigmas), cfg_on)
        scan.load(x, conditioning, pooled, cfg_weight, guidance, sigmas)
        scan.run(len(sigmas) - 1)
        return scan.x.clone()

    def _denoise_loop(self, x, sigmas: np.ndarray, conditioning, pooled, cfg_weight: float,
                      guidance: Optional[float], cfg_on: bool) -> Tuple[torch.Tensor, List[float]]:
        """``use_scan=False``: the same step body, uncaptured, the whole
        batch at once, with a device synchronisation and a time each step."""
        scan = _Scan(self.mmdit, x, conditioning, pooled, guidance, len(sigmas), cfg_on,
                     self.sdpa_impl, self.mesh, capture=False)
        scan.load(x, conditioning, pooled, cfg_weight, guidance, sigmas)
        iter_time: List[float] = []
        for _ in range(len(sigmas) - 1):
            t0 = time.perf_counter()
            scan.step()
            _sync(self.device)
            iter_time.append(time.perf_counter() - t0)
        return scan.x, iter_time

    def _denoise_chunk_images(self, latent_size: Tuple[int, int]) -> int:
        """Images per denoise sub-batch (the activation-budget auto-split):
        the reference's budget of 4 512² images on a 16 GB chip, scaled by
        the card's memory (``utils.hbm_scale``): 21 images at 512² and 5 at
        1024² on an 80 GB H100. Under a mesh no split (the reference shards
        the batch there). ``DIFFUSIONKIT_TPU_DENOISE_BATCH`` overrides it;
        the chunks run the same step, so the result does not depend on it
        beyond the GEMMs' batch size."""
        env = os.environ.get("DIFFUSIONKIT_TPU_DENOISE_BATCH")
        if env:
            return max(1, int(env))
        if self.mesh is not None:
            return 1 << 30
        h, w = latent_size
        return max(1, int(128 * 128 * hbm_scale(self.device)) // (h * w))

    def _run_denoise_chunks(self, run_chunk, x0, cond, pooled, n: int, per: int, cfg_on: bool):
        """Sub-batches of ``per`` images through ``run_chunk`` in turn, each
        with its conditioning rows (``_chunk_cond``); a ragged last chunk
        runs at its own shape."""
        if n <= per:
            return run_chunk(x0, cond, pooled)
        logger.info(
            "denoise batch %d exceeds the %d-image activation budget; "
            "splitting into %d chunks", n, per, -(-n // per),
        )
        outs = []
        for i in range(0, n, per):
            j = min(i + per, n)
            c, p = _chunk_cond(cond, pooled, i, j, n, cfg_on)
            outs.append(run_chunk(x0[i:j], c, p))
        return torch.cat(outs)

    # -- encoding a source image (img2img) ------------------------------------

    def read_image(self, image_path: str) -> np.ndarray:
        """The image as host fp32 (1, H, W, 3) in [-1, 1], its sides cut
        down to a multiple of 64 by a LANCZOS resize, alpha dropped."""
        from PIL import Image

        img = Image.open(image_path)
        w, h = (dim - dim % 64 for dim in (img.width, img.height))
        if w != img.width or h != img.height:
            logger.warning("Image shape not divisible by 64, downsampling to %dx%d", w, h)
            img = img.resize((w, h), Image.LANCZOS)
        arr = np.asarray(img)[:, :, :3].astype(np.float32) / 255 * 2 - 1
        return arr[None]

    @torch.inference_mode()
    def encode_image_to_latents(self, image_path: str, seed: int) -> torch.Tensor:
        """A sample of the encoder's latent distribution of the image, on
        the device in fp32, (1, H/8, W/8, 16). The encoder runs in fp32
        whatever ``a16`` says; it is loaded from the model's checkpoint
        when none is assigned. The noise is drawn with ``seed``, the seed of
        the denoise noise, as in the reference."""
        if self.encoder is None:
            self.encoder = model_io.load_vae_encoder(self.model_version, torch.float32,
                                                     self.local_ckpt, device=self.device)
        image = self.read_image(image_path)
        b, h, w, _ = image.shape
        noise = self.get_noise(seed, np.zeros((b, h // 8, w // 8, 16), np.float32))
        return _encode_step(self.encoder, torch.from_numpy(image).to(self.device),
                            torch.from_numpy(noise).to(self.device))

    # -- decoding ------------------------------------------------------------

    @torch.inference_mode()
    def decode_latents_to_image(self, x_t: torch.Tensor) -> torch.Tensor:
        """Pixels in [0, 1] (N, H, W, 3) on the device: the VAE decoder in
        the activation dtype, then ``clip(x / 2 + 0.5, 0, 1)`` (the
        reference's ``_decode_step``)."""
        x = self.decoder(x_t.to(self.activation_dtype))
        return torch.clamp(x / 2 + 0.5, 0.0, 1.0)

    @torch.inference_mode()
    def decode_latents_to_u8(self, latents: torch.Tensor) -> torch.Tensor:
        """uint8 pixels (N, H, W, 3) decoded on the device:
        ``floor(decode_latents_to_image(latents) * 255)``."""
        return torch.floor(self.decode_latents_to_image(latents) * 255.0).to(torch.uint8)

    def _decode_batched_u8(self, latents: torch.Tensor) -> np.ndarray:
        """A batch decoded in chunks of one 1024² image's area (the VAE's
        activations grow with batch x resolution); a ragged last chunk
        decodes at its own shape. Host uint8 (N, H, W, 3)."""
        n, h, w, _ = latents.shape
        per = max(1, (128 * 128) // (h * w))
        if n <= per:
            return self.decode_latents_to_u8(latents).cpu().numpy()
        return np.concatenate([self.decode_latents_to_u8(latents[i : i + per]).cpu().numpy()
                               for i in range(0, n, per)])

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
        image_path: Optional[str] = None,
        denoise: float = 1.0,
        num_images: int = 1,
        guidance: Optional[float] = None,
        profile_dir: Optional[str] = None,
    ):
        """txt2img, or img2img from ``image_path`` with ``denoise`` (the
        share of the schedule that runs; the encode is part of the
        denoising phase, as in the reference); returns (PIL image, phase
        log), or with ``num_images`` > 1 (a list of PIL images, phase log).
        ``profile_dir``: a ``torch.profiler`` trace of the denoise phase
        written there. Models are loaded before their phases and, under
        ``low_memory_mode``, dropped after them (module docstring); each
        phase's ``load_time`` and the denoise's ``capture_time`` (the
        graph's warm-up step and capture, 0 when a cached graph ran) are in
        the log, in seconds."""
        from PIL import Image

        start_time = time.perf_counter()
        if latent_size[0] % 2 or latent_size[1] % 2:
            raise ValueError("Latent sizes must be divisible by 2 (patch size)")
        t0 = time.perf_counter()
        if self.low_memory_mode:
            self.load_text_encoders()
        else:
            self.check_and_load_models()
        _sync(self.device)
        log: Dict[str, Any] = {
            "text_encoding": {"pre": self._mem(), "post": {}, "time": None,
                              "load_time": time.perf_counter() - t0},
            "denoising": {"pre": {}, "post": {}, "time": None, "iter_time": [],
                          "load_time": 0.0, "capture_time": 0.0},
            "decoding": {"pre": {}, "post": {}, "time": None, "load_time": 0.0},
            "peak_memory": 0.0,
        }

        # The memory snapshots stay outside the timed windows.
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
        self._drop("t5", "clip_l", "clip_g")

        self.quantizer = None
        log["denoising"]["load_time"] = self._load_for("mmdit", self.load_mmdit)
        if self.quantizer is not None:
            log["denoising"]["quantizer"] = self.quantizer["name"]
            log["denoising"]["quantize_time"] = self.quantizer["seconds"]
        log["denoising"]["pre"] = self._mem()
        capture_s = StepGraph.capture_s
        t0 = time.perf_counter()
        prof = self._start_profile(profile_dir)
        latents, iter_time = self.denoise_latents(
            conditioning, pooled, num_steps=num_steps, cfg_weight=cfg_weight,
            latent_size=latent_size, seed=seed, image_path=image_path, denoise=denoise,
            num_images=num_images, guidance=guidance,
        )
        if prof is not None:
            _sync(self.device)
            prof.stop()
            logger.info("Profiler trace written to %s", profile_dir)
        log["denoising"]["iter_time"] = iter_time
        phase_end("denoising", t0)
        log["denoising"]["capture_time"] = StepGraph.capture_s - capture_s
        self._drop("mmdit")

        log["decoding"]["load_time"] = self._load_for("decoder", self.load_decoder)
        log["decoding"]["pre"] = self._mem()
        t0 = time.perf_counter()
        x = self._decode_batched_u8(latents)
        phase_end("decoding", t0)
        self._drop("decoder")

        log["total_time"] = time.perf_counter() - start_time
        if verbose:
            logger.info("Total time: %.3fs, peak memory %.3f GB",
                        log["total_time"], log["peak_memory"])
        if x.shape[0] == 1:
            return Image.fromarray(x[0]), log
        return [Image.fromarray(im) for im in x], log

    def _start_profile(self, profile_dir: Optional[str]):
        """A started ``torch.profiler`` that writes its trace into
        ``profile_dir`` when stopped (the host, and the card's kernels on
        CUDA), or None."""
        if not profile_dir:
            return None
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts, on_trace_ready=tensorboard_trace_handler(profile_dir))
        prof.start()
        return prof

    # -- multi-prompt batched generation (serving) -----------------------------

    @torch.inference_mode()
    def generate_images_batched(
        self,
        texts: List[str],
        num_steps: int = 4,
        cfg_weight: float = 0.0,
        negative_texts: Optional[List[str]] = None,
        latent_size: Tuple[int, int] = (64, 64),
        seeds: Optional[List[Optional[int]]] = None,
        guidance: Optional[float] = None,
    ):
        """N different prompts in one denoise schedule (the model batch
        [pos*N, neg*N], as the CFG layout), each with its own seed: the
        serving fast path. The batch auto-splits as ``denoise_latents``
        does and decodes in chunks; models load and drop as in
        ``generate_image``. Returns a list of N PIL images."""
        from PIL import Image

        n = len(texts)
        negative_texts = negative_texts or [""] * n
        seeds = seeds if seeds is not None else [None] * n
        seeds = [int(time.time()) + i if s is None else int(s) for i, s in enumerate(seeds)]
        if self.low_memory_mode:
            self.load_text_encoders()
        else:
            self.check_and_load_models()
        # This data rank's prompts (module docstring), encoded here only.
        lo, hi = self._data_rows(n)
        conds, pooleds = [], []
        for t, neg in zip(texts[lo:hi], negative_texts[lo:hi]):
            c, p = self.encode_text(t, cfg_weight, neg)
            conds.append(c)
            pooleds.append(p)
        self._drop("t5", "clip_l", "clip_g")
        cfg_on = cfg_weight > 1

        self._load_for("mmdit", self.load_mmdit)
        x_T1 = self.get_empty_latent(*latent_size)
        noise = np.concatenate([self.get_noise(s, x_T1) for s in seeds])
        sigmas = self.get_sigmas(num_steps)
        noise_scaled = np.asarray(
            self.sampler.noise_scaling(
                sigmas[0], noise, np.tile(x_T1, (n, 1, 1, 1)), self.max_denoise(sigmas)
            ),
            np.float32,
        )
        g = None
        if self.mmdit.config.guidance_embed:
            g = 3.5 if guidance is None else guidance
        dtype = self.mmdit.config.dtype
        x = torch.from_numpy(noise_scaled[lo:hi]).to(self.device)
        if hi > lo:
            if cfg_on:
                # [pos rows..., neg rows...] to match the [x, x] latent doubling.
                conditioning = torch.cat([c[:1] for c in conds] + [c[1:2] for c in conds])
                pooled = torch.cat([p[:1] for p in pooleds] + [p[1:2] for p in pooleds])
            else:
                conditioning = torch.cat([c[:1] for c in conds])
                pooled = torch.cat([p[:1] for p in pooleds])
            x = self._run_denoise_chunks(
                lambda x0, c, p: self._denoise_scan(x0, sigmas, c, p, cfg_weight, g, cfg_on),
                x, conditioning.to(dtype), pooled.to(dtype), hi - lo,
                self._denoise_chunk_images(latent_size), cfg_on,
            )
        self._drop("mmdit")
        latents = self.latent_format.process_out(self._gather_images(x, n))
        self._load_for("decoder", self.load_decoder)
        images = [Image.fromarray(im) for im in self._decode_batched_u8(latents)]
        self._drop("decoder")
        return images


class FluxPipeline(DiffusionPipeline):
    """FLUX.1 txt2img and img2img: CLIP-L pooled output and T5 token embeddings (no
    CLIP-G, T5 always on), positive row only, T5 tokens zero-padded to
    ``t5_max_length`` (by ``model_version``: 256 for FLUX.1-schnell, the
    default, 512 for FLUX.1-dev); the FLUX sigma schedule (``shift=1.0``)
    and latent format. ``quantize_t5``: the w8a8 T5 with its SmoothQuant
    fold (module docstring)."""

    clip_g_needed = False
    t5_forced = True

    def __init__(
        self,
        w16: bool = True,
        shift: float = 1.0,
        use_t5: bool = True,
        model_version: str = FLUX_SCHNELL_VERSION,
        low_memory_mode: bool = True,
        a16: bool = True,
        load: bool = True,
        device="cuda",
        quantize_mmdit=False,
        quantize_t5: bool = False,
        quantize_group_size: int = 32,
        sdpa_impl: Optional[str] = None,
        mesh=None,
        use_scan: bool = True,
        local_ckpt: Optional[str] = None,
    ):
        super().__init__(w16=w16, shift=shift, use_t5=True, model_version=model_version,
                         low_memory_mode=low_memory_mode, a16=a16, load=load,
                         device=device, quantize_mmdit=quantize_mmdit, quantize_t5=quantize_t5,
                         quantize_group_size=quantize_group_size, sdpa_impl=sdpa_impl,
                         mesh=mesh, use_scan=use_scan, local_ckpt=local_ckpt)
        self.sampler = FluxSampler(shift=shift)
        self.latent_format = FluxLatentFormat()

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
