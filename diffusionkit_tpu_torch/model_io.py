"""Checkpoint I/O, the VAE half: safetensors -> the port's VAE modules.

Counterpart of the VAE parts of ``diffusionkit_tpu/model_io.py``: the
per-version file and prefix tables, a safetensors reader, the hub download
with its offline error, the resolver (``local_ckpt``, then
``DIFFUSIONKIT_TPU_CKPT_DIR``, then the hub), and the VAE mappers with
their loaders:

  vae_decoder_from_ckpt / vae_encoder_from_ckpt   the raw sgm namespace
      (``decoder.up.N`` / ``encoder.down.N``, under ``first_stage_model.``
      in the SD3 files, unprefixed in FLUX's ``ae.safetensors``)
  autoencoder_from_diffusers_ckpt                 HF diffusers AutoencoderKL
      (``to_q`` or the legacy ``query`` spellings, projections stored as
      linears or 1x1 convolutions, ``up_blocks`` in application order)

The checkpoints are torch-layout already (OIHW convolutions, (out, in)
linears), so a mapper renames keys and squeezes 1x1 convolutions into
linears; the module is then loaded with ``strict=True``, so a missing or
extra leaf raises. A loader copies every tensor onto ``device`` (the card
unless the caller asks for the CPU) in the module's dtype. Nothing falls
back to random weights: a file that cannot be resolved raises. The MMDiT,
CLIP and T5 mappers come with their slice.
"""

from __future__ import annotations

import json
import mmap
import os
import warnings
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import torch

from .config import (
    FLUX_DEV_VERSION,
    FLUX_SCHNELL_4BIT,
    FLUX_SCHNELL_VERSION,
    SD35_LARGE,
    SD35_LARGE_4BIT,
    SD3_MEDIUM,
    AutoencoderConfig,
    VAEDecoderConfig,
    VAEEncoderConfig,
)
from .models.vae import Autoencoder, VAEDecoder, VAEEncoder
from .utils import get_logger

logger = get_logger(__name__)

StateDict = Dict[str, torch.Tensor]

# -- registry (the reference's tables, by model version) ----------------------

VAE_CKPT = {
    SD3_MEDIUM: "sd3_medium.safetensors",
    SD35_LARGE: "sd3.5_large.safetensors",
    SD35_LARGE_4BIT: "sd3.5_large_4bit_quantized.safetensors",
    FLUX_SCHNELL_VERSION: "ae.safetensors",
    FLUX_SCHNELL_4BIT: "ae.safetensors",
    FLUX_DEV_VERSION: "ae.safetensors",
}

# The VAE's key prefix inside each checkpoint.
VAE_PREFIX = {
    SD3_MEDIUM: "first_stage_model.",
    SD35_LARGE: "first_stage_model.",
    SD35_LARGE_4BIT: "first_stage_model.",
    FLUX_SCHNELL_VERSION: "",
    FLUX_SCHNELL_4BIT: "",
    FLUX_DEV_VERSION: "",
}

# The auxiliary models' files live in one hub repo; the generic
# autoencoder's rows (the VAE half of the reference's table).
AUX_REPO = "argmaxinc/stable-diffusion"
AUX_FILES = {
    "vae_config": "vae/config.json",
    "vae": "vae/diffusion_pytorch_model.safetensors",
}

# -- raw safetensors reading ---------------------------------------------------

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "U16": torch.uint16, "U32": torch.uint32,
    "U64": torch.uint64, "BOOL": torch.bool, "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}


def load_safetensors(path: Union[str, Path]) -> StateDict:
    """Every tensor of a safetensors file as a CPU tensor in the file's
    dtype (BF16 as ``torch.bfloat16``), viewing a read-only mapping of the
    file: nothing is copied until a loader copies it to its device.

    Format: an 8-byte little-endian header length, a JSON header {name:
    {dtype, shape, data_offsets}}, then the raw bytes. Each tensor holds a
    reference to the mapping, which so lives as long as any of them. The
    tensors must not be written: torch warns that the buffer is not
    writable, and that warning is silenced here."""
    with open(path, "rb") as f:
        m = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    n = int.from_bytes(m[:8], "little")
    header = json.loads(m[8 : 8 + n].decode("utf-8"))
    base = 8 + n
    out: StateDict = {}
    for k, meta in header.items():
        if k == "__metadata__":
            continue
        dtype = _ST_DTYPES[meta["dtype"]]
        o0, o1 = meta["data_offsets"]
        count = (o1 - o0) // dtype.itemsize
        if count == 0:
            out[k] = torch.empty(meta["shape"], dtype=dtype)
            continue
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="The given buffer is not writable")
            t = torch.frombuffer(m, dtype=dtype, count=count, offset=base + o0)
        out[k] = t.reshape(meta["shape"])
    return out


def hub_download(repo: str, filename: str) -> str:
    """``huggingface_hub.hf_hub_download``, with one clear error where the
    package or the network is absent."""
    try:
        from huggingface_hub import hf_hub_download

        return hf_hub_download(repo, filename)
    except Exception as e:
        raise RuntimeError(
            f"Could not fetch {repo}/{filename} from the HF Hub ({type(e).__name__}). "
            "If this host has no network access, mirror the checkpoints locally "
            "and set DIFFUSIONKIT_TPU_CKPT_DIR=<root> (layout: <repo-id>/<file>), "
            "or pass local_ckpt=/--local-ckpt for the MMDiT file."
        ) from e


def _resolve(model_version: str, filename: str, local_ckpt: Optional[str]) -> str:
    """``local_ckpt`` if given, else ``<DIFFUSIONKIT_TPU_CKPT_DIR>/<model
    version>/<filename>`` if it exists, else the hub."""
    if local_ckpt:
        return local_ckpt
    root = os.environ.get("DIFFUSIONKIT_TPU_CKPT_DIR")
    if root:
        cand = Path(root) / model_version / filename
        if cand.exists():
            return str(cand)
    return hub_download(model_version, filename)


def _resolve_aux(filename: str) -> str:
    """An auxiliary file: under ``DIFFUSIONKIT_TPU_CKPT_DIR``'s
    ``AUX_REPO`` if it exists there, else the hub."""
    root = os.environ.get("DIFFUSIONKIT_TPU_CKPT_DIR")
    if root:
        cand = Path(root) / AUX_REPO / filename
        if cand.exists():
            return str(cand)
    return hub_download(AUX_REPO, filename)


# -- mapping helpers -------------------------------------------------------------


def _strip_prefix(sd: StateDict, prefix: str) -> StateDict:
    if not prefix:
        return sd
    return {k[len(prefix) :]: v for k, v in sd.items() if k.startswith(prefix)}


def _copy(sd: StateDict, src: str, dst: str, out: StateDict) -> None:
    """``src``'s weight and bias as ``dst``'s (a convolution or a norm)."""
    out[dst + ".weight"] = sd[src + ".weight"]
    out[dst + ".bias"] = sd[src + ".bias"]


def _proj(sd: StateDict, src: str, dst: str, out: StateDict) -> None:
    """A projection stored as a Linear (out, in) or a 1x1 Conv2d (out, in,
    1, 1) -> a Linear; a missing bias is zero (the reference's None)."""
    w = sd[src + ".weight"]
    out[dst + ".weight"] = w[:, :, 0, 0] if w.ndim == 4 else w
    bias = sd.get(src + ".bias")
    out[dst + ".bias"] = torch.zeros(w.shape[0], dtype=w.dtype) if bias is None else bias


def _build(model: torch.nn.Module, sd: StateDict, device) -> torch.nn.Module:
    """``model`` (built on the meta device) on ``device`` with ``sd``
    copied in (in the module's dtype), strictly."""
    model.to_empty(device=device)
    model.load_state_dict(sd, strict=True)
    return model.eval()


# -- VAE mappers (raw sgm namespace) ---------------------------------------------


def _vae_resnet(sd: StateDict, src: str, dst: str, out: StateDict) -> None:
    for name in ("norm1", "conv1", "norm2", "conv2"):
        _copy(sd, f"{src}.{name}", f"{dst}.{name}", out)
    if src + ".nin_shortcut.weight" in sd:
        _proj(sd, src + ".nin_shortcut", dst + ".conv_shortcut", out)


def _vae_attn(sd: StateDict, src: str, dst: str, out: StateDict) -> None:
    _copy(sd, src + ".norm", dst + ".group_norm", out)
    for raw, name in (("q", "query_proj"), ("k", "key_proj"), ("v", "value_proj"),
                      ("proj_out", "out_proj")):
        _proj(sd, f"{src}.{raw}", f"{dst}.{name}", out)


def _vae_mid(sd: StateDict, out: StateDict) -> None:
    _vae_resnet(sd, "mid.block_1", "mid_blocks.0", out)
    _vae_attn(sd, "mid.attn_1", "mid_blocks.1", out)
    _vae_resnet(sd, "mid.block_2", "mid_blocks.2", out)


def vae_decoder_from_ckpt(
    sd: StateDict, config: VAEDecoderConfig = VAEDecoderConfig(), dtype=torch.float32,
    prefix: str = "decoder.", device="cuda",
) -> VAEDecoder:
    """The raw sgm VAE decoder -> VAEDecoder. The checkpoint's ``up.i`` is
    indexed from the lowest resolution, as the module's ``up_blocks``
    (applied in reverse)."""
    sd = _strip_prefix(sd, prefix)
    out: StateDict = {}
    _copy(sd, "conv_in", "conv_in", out)
    _vae_mid(sd, out)
    for i in range(len(config.block_out_channels)):
        for j in range(config.layers_per_block):
            _vae_resnet(sd, f"up.{i}.block.{j}", f"up_blocks.{i}.resnets.{j}", out)
        if f"up.{i}.upsample.conv.weight" in sd:
            _copy(sd, f"up.{i}.upsample.conv", f"up_blocks.{i}.upsample", out)
    _copy(sd, "norm_out", "conv_norm_out", out)
    _copy(sd, "conv_out", "conv_out", out)
    with torch.device("meta"):
        model = VAEDecoder(config, dtype)
    return _build(model, out, device)


def vae_encoder_from_ckpt(
    sd: StateDict, config: VAEEncoderConfig = VAEEncoderConfig(), dtype=torch.float32,
    prefix: str = "encoder.", device="cuda",
) -> VAEEncoder:
    """The raw sgm VAE encoder -> VAEEncoder."""
    sd = _strip_prefix(sd, prefix)
    out: StateDict = {}
    _copy(sd, "conv_in", "conv_in", out)
    for i in range(len(config.block_out_channels)):
        for j in range(config.layers_per_block):
            _vae_resnet(sd, f"down.{i}.block.{j}", f"down_blocks.{i}.resnets.{j}", out)
        if f"down.{i}.downsample.conv.weight" in sd:
            _copy(sd, f"down.{i}.downsample.conv", f"down_blocks.{i}.downsample", out)
    _vae_mid(sd, out)
    _copy(sd, "norm_out", "conv_norm_out", out)
    _copy(sd, "conv_out", "conv_out", out)
    with torch.device("meta"):
        model = VAEEncoder(config, dtype)
    return _build(model, out, device)


# -- generic autoencoder mapper (HF diffusers AutoencoderKL namespace) ---------


def _diffusers_resnet(sd: StateDict, src: str, dst: str, out: StateDict) -> None:
    for name in ("norm1", "conv1", "norm2", "conv2"):
        _copy(sd, f"{src}.{name}", f"{dst}.{name}", out)
    if src + ".conv_shortcut.weight" in sd:
        _proj(sd, src + ".conv_shortcut", dst + ".conv_shortcut", out)


def _diffusers_attn(sd: StateDict, src: str, dst: str, out: StateDict) -> None:
    # to_q/to_k/to_v/to_out.0 (modern diffusers), or the legacy
    # query/key/value/proj_attn spelling.
    names = (("to_q", "to_k", "to_v", "to_out.0") if src + ".to_q.weight" in sd
             else ("query", "key", "value", "proj_attn"))
    _copy(sd, src + ".group_norm", dst + ".group_norm", out)
    for raw, name in zip(names, ("query_proj", "key_proj", "value_proj", "out_proj")):
        _proj(sd, f"{src}.{raw}", f"{dst}.{name}", out)


def _diffusers_mid(sd: StateDict, side: str, out: StateDict) -> None:
    _diffusers_resnet(sd, f"{side}.mid_block.resnets.0", f"{side}.mid_blocks.0", out)
    _diffusers_attn(sd, f"{side}.mid_block.attentions.0", f"{side}.mid_blocks.1", out)
    _diffusers_resnet(sd, f"{side}.mid_block.resnets.1", f"{side}.mid_blocks.2", out)


def autoencoder_from_diffusers_ckpt(
    sd: StateDict, config: AutoencoderConfig, dtype=torch.float32, device="cuda",
) -> Autoencoder:
    """An HF diffusers AutoencoderKL checkpoint -> Autoencoder. Diffusers
    stores the decoder's ``up_blocks`` in application order (0 straight
    after the mid block); the module stores them outermost resolution
    first and applies them reversed, so the list is flipped here. The
    ``quant_conv`` / ``post_quant_conv`` 1x1 convolutions become the
    ``quant_proj`` / ``post_quant_proj`` linears."""
    n_blocks = len(config.block_out_channels)
    out: StateDict = {}
    _copy(sd, "encoder.conv_in", "encoder.conv_in", out)
    for i in range(n_blocks):
        src = f"encoder.down_blocks.{i}"
        for j in range(config.layers_per_block):
            _diffusers_resnet(sd, f"{src}.resnets.{j}", f"{src}.resnets.{j}", out)
        if f"{src}.downsamplers.0.conv.weight" in sd:
            _copy(sd, f"{src}.downsamplers.0.conv", f"{src}.downsample", out)
    _diffusers_mid(sd, "encoder", out)
    _copy(sd, "encoder.conv_norm_out", "encoder.conv_norm_out", out)
    _copy(sd, "encoder.conv_out", "encoder.conv_out", out)

    _copy(sd, "decoder.conv_in", "decoder.conv_in", out)
    _diffusers_mid(sd, "decoder", out)
    for i in range(n_blocks):
        src, dst = f"decoder.up_blocks.{i}", f"decoder.up_blocks.{n_blocks - 1 - i}"
        for j in range(config.layers_per_block + 1):
            _diffusers_resnet(sd, f"{src}.resnets.{j}", f"{dst}.resnets.{j}", out)
        if f"{src}.upsamplers.0.conv.weight" in sd:
            _copy(sd, f"{src}.upsamplers.0.conv", f"{dst}.upsample", out)
    _copy(sd, "decoder.conv_norm_out", "decoder.conv_norm_out", out)
    _copy(sd, "decoder.conv_out", "decoder.conv_out", out)

    _proj(sd, "quant_conv", "quant_proj", out)
    _proj(sd, "post_quant_conv", "post_quant_proj", out)
    with torch.device("meta"):
        model = Autoencoder(config, dtype)
    return _build(model, out, device)


# -- loaders -----------------------------------------------------------------------


def load_vae_decoder(
    model_version: str, dtype=torch.float32, local_ckpt: Optional[str] = None, device="cuda",
) -> VAEDecoder:
    """The VAE decoder of ``model_version``'s checkpoint."""
    path = _resolve(model_version, VAE_CKPT[model_version], local_ckpt)
    return vae_decoder_from_ckpt(load_safetensors(path), VAEDecoderConfig(), dtype,
                                 prefix=VAE_PREFIX[model_version] + "decoder.", device=device)


def load_vae_encoder(
    model_version: str, dtype=torch.float32, local_ckpt: Optional[str] = None, device="cuda",
) -> VAEEncoder:
    """The VAE encoder of ``model_version``'s checkpoint."""
    path = _resolve(model_version, VAE_CKPT[model_version], local_ckpt)
    encoder = vae_encoder_from_ckpt(load_safetensors(path), VAEEncoderConfig(), dtype,
                                    prefix=VAE_PREFIX[model_version] + "encoder.", device=device)
    logger.info("Loaded the VAE encoder of %s from %s", model_version, path)
    return encoder


def load_autoencoder(
    key: str = AUX_REPO, dtype=torch.float32, device="cuda",
) -> Tuple[Autoencoder, AutoencoderConfig]:
    """The generic SD autoencoder from an HF diffusers ``vae/config.json``
    and its weights under ``key`` (resolved as ``_resolve`` does, with no
    local override). The reference forces 16 latent channels whatever the
    config says; so does this."""
    with open(_resolve(key, AUX_FILES["vae_config"], None)) as f:
        cfg: Dict[str, Any] = json.load(f)
    cfg["latent_channels"] = 16
    config = AutoencoderConfig(
        in_channels=cfg["in_channels"],
        out_channels=cfg["out_channels"],
        latent_channels_out=2 * cfg["latent_channels"],
        latent_channels_in=cfg["latent_channels"],
        block_out_channels=tuple(cfg["block_out_channels"]),
        layers_per_block=cfg["layers_per_block"],
        norm_num_groups=cfg["norm_num_groups"],
        scaling_factor=cfg.get("scaling_factor", 0.18215),
    )
    sd = load_safetensors(_resolve(key, AUX_FILES["vae"], None))
    return autoencoder_from_diffusers_ckpt(sd, config, dtype, device=device), config
