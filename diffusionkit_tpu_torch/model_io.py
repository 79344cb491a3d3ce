"""Checkpoint I/O: safetensors -> the port's modules.

Counterpart of ``diffusionkit_tpu/model_io.py``: the per-version file and
prefix tables, a safetensors reader, the hub download with its offline
error, the resolver (``local_ckpt``, then ``DIFFUSIONKIT_TPU_CKPT_DIR``,
then the hub), and the mappers with their loaders:

  mmdit_from_sd3_ckpt     SD3 / SD3.5 in the raw sgm namespace
      (``model.diffusion_model.joint_blocks.N``): the fused qkv rows split
      three ways, the patch convolution folded into a linear, the last
      block's K/V-only text branch to ``mm_final.txt``, SD3.5's QK-norm
  mmdit_from_flux_ckpt    FLUX in the BFL namespace (``double_blocks`` /
      ``single_blocks``): ``linear1`` rows split at (H, 2H, 3H),
      ``linear2`` columns split into (o | fc2), the shared bias on o
  mmdit_from_mlx_ckpt     the MLX module namespace of the two 4-bit
      releases: packed linears (anywhere, embedders and the final layer
      included) repacked by a transpose of their word matrix
  clip_from_hf_ckpt / t5_from_ckpt    the HF CLIP text model and T5 encoder
  vae_decoder_from_ckpt / vae_encoder_from_ckpt   the raw sgm VAE
      (``decoder.up.N`` / ``encoder.down.N``, under ``first_stage_model.``
      in the SD3 files, unprefixed in FLUX's ``ae.safetensors``)
  autoencoder_from_diffusers_ckpt     HF diffusers AutoencoderKL

The checkpoints are torch-layout already ((out, in) linears, OIHW
convolutions), so a mapper renames keys, splits fused projections, squeezes
1x1 convolutions into linears and, for FLUX, permutes the q/k output
columns into the half-rotation RoPE layout (``_permute_qk_for_rope``). It
keeps each float tensor in the file's dtype, as a view of the file's
mapping where no split or permutation needs a copy, and the module is then
loaded with ``strict=True``, so a missing or extra leaf raises; the copy
into the module casts to its dtype (round to nearest even, as the
reference's host cast). The MMDiT holds a ``QuantizedLinear`` wherever the
file holds packed leaves. Loaders build on ``device`` (the card unless the
caller asks for the CPU). Nothing falls back to random weights: a file that
cannot be resolved raises.

The reference's disk cache of quantized models (``quant_cache_path``,
``save_module_cache``, ``load_mmdit_cache``, ``load_t5_cache``, the section
at the end) keeps a packed model's state dict, written by
``save_safetensors``.
"""

from __future__ import annotations

import json
import mmap
import os
import re
import warnings
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import torch

from torch import nn

from . import native
from .config import (
    FLUX_DEV_VERSION,
    FLUX_SCHNELL_4BIT,
    FLUX_SCHNELL_VERSION,
    MMDIT_CONFIG,
    SD35_LARGE,
    SD35_LARGE_4BIT,
    SD3_MEDIUM,
    T5_XXL,
    AutoencoderConfig,
    CLIPTextModelConfig,
    MMDiTConfig,
    PositionalEncoding,
    T5Config,
    VAEDecoderConfig,
    VAEEncoderConfig,
)
from .models.clip import CLIPTextModel
from .models.mmdit import MMDiT
from .models.t5 import T5Encoder
from .models.vae import Autoencoder, VAEDecoder, VAEEncoder
from .ops.quantized import QuantizedLinear
from .ops.rope import rope_head_permutation
from .ops.w8a8 import W8A8Linear
from .utils import get_logger

logger = get_logger(__name__)

StateDict = Dict[str, torch.Tensor]

# -- registry (the reference's tables, by model version) ----------------------

MMDIT_CKPT = {
    SD3_MEDIUM: "sd3_medium.safetensors",
    SD35_LARGE: "sd3.5_large.safetensors",
    SD35_LARGE_4BIT: "sd3.5_large_4bit_quantized.safetensors",
    FLUX_SCHNELL_VERSION: "flux-schnell.safetensors",
    FLUX_SCHNELL_4BIT: "flux-schnell-4bit-quantized.safetensors",
    FLUX_DEV_VERSION: "flux1-dev.safetensors",
}

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

# The auxiliary models' files live in one hub repo.
AUX_REPO = "argmaxinc/stable-diffusion"
AUX_FILES = {
    "clip_l_config": "clip_l/config.json",
    "clip_l": "clip_l/model.fp16.safetensors",
    "clip_g_config": "clip_g/config.json",
    "clip_g": "clip_g/model.fp16.safetensors",
    "tokenizer_l_vocab": "tokenizer_l/vocab.json",
    "tokenizer_l_merges": "tokenizer_l/merges.txt",
    "tokenizer_g_vocab": "tokenizer_g/vocab.json",
    "tokenizer_g_merges": "tokenizer_g/merges.txt",
    "t5": "t5/t5xxl.safetensors",
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
    writable, and that warning is silenced here. The mapping is
    prefetched (``native.prefetch``: ``madvise(MADV_WILLNEED)``, as the
    reference's loader does) before its header is read."""
    with open(path, "rb") as f:
        m = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    native.prefetch(m)
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


# -- MLX 4-bit affine storage ------------------------------------------------------


def _words(packed: torch.Tensor) -> torch.Tensor:
    """32-bit packed words (the file's uint32, or int32) as an int32 bit
    view."""
    return packed.view(torch.int32) if packed.dtype == torch.uint32 else packed


def dequantize_mlx_4bit(
    packed: torch.Tensor, scales: torch.Tensor, biases: torch.Tensor,
    group_size: Optional[int] = None,
) -> torch.Tensor:
    """MLX ``nn.quantize`` 4-bit affine weights -> fp32 (out, in): 8
    nibbles a 32-bit word along the input axis, value j of word w at bits
    [4j, 4j+4) and column 8w + j; ``w = scale * q + bias`` per (out, group),
    a product and a sum, each rounded. ``group_size`` defaults to the one
    the shapes give."""
    out_dim, packed_in = packed.shape
    if group_size is None:
        group_size = (packed_in * 8) // scales.shape[1]
    shifts = torch.arange(0, 32, 4, dtype=torch.int32, device=packed.device)
    q = ((_words(packed)[..., None] >> shifts) & 0xF).reshape(out_dim, packed_in * 8)
    s = scales.float().repeat_interleave(group_size, dim=1)
    b = biases.float().repeat_interleave(group_size, dim=1)
    return q.float() * s + b


def _is_packed(sd: StateDict, key: str) -> bool:
    return key + ".scales" in sd and sd[key + ".weight"].dtype in (torch.uint32, torch.int32)


def _maybe_dequantize(sd: StateDict) -> StateDict:
    """Collapse each MLX triple (``k.weight`` packed words, ``k.scales``,
    ``k.biases``) into an fp32 ``k.weight``; every other tensor passes
    through."""
    out: StateDict = {}
    for k, v in sd.items():
        if k.endswith((".scales", ".biases")):
            continue
        base = k[: -len(".weight")]
        if k.endswith(".weight") and _is_packed(sd, base):
            out[k] = dequantize_mlx_4bit(v, sd[base + ".scales"], sd[base + ".biases"])
        else:
            out[k] = v
    return out


class _Mapped:
    """A state dict under construction in the port's names, the linears it
    holds packed, and the device the packed words are repacked on."""

    def __init__(self, device):
        self.sd: StateDict = {}
        self.packed: Dict[str, Tuple[int, int, int, bool]] = {}
        self.device = torch.device(device)

    def lin(self, dst: str, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> None:
        """A float (out, in) linear."""
        self.sd[dst + ".weight"] = w
        if b is not None:
            self.sd[dst + ".bias"] = b

    def raw(self, sd: StateDict, src: str, dst: str, bias: bool = True) -> None:
        """The torch linear ``src`` as ``dst``, its bias where it has one."""
        self.lin(dst, sd[src + ".weight"], sd.get(src + ".bias") if bias else None)

    def mlx(self, sd: StateDict, src: str, dst: str, bias: bool = True) -> None:
        """MLX ``src`` (a Linear, or a QuantizedLinear: packed words with
        ``scales`` and ``biases``) as ``dst``. A packed one becomes the
        execution format of ``ops/quantized.py`` on the target device: the
        (out, in/8) word matrix transposed, bit for bit, to (in/8, out); the
        scales and affine biases in fp32, transposed; the layer bias, if
        kept, as it is."""
        b = sd.get(src + ".bias") if bias else None
        if not _is_packed(sd, src):
            self.lin(dst, sd[src + ".weight"], b)
            return
        words = _words(sd[src + ".weight"]).to(self.device)
        n, k = words.shape[0], words.shape[1] * 8
        scales = sd[src + ".scales"]
        self.sd[dst + ".q4"] = words.t().contiguous()
        for leaf, t in ((".scales", scales), (".zeros", sd[src + ".biases"])):
            self.sd[dst + leaf] = t.to(self.device, torch.float32).t().contiguous()
        if b is not None:
            self.sd[dst + ".bias"] = b
        self.packed[dst] = (k, n, k // scales.shape[1], b is not None)


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


# -- MMDiT mappers -------------------------------------------------------------------


def _qkv_split(m: _Mapped, sd: StateDict, src: str, dst: str,
               qk_norm: Optional[Tuple[str, str]] = None) -> None:
    """Fused qkv rows -> q, k, v (the k bias dropped: softmax is invariant
    to it); the QK-norm scales from the keys ``qk_norm`` names."""
    wq, wk, wv = sd[src + ".weight"].chunk(3)
    b = sd.get(src + ".bias")
    bq, _, bv = b.chunk(3) if b is not None else (None, None, None)
    m.lin(dst + ".q", wq, bq)
    m.lin(dst + ".k", wk)
    m.lin(dst + ".v", wv, bv)
    if qk_norm is not None:
        m.sd[dst + ".qk_norm.q_scale"] = sd[qk_norm[0]]
        m.sd[dst + ".qk_norm.k_scale"] = sd[qk_norm[1]]


def _fold_patch_conv(w: torch.Tensor) -> torch.Tensor:
    """OIHW (H, C, p, p) patch convolution -> the (H, C*p*p) weight of a
    linear over ``ops/common.patchify``'s (c, ph, pw) features."""
    return w.reshape(w.shape[0], -1)


def _permute_qk_for_rope(m: _Mapped, config: MMDiTConfig) -> None:
    """Fold the checkpoint's interleaved RoPE pairs into the half-rotation
    layout (``ops/rope.rope_head_permutation``): every q and k projection's
    output columns are permuted head by head (a float weight's rows; a
    packed one's words, scales and zeros by column: the nibbles run along
    the input axis, so the gather is exact), and so are the q bias and the
    QK-norm scales. Attention scores are invariant under a permutation
    shared by q and k. FLUX trees only."""
    d = config.hidden_size // config.num_heads
    perm = torch.from_numpy(rope_head_permutation(d))
    col_perm = (torch.arange(config.num_heads)[:, None] * d + perm[None, :]).reshape(-1)
    perm, col_perm = perm.to(m.device), col_perm.to(m.device)
    blocks = {k.rsplit(".", 2)[0] for k in m.sd if k.startswith(("mm_blocks.", "uni_blocks."))
              and k.rsplit(".", 2)[1] == "q"}
    for pre in blocks:
        for lin in (pre + ".q", pre + ".k"):
            for leaf, dim in ((".weight", 0), (".bias", 0), (".q4", 1), (".scales", 1),
                              (".zeros", 1)):
                t = m.sd.get(lin + leaf)
                if t is not None:
                    m.sd[lin + leaf] = t.to(m.device).index_select(dim, col_perm)
        for leaf in (".qk_norm.q_scale", ".qk_norm.k_scale"):
            if pre + leaf in m.sd:
                m.sd[pre + leaf] = m.sd[pre + leaf].to(m.device)[perm]


def _mmdit_on_meta(config: MMDiTConfig, dtype, sd: StateDict) -> Tuple[MMDiT, list]:
    """The MMDiT of ``config`` on the meta device (call inside a meta
    device context), its float leaves in ``dtype`` but the fp32-upcast
    blocks' in fp32, the learned position table at ``sd``'s size; and the
    upcast blocks."""
    model = MMDiT(config)
    upcast = [blocks[i] for blocks, ids in ((model.mm_blocks, config.upcast_multimodal_blocks),
                                            (model.uni_blocks, config.upcast_unified_blocks))
              for i in ids]
    if dtype != config.dtype:
        model.to(dtype)
        for block in upcast:
            block.float()
    pos = sd.get("pos_embed")
    if model.pos_embed is not None and pos is not None and pos.shape != model.pos_embed.shape:
        model.pos_embed = nn.Parameter(torch.empty(tuple(pos.shape), dtype=model.pos_embed.dtype))
    return model, upcast


def _build_mmdit(config: MMDiTConfig, m: _Mapped, dtype) -> MMDiT:
    """The MMDiT of ``config`` with ``m`` loaded strictly on ``m.device``:
    its float leaves in ``dtype`` (the fp32-upcast blocks' in fp32
    whatever it is, holding values rounded to ``dtype`` as the reference
    upcasts its leaves at run time), a ``QuantizedLinear`` wherever ``m``
    holds a packed linear (its bias in the dtype of the linear it
    replaces), the learned position table at the file's size."""
    dtype = dtype or config.dtype
    with torch.device("meta"):
        model, upcast = _mmdit_on_meta(config, dtype, m.sd)
        for name, (k, n, group, bias) in m.packed.items():
            parent, _, attr = name.rpartition(".")
            owner = model.get_submodule(parent)
            dt = getattr(owner, attr).weight.dtype
            setattr(owner, attr, QuantizedLinear(k, n, group, bias=bias, dtype=dt))
    model = _build(model, m.sd, m.device)
    with torch.no_grad():
        for p in (p for block in upcast for p in block.parameters() if p.dtype != dtype):
            p.copy_(p.to(dtype))
    return model


def mmdit_from_sd3_ckpt(sd: StateDict, config: MMDiTConfig, dtype=None, device="cuda") -> MMDiT:
    """A raw SD3 / SD3.5 checkpoint (``model.diffusion_model.`` namespace;
    MLX triples are dequantised) -> MMDiT. The last joint block's text
    branch has no o / MLP (``mm_final.txt``); SD3.5 adds QK-norm
    (``ln_q`` / ``ln_k``)."""
    sd = _maybe_dequantize(_strip_prefix(sd, "model.diffusion_model."))
    m = _Mapped(device)

    def block(src: str, dst: str, skip_post: bool) -> None:
        qk = ((src + ".attn.ln_q.weight", src + ".attn.ln_k.weight")
              if config.use_qk_norm else None)
        _qkv_split(m, sd, src + ".attn.qkv", dst, qk)
        m.raw(sd, src + ".adaLN_modulation.1", dst + ".ada")
        if not skip_post:
            m.raw(sd, src + ".attn.proj", dst + ".o")
            m.raw(sd, src + ".mlp.fc1", dst + ".fc1")
            m.raw(sd, src + ".mlp.fc2", dst + ".fc2")

    depth = config.depth_multimodal
    for i in range(depth - 1):
        block(f"joint_blocks.{i}.x_block", f"mm_blocks.{i}.img", False)
        block(f"joint_blocks.{i}.context_block", f"mm_blocks.{i}.txt", False)
    block(f"joint_blocks.{depth - 1}.x_block", "mm_final.img", False)
    block(f"joint_blocks.{depth - 1}.context_block", "mm_final.txt", True)
    m.lin("x_embedder", _fold_patch_conv(sd["x_embedder.proj.weight"]), sd["x_embedder.proj.bias"])
    pos = sd["pos_embed"]  # (1, R*R, H)
    m.sd["pos_embed"] = pos.reshape(pos.shape[-2], pos.shape[-1])
    m.raw(sd, "context_embedder", "context_embedder")
    for name in ("t_embedder", "y_embedder"):
        m.raw(sd, f"{name}.mlp.0", f"{name}.fc1")
        m.raw(sd, f"{name}.mlp.2", f"{name}.fc2")
    m.raw(sd, "final_layer.adaLN_modulation.1", "final_layer.ada")
    m.raw(sd, "final_layer.linear", "final_layer.linear")
    return _build_mmdit(config, m, dtype)


def mmdit_from_flux_ckpt(sd: StateDict, config: MMDiTConfig, dtype=None, device="cuda") -> MMDiT:
    """A raw FLUX checkpoint (BFL namespace; MLX triples are dequantised)
    -> MMDiT. A single block's ``linear1`` rows are (q | k | v | fc1), its
    ``linear2`` columns (o | fc2) with one shared bias: it goes to o and
    fc2's is zero (the sum is unchanged). ``guidance_in`` for FLUX.1-dev.
    The q/k columns are permuted for RoPE (``_permute_qk_for_rope``)."""
    sd = _maybe_dequantize(sd)
    m = _Mapped(device)
    H = config.hidden_size
    for i in range(config.depth_multimodal):
        for tag, side in (("img", "img"), ("txt", "txt")):
            src, dst = f"double_blocks.{i}.{tag}", f"mm_blocks.{i}.{side}"
            qk = ((f"{src}_attn.norm.query_norm.scale", f"{src}_attn.norm.key_norm.scale")
                  if config.use_qk_norm else None)
            _qkv_split(m, sd, f"{src}_attn.qkv", dst, qk)
            m.raw(sd, f"{src}_attn.proj", dst + ".o")
            m.raw(sd, f"{src}_mlp.0", dst + ".fc1")
            m.raw(sd, f"{src}_mlp.2", dst + ".fc2")
            m.raw(sd, f"{src}_mod.lin", dst + ".ada")
    for i in range(config.depth_unified):
        src, dst = f"single_blocks.{i}", f"uni_blocks.{i}"
        wq, wk, wv, wf1 = sd[src + ".linear1.weight"].split([H, H, H, H * config.mlp_ratio])
        bq, _, bv, bf1 = sd[src + ".linear1.bias"].split([H, H, H, H * config.mlp_ratio])
        w2, b2 = sd[src + ".linear2.weight"], sd[src + ".linear2.bias"]
        m.lin(dst + ".q", wq, bq)
        m.lin(dst + ".k", wk)
        m.lin(dst + ".v", wv, bv)
        m.lin(dst + ".fc1", wf1, bf1)
        m.lin(dst + ".o", w2[:, :H], b2)
        m.lin(dst + ".fc2", w2[:, H:], torch.zeros_like(b2))
        m.raw(sd, src + ".modulation.lin", dst + ".ada")
        if config.use_qk_norm:
            m.sd[dst + ".qk_norm.q_scale"] = sd[src + ".norm.query_norm.scale"]
            m.sd[dst + ".qk_norm.k_scale"] = sd[src + ".norm.key_norm.scale"]
    m.raw(sd, "img_in", "x_embedder")
    m.raw(sd, "txt_in", "context_embedder")
    embedders = [("time_in", "t_embedder"), ("vector_in", "y_embedder")]
    if config.guidance_embed:
        embedders.append(("guidance_in", "guidance_embedder"))
    for src, dst in embedders:
        m.raw(sd, src + ".in_layer", dst + ".fc1")
        m.raw(sd, src + ".out_layer", dst + ".fc2")
    m.raw(sd, "final_layer.adaLN_modulation.1", "final_layer.ada")
    m.raw(sd, "final_layer.linear", "final_layer.linear")
    _permute_qk_for_rope(m, config)
    return _build_mmdit(config, m, dtype)


def mmdit_from_mlx_ckpt(sd: StateDict, config: MMDiTConfig, dtype=None, device="cuda") -> MMDiT:
    """An MLX-module-namespace checkpoint (how the two 4-bit releases ship:
    q/k/v split, ``multimodal_transformer_blocks.N.image_transformer_block``)
    -> MMDiT. Any linear may be packed (``_Mapped.mlx``). FLUX-style files
    have unified blocks, whose fc2 carries a copy of the shared bias that is
    dropped (zero: o keeps it); SD3.5-style ones a K/V-only last text block
    (``mm_final``). ``x_embedder`` is stored OHWI. FLUX trees get the RoPE
    column permutation."""
    if any(k.startswith("model.diffusion_model.") for k in sd):
        sd = _strip_prefix(sd, "model.diffusion_model.")
    m = _Mapped(device)

    def block(src: str, dst: str, skip_post: bool = False, shared_post_bias: bool = False) -> None:
        m.mlx(sd, src + ".attn.q_proj", dst + ".q")
        m.mlx(sd, src + ".attn.k_proj", dst + ".k", bias=False)
        m.mlx(sd, src + ".attn.v_proj", dst + ".v")
        m.mlx(sd, src + ".adaLN_modulation.layers.1", dst + ".ada")
        if not skip_post:
            m.mlx(sd, src + ".attn.o_proj", dst + ".o")
            m.mlx(sd, src + ".mlp.fc1", dst + ".fc1")
            m.mlx(sd, src + ".mlp.fc2", dst + ".fc2", bias=not shared_post_bias)
            if shared_post_bias:
                o_bias = m.sd[dst + ".o.bias"]
                m.sd[dst + ".fc2.bias"] = torch.zeros_like(o_bias)
                if dst + ".fc2" in m.packed:
                    m.packed[dst + ".fc2"] = m.packed[dst + ".fc2"][:3] + (True,)
        if config.use_qk_norm:
            m.sd[dst + ".qk_norm.q_scale"] = sd[src + ".qk_norm.q_norm.weight"]
            m.sd[dst + ".qk_norm.k_scale"] = sd[src + ".qk_norm.k_norm.weight"]

    n_mm = config.depth_multimodal
    flux = config.depth_unified > 0
    for i in range(n_mm - (0 if flux else 1)):
        pre = f"multimodal_transformer_blocks.{i}"
        block(pre + ".image_transformer_block", f"mm_blocks.{i}.img")
        block(pre + ".text_transformer_block", f"mm_blocks.{i}.txt")
    if flux:
        for i in range(config.depth_unified):
            block(f"unified_transformer_blocks.{i}.transformer_block", f"uni_blocks.{i}",
                  shared_post_bias=True)
    else:
        pre = f"multimodal_transformer_blocks.{n_mm - 1}"
        block(pre + ".image_transformer_block", "mm_final.img")
        block(pre + ".text_transformer_block", "mm_final.txt", skip_post=True)
    xw = sd["x_embedder.proj.weight"]  # MLX Conv2d: OHWI
    m.lin("x_embedder", _fold_patch_conv(xw.permute(0, 3, 1, 2)), sd["x_embedder.proj.bias"])
    if "x_pos_embedder.pos_embed.weight" in sd:
        m.sd["pos_embed"] = sd["x_pos_embedder.pos_embed.weight"]
    m.mlx(sd, "context_embedder", "context_embedder")
    embedders = [("t_embedder", "t_embedder"), ("y_embedder", "y_embedder")]
    if config.guidance_embed and "guidance_in.mlp.layers.0.weight" in sd:
        embedders.append(("guidance_in", "guidance_embedder"))
    for src, dst in embedders:
        m.mlx(sd, f"{src}.mlp.layers.0", dst + ".fc1")
        m.mlx(sd, f"{src}.mlp.layers.2", dst + ".fc2")
    m.mlx(sd, "final_layer.adaLN_modulation.layers.1", "final_layer.ada")
    m.mlx(sd, "final_layer.linear", "final_layer.linear")
    if config.pos_embed_type == PositionalEncoding.PreSDPARope:
        _permute_qk_for_rope(m, config)
    return _build_mmdit(config, m, dtype)


def detect_mmdit_namespace(sd: StateDict) -> str:
    """The key namespace of an MMDiT checkpoint: "mlx" (the MLX module tree
    of the 4-bit releases), "flux_raw" (BFL ``double_blocks`` /
    ``single_blocks``) or "sd3_raw" (sgm ``joint_blocks``)."""
    for k in sd:
        if "multimodal_transformer_blocks" in k or "unified_transformer_blocks" in k:
            return "mlx"
        if k.startswith(("double_blocks", "single_blocks")):
            return "flux_raw"
    return "sd3_raw"


# -- text encoder mappers ------------------------------------------------------------


def clip_from_hf_ckpt(
    sd: StateDict, config: CLIPTextModelConfig, dtype=torch.float32, device="cuda",
) -> CLIPTextModel:
    """An HF ``CLIPTextModel`` checkpoint (the ``text_model.`` prefix
    optional) -> CLIPTextModel; ``text_projection`` only where the config
    has a projection dimension and the file the weight, as the reference
    reads it (without it the pooled output is not projected)."""
    sd = {k[len("text_model."):] if k.startswith("text_model.") else k: v for k, v in sd.items()}
    out: StateDict = {
        "token_embedding.weight": sd["embeddings.token_embedding.weight"],
        "position_embedding.weight": sd["embeddings.position_embedding.weight"],
    }
    _copy(sd, "final_layer_norm", "final_layer_norm", out)
    for i in range(config.num_layers):
        src, dst = f"encoder.layers.{i}", f"layers.{i}"
        for raw, name in (("layer_norm1", "ln1"), ("layer_norm2", "ln2"),
                          ("self_attn.q_proj", "query_proj"), ("self_attn.k_proj", "key_proj"),
                          ("self_attn.v_proj", "value_proj"), ("self_attn.out_proj", "out_proj"),
                          ("mlp.fc1", "linear1"), ("mlp.fc2", "linear2")):
            _copy(sd, f"{src}.{raw}", f"{dst}.{name}", out)
    with torch.device("meta"):
        model = CLIPTextModel(config, dtype)
    if config.projection_dim is not None and "text_projection.weight" in sd:
        out["text_projection.weight"] = sd["text_projection.weight"]
    else:
        model.text_projection = None
    return _build(model, out, device)


def clip_config_from_hf_json(path: Union[str, Path]) -> CLIPTextModelConfig:
    """A CLIP text config from an HF ``config.json``."""
    with open(path) as f:
        cfg = json.load(f)
    return CLIPTextModelConfig(
        num_layers=cfg["num_hidden_layers"],
        model_dims=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        max_length=cfg["max_position_embeddings"],
        vocab_size=cfg["vocab_size"],
        projection_dim=cfg.get("projection_dim"),
        hidden_act=cfg.get("hidden_act", "quick_gelu"),
    )


def t5_from_ckpt(
    sd: StateDict, config: T5Config = T5_XXL, dtype=torch.bfloat16, device="cuda",
) -> T5Encoder:
    """An HF T5 encoder checkpoint (``encoder.block.N``) -> T5Encoder: the
    embedding from ``encoder.embed_tokens.weight`` or else
    ``shared.weight``, the bucket table from block 0."""
    wte = "encoder.embed_tokens.weight" if "encoder.embed_tokens.weight" in sd else "shared.weight"
    out: StateDict = {
        "wte.weight": sd[wte],
        "relative_attention_bias.weight":
            sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"],
        "final_ln.weight": sd["encoder.final_layer_norm.weight"],
    }
    for i in range(config.num_layers):
        src, dst = f"encoder.block.{i}.layer", f"layers.{i}"
        out[dst + ".ln1.weight"] = sd[src + ".0.layer_norm.weight"]
        out[dst + ".ln2.weight"] = sd[src + ".1.layer_norm.weight"]
        for raw, name in (("0.SelfAttention.q", "query_proj"), ("0.SelfAttention.k", "key_proj"),
                          ("0.SelfAttention.v", "value_proj"), ("0.SelfAttention.o", "out_proj"),
                          ("1.DenseReluDense.wi_0", "wi_0"), ("1.DenseReluDense.wi_1", "wi_1"),
                          ("1.DenseReluDense.wo", "wo")):
            out[f"{dst}.{name}.weight"] = sd[f"{src}.{raw}.weight"]
    with torch.device("meta"):
        model = T5Encoder(config, dtype)
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


def load_mmdit(
    model_version: str, dtype=None, local_ckpt: Optional[str] = None, device="cuda",
) -> Tuple[MMDiT, MMDiTConfig]:
    """The MMDiT of ``model_version`` (``MMDIT_CONFIG``) from its
    checkpoint, in whichever namespace the file is (``detect_mmdit_namespace``);
    float leaves in ``dtype`` (the config's by default). The 4-bit releases'
    packed linears are repacked bit for bit, with no float round trip."""
    config = MMDIT_CONFIG[model_version]
    path = _resolve(model_version, MMDIT_CKPT[model_version], local_ckpt)
    sd = load_safetensors(path)
    mapper = {"mlx": mmdit_from_mlx_ckpt, "flux_raw": mmdit_from_flux_ckpt,
              "sd3_raw": mmdit_from_sd3_ckpt}[detect_mmdit_namespace(sd)]
    model = mapper(sd, config, dtype, device=device)
    del sd
    n = sum(t.numel() for t in model.state_dict().values())
    logger.info("Loaded MMDiT %s (%.2fB parameters) from %s", model_version, n / 1e9, path)
    return model, config


def load_text_encoder(
    which: str, dtype=torch.float32, device="cuda",
) -> Tuple[CLIPTextModel, CLIPTextModelConfig]:
    """``which``: "clip_l" or "clip_g", from the auxiliary repo's HF files."""
    config = clip_config_from_hf_json(_resolve_aux(AUX_FILES[which + "_config"]))
    sd = load_safetensors(_resolve_aux(AUX_FILES[which]))
    return clip_from_hf_ckpt(sd, config, dtype, device=device), config


def load_t5_encoder(dtype=torch.bfloat16, device="cuda") -> T5Encoder:
    """The T5-XXL encoder (``T5_XXL``) from the auxiliary repo's file."""
    sd = load_safetensors(_resolve_aux(AUX_FILES["t5"]))
    return t5_from_ckpt(sd, T5_XXL, dtype, device=device)


def load_tokenizer(which: str, pad_with_eos: bool = False):
    """``which``: "l" or "g": the CLIP BPE tokenizer from its
    ``vocab.json`` and ``merges.txt``."""
    from .tokenizer import CLIPTokenizer

    return CLIPTokenizer.from_files(
        _resolve_aux(AUX_FILES[f"tokenizer_{which}_vocab"]),
        _resolve_aux(AUX_FILES[f"tokenizer_{which}_merges"]),
        pad_with_eos=pad_with_eos,
    )


def load_t5_tokenizer(max_length: int = 256):
    """The T5 sentencepiece tokenizer through ``transformers``: from
    ``<DIFFUSIONKIT_TPU_CKPT_DIR>/google/t5-v1_1-xxl`` if it exists, else
    the hub's ``google/t5-v1_1-xxl``."""
    from .tokenizer import T5TokenizerWrapper

    root = os.environ.get("DIFFUSIONKIT_TPU_CKPT_DIR")
    path = "google/t5-v1_1-xxl"
    if root and (Path(root) / path).exists():
        path = str(Path(root) / path)
    return T5TokenizerWrapper(path, max_length=max_length)


# -- the quantized-tree disk cache ----------------------------------------------------
#
# The reference's cache of quantized execution trees (model_io.py
# quant_cache_path, save_params_atomic, load_params_cache), over the port's
# modules: a packed model's state dict in a safetensors file, stamped with a
# layout version of the port's own, under a name with the port's prefix (a
# file the JAX package wrote, of its own layout, is never read).

CACHE_PREFIX = "torch_"
# Layout of the port's cache files; a file of another layout is deleted and
# regenerated.
CACHE_LAYOUT = 1
CACHE_LAYOUT_KEY = "__dk_torch_cache_layout__"

_ST_TAGS = {v: k for k, v in _ST_DTYPES.items()}


def save_safetensors(path: Union[str, Path], tensors: StateDict) -> None:
    """A safetensors file of ``tensors``, written without the safetensors
    package (the card's machine has none): an 8-byte little-endian header
    length, the JSON header padded to 8 bytes, then each tensor's bytes in
    turn, each moved to the host on its own, so the file never exists
    whole in memory."""
    header, offset = {}, 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            f.write(memoryview(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy()))


def quant_cache_path(tag: str, src_path: Union[str, Path]) -> Optional[Path]:
    """The cache file of a quantized model made from ``src_path``: under
    ``<DIFFUSIONKIT_TPU_CACHE_DIR>/params`` (default
    ``~/.cache/diffusionkit_tpu/params``), named by ``CACHE_PREFIX``, the
    caller's ``tag`` (mode, group, dtype, algorithm revision) and the source
    file's size and mtime, so a rewritten source misses. None with
    ``DIFFUSIONKIT_TPU_QUANT_CACHE=0`` or when the source is not there."""
    if os.environ.get("DIFFUSIONKIT_TPU_QUANT_CACHE", "1") == "0":
        return None
    try:
        st = os.stat(src_path)
    except OSError:
        return None
    root = Path(os.environ.get("DIFFUSIONKIT_TPU_CACHE_DIR",
                               Path.home() / ".cache" / "diffusionkit_tpu")) / "params"
    root.mkdir(parents=True, exist_ok=True)
    key = f"{CACHE_PREFIX}{tag}_{st.st_size}_{int(st.st_mtime)}"
    return root / (re.sub(r"[^A-Za-z0-9._-]", "-", key) + ".safetensors")


def save_module_cache(module: nn.Module, path: Path) -> None:
    """``module``'s state dict to ``path`` through a temporary file and a
    rename, so a crash or a full disk never leaves a truncated cache."""
    tensors = dict(module.state_dict())
    tensors[CACHE_LAYOUT_KEY] = torch.tensor([CACHE_LAYOUT], dtype=torch.int32)
    tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
    try:
        save_safetensors(tmp, tensors)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    logger.info("Saved %d tensors to %s", len(tensors), path)


def _packed_from_state(model: nn.Module, sd: StateDict) -> None:
    """Replace each linear of ``model`` (on meta) whose leaves in ``sd`` are
    packed by its packed form: ``q4`` or ``q8`` a ``QuantizedLinear`` (the
    group from the scales, w4a8 where ``wscale`` is there), ``w8`` a
    ``W8A8Linear``; the bias in the file's dtype."""
    for key, t in sd.items():
        prefix, _, leaf = key.rpartition(".")
        if leaf not in ("q4", "q8", "w8"):
            continue
        parent, _, attr = prefix.rpartition(".")
        owner = model.get_submodule(parent)
        bias = sd.get(prefix + ".bias")
        dt = bias.dtype if bias is not None else getattr(owner, attr).weight.dtype
        if leaf == "w8":
            layer = W8A8Linear(t.shape[1], t.shape[0], bias=bias is not None, dtype=dt)
        else:
            k = t.shape[0] * (8 if leaf == "q4" else 1)
            layer = QuantizedLinear(k, t.shape[1], k // sd[prefix + ".scales"].shape[0],
                                    bias=bias is not None, dtype=dt,
                                    wscale=prefix + ".wscale" in sd, bits=4 if leaf == "q4" else 8)
        setattr(owner, attr, layer)


def _load_cache(path: Path, build, device) -> Optional[nn.Module]:
    """The module ``build(sd)`` makes on meta from the cache file, loaded
    strictly on ``device``; None, the file deleted, where it is corrupt or
    of another layout."""
    try:
        sd = load_safetensors(path)
        ver = sd.pop(CACHE_LAYOUT_KEY, None)
        if ver is None or int(ver[0]) != CACHE_LAYOUT:
            raise ValueError(f"cache layout {None if ver is None else int(ver[0])}, "
                             f"expected {CACHE_LAYOUT}")
        with torch.device("meta"):
            model = build(sd)
            _packed_from_state(model, sd)
        return _build(model, sd, device)
    except torch.OutOfMemoryError:
        raise
    except (OSError, ValueError, KeyError, RuntimeError, AttributeError) as e:
        logger.warning("quant cache %s unreadable (%s); regenerating", path, e)
        path.unlink(missing_ok=True)
        return None


def load_mmdit_cache(path: Path, model_version: str, dtype=None,
                     device="cuda") -> Optional[MMDiT]:
    """A cached quantized MMDiT of ``model_version`` (``save_module_cache``),
    or None (``_load_cache``)."""
    config = MMDIT_CONFIG[model_version]
    return _load_cache(path, lambda sd: _mmdit_on_meta(config, dtype or config.dtype, sd)[0],
                       device)


def load_t5_cache(path: Path, dtype=torch.bfloat16, device="cuda") -> Optional[T5Encoder]:
    """A cached w8a8 T5-XXL (``save_module_cache``), or None."""
    return _load_cache(path, lambda sd: T5Encoder(T5_XXL, dtype), device)
