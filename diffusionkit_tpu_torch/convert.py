"""Carry weights from the JAX package's parameter trees into the port.

The JAX trees hold numpy-convertible leaves with input-major linear kernels
``(in, out)``, HWIO convolution kernels, and per-depth blocks STACKED along
a leading axis. Here the stacks are unstacked into ``nn.ModuleList`` entries,
linear kernels are transposed to ``nn.Linear``'s ``(out, in)``, convolution
kernels become OIHW, and the result is loaded with ``strict=True`` so a
missing or extra leaf raises. Float values are carried exactly (through
fp32) and cast to each module's dtype on load. Integer leaves never pass
through a float: packed int4 words (``q4``, uint32) are carried bit for bit
as an int32 view, int8 weight-only bytes (``q8``, uint8 ``(K, N)``) as
uint8, and w8a8 weights (``w8``, int8 ``(in, out)``) as int8 transposed to
``(out, in)``. ``scales``/``zeros`` keep the reference's ``(K/g, N)``
layout; a ``wscale`` leaf (fp32 ``(N,)``: w4a8's from ``add_wscale_tree``
or ``add_wscale_bound_tree``, or w8a8's) lands on the layer's ``wscale``.
Wherever the tree holds a packed or w8a8 linear, the module swaps in a
``QuantizedLinear`` or ``W8A8Linear`` of the same shape.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .config import (
    AutoencoderConfig, CLIPTextModelConfig, MMDiTConfig, T5Config, VAEDecoderConfig,
    VAEEncoderConfig,
)
from .models.clip import CLIPTextModel
from .models.mmdit import MMDiT
from .models.t5 import T5Encoder
from .models.vae import Autoencoder, VAEDecoder, VAEEncoder
from .ops.quantized import QuantizedLinear
from .ops.w8a8 import W8A8Linear


def _index(tree: Any, i: int) -> Any:
    """Slice entry i of every leaf of a stacked subtree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return None if tree is None else np.asarray(tree)[i]


def _unstack(tree: Dict[str, Any], n: int):
    return [_index(tree, i) for i in range(n)]


def _state_dict(tree: Any, prefix: str = "", out=None) -> Dict[str, torch.Tensor]:
    """Flatten a (partly unstacked) JAX tree into torch state-dict entries."""
    out = {} if out is None else out
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        key = f"{prefix}{k}"
        if v is None:  # e.g. a bias-free key projection
            continue
        if isinstance(v, (dict, list, tuple)):
            _state_dict(v, key + ".", out)
            continue
        if k == "q4":  # packed words: a bit view, no value cast
            out[key] = torch.from_numpy(np.ascontiguousarray(np.asarray(v, np.uint32))
                                        .view(np.int32))
            continue
        if k == "q8":
            out[key] = torch.from_numpy(np.ascontiguousarray(np.asarray(v, np.uint8)))
            continue
        if k == "w8":  # (in, out) -> (out, in)
            out[key] = torch.from_numpy(np.ascontiguousarray(np.asarray(v, np.int8).T))
            continue
        a = np.asarray(v, dtype=np.float32)
        if k == "kernel":
            key = f"{prefix}weight"
            if a.ndim == 2:
                a = a.T  # (in, out) -> (out, in)
            elif a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        out[key] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def _load(model: torch.nn.Module, sd: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    model.to_empty(device=device)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def mmdit_from_jax(tree: Dict[str, Any], config: MMDiTConfig, device="cuda") -> MMDiT:
    """``init_mmdit_params``-style tree (SD3 or FLUX) -> MMDiT; every linear
    the tree holds packed (``q4``/``q8`` leaves) becomes a
    ``QuantizedLinear``, every w8a8 one (``w8``) a ``W8A8Linear``."""
    tree = dict(tree)
    flux = config.depth_unified > 0
    tree["mm_blocks"] = _unstack(tree["mm_blocks"], config.depth_multimodal - (0 if flux else 1))
    if flux:
        tree["uni_blocks"] = _unstack(tree["uni_blocks"], config.depth_unified)
    with torch.device("meta"):
        model = MMDiT(config)
        _pack_like(model, tree)
    return _load(model, _state_dict(tree), device)


def _pack_like(module: torch.nn.Module, tree: Any) -> None:
    """Swap in a ``QuantizedLinear`` wherever the tree holds a packed linear
    (``q4`` or ``q8`` leaves) and a ``W8A8Linear`` wherever it holds a w8a8
    one (``w8``): the reference's quantize-at-load converts embedders too."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, sub in items:
        if not isinstance(sub, (dict, list)):
            continue
        child = module[k] if isinstance(k, int) else getattr(module, k)
        if isinstance(sub, dict) and ("q4" in sub or "q8" in sub or "w8" in sub):
            dtype = next(child.parameters()).dtype
            bias = sub.get("bias") is not None
            if "w8" in sub:
                in_dim, n = np.shape(sub["w8"])
                setattr(module, k, W8A8Linear(in_dim, n, bias=bias, dtype=dtype))
                continue
            bits = 4 if "q4" in sub else 8
            in_dim = np.shape(sub["q4"])[0] * 8 if bits == 4 else np.shape(sub["q8"])[0]
            groups, n = np.shape(sub["scales"])
            setattr(module, k, QuantizedLinear(in_dim, n, in_dim // groups, bias=bias, dtype=dtype,
                                               wscale="wscale" in sub, bits=bits))
        else:
            _pack_like(child, sub)


def t5_from_jax(
    tree: Dict[str, Any], config: T5Config, dtype=torch.float32, device="cuda"
) -> T5Encoder:
    """``init_t5_params``-style tree -> T5Encoder; a w8a8 tree
    (``w8a8_tree``) gives ``W8A8Linear``s."""
    tree = dict(tree)
    tree["layers"] = _unstack(tree["layers"], config.num_layers)
    for name in ("wte", "relative_attention_bias"):
        tree[name] = {"weight": tree[name]}
    with torch.device("meta"):
        model = T5Encoder(config, dtype)
        _pack_like(model, tree)
    return _load(model, _state_dict(tree), device)


def clip_from_jax(
    tree: Dict[str, Any], config: CLIPTextModelConfig, dtype=torch.float32, device="cuda"
) -> CLIPTextModel:
    """``init_clip_params``-style tree -> CLIPTextModel."""
    tree = dict(tree)
    tree["layers"] = _unstack(tree["layers"], config.num_layers)
    for name in ("token_embedding", "position_embedding"):
        tree[name] = {"weight": tree[name]}
    with torch.device("meta"):
        model = CLIPTextModel(config, dtype)
    return _load(model, _state_dict(tree), device)


def vae_decoder_from_jax(
    tree: Dict[str, Any], config: VAEDecoderConfig, dtype=torch.float32, device="cuda"
) -> VAEDecoder:
    """``init_vae_decoder_params``-style tree -> VAEDecoder."""
    with torch.device("meta"):
        model = VAEDecoder(config, dtype)
    return _load(model, _state_dict(tree), device)


def vae_encoder_from_jax(
    tree: Dict[str, Any], config: VAEEncoderConfig, dtype=torch.float32, device="cuda"
) -> VAEEncoder:
    """``init_vae_encoder_params``-style tree -> VAEEncoder."""
    with torch.device("meta"):
        model = VAEEncoder(config, dtype)
    return _load(model, _state_dict(tree), device)


def autoencoder_from_jax(
    tree: Dict[str, Any], config: AutoencoderConfig, dtype=torch.float32, device="cuda"
) -> Autoencoder:
    """``init_autoencoder_params``-style tree -> Autoencoder."""
    with torch.device("meta"):
        model = Autoencoder(config, dtype)
    return _load(model, _state_dict(tree), device)
