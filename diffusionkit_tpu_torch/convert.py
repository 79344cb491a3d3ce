"""Carry weights from the JAX package's parameter trees into the port.

The JAX trees hold numpy-convertible leaves with input-major linear kernels
``(in, out)``, HWIO convolution kernels, and per-depth blocks STACKED along
a leading axis. Here the stacks are unstacked into ``nn.ModuleList`` entries,
linear kernels are transposed to ``nn.Linear``'s ``(out, in)``, convolution
kernels become OIHW, and the result is loaded with ``strict=True`` so a
missing or extra leaf raises. Values are carried exactly (through fp32) and
cast to each module's dtype on load.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .config import CLIPTextModelConfig, MMDiTConfig, VAEDecoderConfig
from .models.clip import CLIPTextModel
from .models.mmdit import MMDiT
from .models.vae import VAEDecoder


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


def mmdit_from_jax(tree: Dict[str, Any], config: MMDiTConfig, device="cpu") -> MMDiT:
    """``init_mmdit_params``-style tree -> MMDiT (SD3 path)."""
    tree = dict(tree)
    tree["mm_blocks"] = _unstack(tree["mm_blocks"], config.depth_multimodal - 1)
    with torch.device("meta"):
        model = MMDiT(config)
    return _load(model, _state_dict(tree), device)


def clip_from_jax(
    tree: Dict[str, Any], config: CLIPTextModelConfig, dtype=torch.float32, device="cpu"
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
    tree: Dict[str, Any], config: VAEDecoderConfig, dtype=torch.float32, device="cpu"
) -> VAEDecoder:
    """``init_vae_decoder_params``-style tree -> VAEDecoder."""
    with torch.device("meta"):
        model = VAEDecoder(config, dtype)
    return _load(model, _state_dict(tree), device)
