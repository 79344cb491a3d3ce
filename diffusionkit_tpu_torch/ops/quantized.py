"""Weight-only int4 linear layers (group-affine), host packing and dispatch.

Counterpart of ``diffusionkit_tpu/ops/quantized.py`` for the int4 mode. The
layout is the reference's execution format, so packed trees carry over
bit for bit:

  q4      (K/8, N) 32-bit words, 8 nibbles per word along K: nibble j of
          word r is row 8r + j (bits [4j, 4j+4))
  scales  (K/g, N) fp32, zeros (K/g, N) fp32, ``w = q * scale + zero``
  bias    (N,) in the model dtype, or absent

  wscale  (N,) fp32, optional: the w4a8 per-channel int8-grid scale,
          ``max_k |dequant(w)[k, n]| / 127``

torch has little uint32 support, so ``QuantizedLinear`` keeps ``q4`` as an
int32 tensor holding the same bits (a bit view, never a value cast). A layer
without ``wscale`` runs through ``ops/int4_matmul.int4_linear`` (kernel C on
the card); with it, through ``ops/w4a8_matmul.w4a8_linear`` (kernel E).

Host numpy, copied from the reference: ``pack_int4_host``, the min/max path
of ``quantize_kernel_host`` and ``mlx_q4_to_exec`` (the lossless repack of
MLX 4-bit files). The w4a8 scales (``wscale_from_q4``, ``add_wscale_bound_``,
``add_wscale_``) are computed on the layer's own device, so a 12B model
makes no host round trip. The ALS and GPTQ quantizers and the ``-mixed``
overrides wait for their slices.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

# Revision of the quantize-at-load algorithm (the reference's disk-cache key).
QUANT_VERSION = 4

# Kernels with any dimension below this stay in the float dtype (the
# reference's quality rule for the narrow I/O adapters).
MIN_DIM = 256


def pack_int4_host(q: np.ndarray) -> np.ndarray:
    """(in, out) nibbles 0..15 -> (in/8, out) uint32, value j of each word at
    bits [4j, 4j+4)."""
    in_dim, out_dim = q.shape
    if in_dim % 8:
        raise ValueError(f"pack_int4_host: input dim {in_dim} is not a multiple of 8")
    q = q.astype(np.uint32).reshape(in_dim // 8, 8, out_dim)
    packed = np.zeros((in_dim // 8, out_dim), dtype=np.uint32)
    for j in range(8):
        packed |= q[:, j, :] << np.uint32(4 * j)
    return packed


def quantize_kernel_host(w: np.ndarray, group_size: int = 64,
                         with_wscale: bool = False) -> Dict[str, np.ndarray]:
    """Min/max affine int4 group quantisation of an (in, out) float kernel:
    per (group, out channel) ``scale = max((max - min) / 15, 1e-8)``,
    ``zero = min``, ``q = clip(round((w - zero) / scale), 0, 15)``. The
    reference's ``quantize_kernel_host(bits=4, refine=False)``; with
    ``with_wscale`` also the w4a8 ``wscale`` from the exact dequantised
    values, as the reference's numpy path computes it."""
    in_dim, out_dim = w.shape
    if in_dim % group_size:
        raise ValueError(f"quantize_kernel_host: {in_dim} rows, group {group_size}")
    g = w.reshape(in_dim // group_size, group_size, out_dim).astype(np.float32)
    wmin = g.min(axis=1)
    wmax = g.max(axis=1)
    scale = np.maximum((wmax - wmin) / 15.0, 1e-8).astype(np.float32)
    zero = wmin.astype(np.float32)
    q = np.clip(np.round((g - zero[:, None, :]) / scale[:, None, :]), 0, 15).astype(np.uint8)
    out = {"q4": pack_int4_host(q.reshape(in_dim, out_dim)), "scales": scale, "zeros": zero}
    if with_wscale:
        deq = (q.astype(np.float32) * scale[:, None, :] + zero[:, None, :]).reshape(in_dim, out_dim)
        out["wscale"] = (np.maximum(np.abs(deq).max(0), 1e-8) / 127.0).astype(np.float32)
    return out


def mlx_q4_to_exec(
    packed: np.ndarray, scales: np.ndarray, biases: np.ndarray, bias: Optional[np.ndarray]
) -> Dict[str, Optional[np.ndarray]]:
    """Lossless repack of an MLX 4-bit QuantizedLinear: ``weight`` (out, in/8)
    uint32 with 8 nibbles per word along the input axis and per-(out, group)
    ``scales``/``biases`` become the execution format above. The nibbles move
    bit for bit and the affine arrays are only transposed."""
    out_dim, packed_in = packed.shape
    p = np.asarray(packed, dtype=np.uint32)
    q = np.zeros((out_dim, packed_in * 8), dtype=np.uint8)
    for j in range(8):
        q[:, j::8] = ((p >> np.uint32(4 * j)) & np.uint32(0xF)).astype(np.uint8)
    return {
        "q4": pack_int4_host(np.ascontiguousarray(q.T)),
        "scales": np.ascontiguousarray(scales.astype(np.float32).T),
        "zeros": np.ascontiguousarray(biases.astype(np.float32).T),
        "bias": None if bias is None else np.asarray(bias, np.float32),
    }


class QuantizedLinear(nn.Module):
    """int4 linear: buffers ``q4`` (int32 bit view of the uint32 words),
    ``scales``, ``zeros`` (fp32), an optional ``bias`` in the model dtype
    and an optional fp32 ``wscale`` (N,), whose presence selects the w4a8
    mode. Applied by ``ops/common.linear``."""

    def __init__(self, in_features: int, out_features: int, group_size: int = 64,
                 bias: bool = True, dtype: torch.dtype = torch.bfloat16, device=None,
                 wscale: bool = False):
        super().__init__()
        if in_features % group_size or group_size % 8:
            raise ValueError(f"QuantizedLinear: {in_features} inputs, group {group_size}")
        self.in_features, self.out_features, self.group_size = in_features, out_features, group_size
        groups = in_features // group_size
        self.register_buffer("q4", torch.empty(in_features // 8, out_features, dtype=torch.int32,
                                               device=device))
        self.register_buffer("scales", torch.empty(groups, out_features, dtype=torch.float32,
                                                   device=device))
        self.register_buffer("zeros", torch.empty(groups, out_features, dtype=torch.float32,
                                                  device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, dtype=dtype, device=device),
                                  requires_grad=False) if bias else None)
        self.register_buffer("wscale", torch.empty(out_features, dtype=torch.float32,
                                                   device=device) if wscale else None)

    @classmethod
    def from_host(cls, packed: Dict[str, Optional[np.ndarray]], dtype: torch.dtype,
                  device="cpu") -> "QuantizedLinear":
        """From host arrays in the execution format (``quantize_kernel_host``,
        ``mlx_q4_to_exec``); ``q4`` is carried as a bit view."""
        k8, n = packed["q4"].shape
        group = k8 * 8 // packed["scales"].shape[0]
        bias = packed.get("bias")
        wscale = packed.get("wscale")
        layer = cls(k8 * 8, n, group, bias=bias is not None, dtype=dtype, device=device,
                    wscale=wscale is not None)
        with torch.no_grad():
            layer.q4.copy_(torch.from_numpy(np.ascontiguousarray(packed["q4"], np.uint32)
                                            .view(np.int32)))
            layer.scales.copy_(torch.from_numpy(np.asarray(packed["scales"], np.float32)))
            layer.zeros.copy_(torch.from_numpy(np.asarray(packed["zeros"], np.float32)))
            if bias is not None:
                layer.bias.copy_(torch.from_numpy(np.asarray(bias, np.float32)))
            if wscale is not None:
                layer.wscale.copy_(torch.from_numpy(np.asarray(wscale, np.float32)))
        return layer

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"group_size={self.group_size}, bias={self.bias is not None}, "
                f"w4a8={self.wscale is not None}")


@torch.no_grad()
def wscale_from_q4(layer: QuantizedLinear) -> torch.Tensor:
    """Per-channel int8-grid scale from the exact dequantised extrema, on
    the layer's device: ``max(max_k |q * scale + zero|, 1e-8) / 127`` in
    fp32 (the reference's ``wscale_from_q4_host``). The dequantisation is a
    product and a sum, each rounded, as numpy computes it there."""
    k8, n = layer.q4.shape
    shifts = torch.arange(0, 32, 4, dtype=torch.int32, device=layer.q4.device)
    q = ((layer.q4[:, None, :] >> shifts[None, :, None]) & 0xF).reshape(k8 * 8, n).float()
    g = q.shape[0] // layer.scales.shape[0]
    w = q * layer.scales.repeat_interleave(g, dim=0) + layer.zeros.repeat_interleave(g, dim=0)
    amax = w.abs().amax(dim=0).clamp_min(1e-8)
    return amax / torch.full_like(amax, 127.0)


@torch.no_grad()
def add_wscale_bound_(layer: QuantizedLinear) -> QuantizedLinear:
    """Set ``wscale`` from the group-affine bounds, with no nibble unpack
    (the reference's ``add_wscale_bound_tree``): per channel
    ``max_g max(|z|, |z + 15 s|)`` bounds |dequant(w)| and is attained by
    a min/max grid."""
    s, z = layer.scales.float(), layer.zeros.float()
    amax = torch.maximum(z.abs(), (z + 15.0 * s).abs()).amax(dim=-2).clamp_min(1e-8)
    layer.wscale = amax / torch.full_like(amax, 127.0)
    return layer


@torch.no_grad()
def add_wscale_(module: nn.Module) -> nn.Module:
    """Give every ``QuantizedLinear`` under ``module`` that lacks one its
    exact w4a8 ``wscale`` (the reference's ``add_wscale_tree``). In place;
    returns ``module``."""
    for layer in module.modules():
        if isinstance(layer, QuantizedLinear) and layer.wscale is None:
            layer.wscale = wscale_from_q4(layer)
    return module


@torch.no_grad()
def random_quantized_linear_(layer: QuantizedLinear, generator: torch.Generator,
                             scale: float = 0.02) -> QuantizedLinear:
    """Fill a QuantizedLinear in place with random packed weights, as the
    reference's ``random_quantized_linear`` does: uniform random nibbles,
    ``scale = 2 * scale / 15`` and ``zero = -scale`` everywhere (so w is
    uniform on [-scale, scale]), zero bias. Drawn on the layer's device from
    ``generator``, so a 12B model never exists in float."""
    layer.q4.random_(-(2**31), 2**31, generator=generator)
    layer.scales.fill_(2 * scale / 15)
    layer.zeros.fill_(-scale)
    if layer.bias is not None:
        layer.bias.zero_()
    return layer


def quantize_linear(layer: nn.Linear, group_size: int,
                    min_size: int = 1 << 16, min_dim: int = MIN_DIM) -> nn.Module:
    """Quantize-at-load of one float ``nn.Linear`` by the reference's rules
    (``quantize_linear_params``): layers with fewer than ``min_size`` weights,
    a dimension below ``min_dim`` or an input dim that the group does not
    divide stay float. Packed layers pass through."""
    if not isinstance(layer, nn.Linear):
        return layer
    out_dim, in_dim = layer.weight.shape
    if layer.weight.numel() < min_size or min(in_dim, out_dim) < min_dim or in_dim % group_size:
        return layer
    w = layer.weight.detach().float().cpu().numpy().T
    packed = quantize_kernel_host(w, group_size)
    packed["bias"] = None if layer.bias is None else layer.bias.detach().float().cpu().numpy()
    return QuantizedLinear.from_host(packed, layer.weight.dtype, layer.weight.device)


def quantize_module_(module: nn.Module, group_size: int = 32) -> nn.Module:
    """Replace every eligible ``nn.Linear`` under ``module`` by its int4 form,
    in place (the reference's ``quantize_tree`` with the min/max grid; GPTQ
    waits). Returns ``module``."""
    for name, child in list(module.named_children()):
        if isinstance(child, nn.Linear):
            setattr(module, name, quantize_linear(child, group_size))
        else:
            quantize_module_(child, group_size)
    return module
