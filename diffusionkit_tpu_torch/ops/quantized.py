"""Weight-only int4 linear layers (group-affine), host packing and dispatch.

Counterpart of ``diffusionkit_tpu/ops/quantized.py`` for the int4 mode. The
layout is the reference's execution format, so packed trees carry over
bit for bit:

  q4      (K/8, N) 32-bit words, 8 nibbles per word along K: nibble j of
          word r is row 8r + j (bits [4j, 4j+4))
  scales  (K/g, N) fp32, zeros (K/g, N) fp32, ``w = q * scale + zero``
  bias    (N,) in the model dtype, or absent

torch has little uint32 support, so ``QuantizedLinear`` keeps ``q4`` as an
int32 tensor holding the same bits (a bit view, never a value cast). The
product runs through ``ops/int4_matmul.int4_linear`` (kernel C on the card).

Host numpy, copied from the reference: ``pack_int4_host``, the min/max path
of ``quantize_kernel_host`` and ``mlx_q4_to_exec`` (the lossless repack of
MLX 4-bit files). The ALS and GPTQ quantizers, the ``-mixed`` overrides and
the w4a8 scales wait for their slices.
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


def quantize_kernel_host(w: np.ndarray, group_size: int = 64) -> Dict[str, np.ndarray]:
    """Min/max affine int4 group quantisation of an (in, out) float kernel:
    per (group, out channel) ``scale = max((max - min) / 15, 1e-8)``,
    ``zero = min``, ``q = clip(round((w - zero) / scale), 0, 15)``. The
    reference's ``quantize_kernel_host(bits=4, refine=False)``."""
    in_dim, out_dim = w.shape
    if in_dim % group_size:
        raise ValueError(f"quantize_kernel_host: {in_dim} rows, group {group_size}")
    g = w.reshape(in_dim // group_size, group_size, out_dim).astype(np.float32)
    wmin = g.min(axis=1)
    wmax = g.max(axis=1)
    scale = np.maximum((wmax - wmin) / 15.0, 1e-8).astype(np.float32)
    zero = wmin.astype(np.float32)
    q = np.clip(np.round((g - zero[:, None, :]) / scale[:, None, :]), 0, 15).astype(np.uint8)
    return {"q4": pack_int4_host(q.reshape(in_dim, out_dim)), "scales": scale, "zeros": zero}


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
    """int4 weight-only linear: buffers ``q4`` (int32 bit view of the uint32
    words), ``scales``, ``zeros`` (fp32) and an optional ``bias`` in the
    model dtype. Applied by ``ops/common.linear``."""

    def __init__(self, in_features: int, out_features: int, group_size: int = 64,
                 bias: bool = True, dtype: torch.dtype = torch.bfloat16, device=None):
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

    @classmethod
    def from_host(cls, packed: Dict[str, Optional[np.ndarray]], dtype: torch.dtype,
                  device="cpu") -> "QuantizedLinear":
        """From host arrays in the execution format (``quantize_kernel_host``,
        ``mlx_q4_to_exec``); ``q4`` is carried as a bit view."""
        k8, n = packed["q4"].shape
        group = k8 * 8 // packed["scales"].shape[0]
        bias = packed.get("bias")
        layer = cls(k8 * 8, n, group, bias=bias is not None, dtype=dtype, device=device)
        with torch.no_grad():
            layer.q4.copy_(torch.from_numpy(np.ascontiguousarray(packed["q4"], np.uint32)
                                            .view(np.int32)))
            layer.scales.copy_(torch.from_numpy(np.asarray(packed["scales"], np.float32)))
            layer.zeros.copy_(torch.from_numpy(np.asarray(packed["zeros"], np.float32)))
            if bias is not None:
                layer.bias.copy_(torch.from_numpy(np.asarray(bias, np.float32)))
        return layer

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"group_size={self.group_size}, bias={self.bias is not None}")


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
