"""Weight-only int4 and int8 linear layers (group-affine), host packing and
dispatch.

Counterpart of ``diffusionkit_tpu/ops/quantized.py``. The layout is the
reference's execution format, so packed trees carry over bit for bit:

  q4      (K/8, N) 32-bit words, 8 nibbles per word along K: nibble j of
          word r is row 8r + j (bits [4j, 4j+4))
  q8      (K, N) uint8, values 0..255 (the int8 mode; unsigned)
  scales  (K/g, N) fp32, zeros (K/g, N) fp32, ``w = q * scale + zero``
  bias    (N,) in the model dtype, or absent

  wscale  (N,) fp32, optional: the w4a8 per-channel int8-grid scale,
          ``max_k |dequant(w)[k, n]| / 127``

torch has little uint32 support, so ``QuantizedLinear`` keeps ``q4`` as an
int32 tensor holding the same bits (a bit view, never a value cast). An int4
layer without ``wscale`` runs through ``ops/int4_matmul.int4_linear``
(kernel C on the card); with it, through ``ops/w4a8_matmul.w4a8_linear``
(kernel E); an int8 layer through ``ops/int4_matmul.int8_linear`` (kernel
#13).

Host numpy, copied from the reference: ``pack_int4_host``, the min/max path
of ``quantize_kernel_host`` (4 and 8 bits) and ``mlx_q4_to_exec`` (the
lossless repack of MLX 4-bit files). The w4a8 scales (``wscale_from_q4``,
``add_wscale_bound_``, ``add_wscale_``) are computed on the layer's own
device, so a 12B model makes no host round trip. ``quantize_module_`` is
the reference's ``quantize_tree`` with its ``MIXED_OVERRIDES``, on the
layer's device: int4 on the reference's ALS grid by default (f16 scales and
zeros; ``ops/gptq.als_grid``, ``DIFFUSIONKIT_TPU_QUANT_REFINE=0`` gives the
min/max grid), int8 on the min/max grid. GPTQ, the pipelines' default for
4-bit quantize-at-load, is ``ops/gptq.gptq_quantize_mmdit``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

# Revision of the quantize-at-load algorithm (the reference's disk-cache key).
QUANT_VERSION = 4

# Kernels with any dimension below this stay in the float dtype (the
# reference's quality rule for the narrow I/O adapters).
MIN_DIM = 256

# The "-mixed" modes' overrides, keyed by the attribute names the port's
# modules share with the reference's tree: the AdaLN ``ada`` projections at
# int8 (their error multiplies every token feature), the final layer and the
# embedders in the float dtype; every other eligible linear at the mode's
# bits.
MIXED_OVERRIDES: Dict[str, Any] = {
    "ada": 8,
    "final_layer": None,
    "x_embedder": None,
    "context_embedder": None,
    "y_embedder": None,
    "t_embedder": None,
    "guidance_embedder": None,
}


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
                         with_wscale: bool = False, bits: int = 4) -> Dict[str, np.ndarray]:
    """Min/max affine group quantisation of an (in, out) float kernel: per
    (group, out channel) ``scale = max((max - min) / qmax, 1e-8)``, ``zero =
    min``, ``q = clip(round((w - zero) / scale), 0, qmax)`` with ``qmax =
    2^bits - 1``; int4 packed into ``q4`` words, int8 as ``q8`` uint8 (K, N).
    The reference's ``quantize_kernel_host(bits, refine=False)``; with
    ``with_wscale`` (int4 only) also the w4a8 ``wscale`` from the exact
    dequantised values, as the reference's numpy path computes it."""
    if bits not in (4, 8):
        raise ValueError(f"quantize_kernel_host: bits must be 4 or 8, got {bits}")
    in_dim, out_dim = w.shape
    if in_dim % group_size:
        raise ValueError(f"quantize_kernel_host: {in_dim} rows, group {group_size}")
    g = w.reshape(in_dim // group_size, group_size, out_dim).astype(np.float32)
    wmin = g.min(axis=1)
    wmax = g.max(axis=1)
    qmax = float(2**bits - 1)
    scale = np.maximum((wmax - wmin) / qmax, 1e-8).astype(np.float32)
    zero = wmin.astype(np.float32)
    q = np.clip(np.round((g - zero[:, None, :]) / scale[:, None, :]), 0, qmax).astype(np.uint8)
    if bits == 8:
        return {"q8": q.reshape(in_dim, out_dim), "scales": scale, "zeros": zero}
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
    """Group-affine weight-only linear: int4 buffers ``q4`` (int32 bit view
    of the uint32 words), or with ``bits=8`` ``q8`` (uint8 (K, N)); then
    ``scales``, ``zeros`` (fp32), an optional ``bias`` in the model dtype
    and, for int4, an optional fp32 ``wscale`` (N,), whose presence selects
    the w4a8 mode. Applied by ``ops/common.linear``."""

    def __init__(self, in_features: int, out_features: int, group_size: int = 64,
                 bias: bool = True, dtype: torch.dtype = torch.bfloat16, device=None,
                 wscale: bool = False, bits: int = 4):
        super().__init__()
        if in_features % group_size or group_size % 8 or bits not in (4, 8):
            raise ValueError(f"QuantizedLinear: {in_features} inputs, group {group_size}, "
                             f"{bits} bits")
        if wscale and bits != 4:
            raise ValueError("QuantizedLinear: the w4a8 wscale is for int4 layers")
        self.in_features, self.out_features, self.group_size = in_features, out_features, group_size
        self.bits = bits
        groups = in_features // group_size
        if bits == 4:
            self.register_buffer("q4", torch.empty(in_features // 8, out_features,
                                                   dtype=torch.int32, device=device))
        else:
            self.register_buffer("q8", torch.empty(in_features, out_features, dtype=torch.uint8,
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
                  device="cuda") -> "QuantizedLinear":
        """From host arrays in the execution format (``quantize_kernel_host``,
        ``mlx_q4_to_exec``); ``q4`` is carried as a bit view, ``q8`` as
        uint8."""
        bits = 4 if "q4" in packed else 8
        k = packed["q4"].shape[0] * 8 if bits == 4 else packed["q8"].shape[0]
        n = packed["scales"].shape[1]
        group = k // packed["scales"].shape[0]
        bias = packed.get("bias")
        wscale = packed.get("wscale")
        layer = cls(k, n, group, bias=bias is not None, dtype=dtype, device=device,
                    wscale=wscale is not None, bits=bits)
        with torch.no_grad():
            if bits == 4:
                layer.q4.copy_(torch.from_numpy(np.ascontiguousarray(packed["q4"], np.uint32)
                                                .view(np.int32)))
            else:
                layer.q8.copy_(torch.from_numpy(np.ascontiguousarray(packed["q8"], np.uint8)))
            layer.scales.copy_(torch.from_numpy(np.asarray(packed["scales"], np.float32)))
            layer.zeros.copy_(torch.from_numpy(np.asarray(packed["zeros"], np.float32)))
            if bias is not None:
                layer.bias.copy_(torch.from_numpy(np.asarray(bias, np.float32)))
            if wscale is not None:
                layer.wscale.copy_(torch.from_numpy(np.asarray(wscale, np.float32)))
        return layer

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"group_size={self.group_size}, bits={self.bits}, bias={self.bias is not None}, "
                f"w4a8={self.wscale is not None}")


@torch.no_grad()
def dequantize(layer: QuantizedLinear) -> torch.Tensor:
    """(K, N) fp32 weights of a packed layer on its device: ``q * scale +
    zero``, a product and a sum, each rounded (the reference's
    ``_dequant`` before its cast)."""
    from .int4_matmul import dequantize_int4, dequantize_int8

    if layer.bits == 4:
        return dequantize_int4(layer.q4, layer.scales, layer.zeros, torch.float32)
    return dequantize_int8(layer.q8, layer.scales, layer.zeros, torch.float32)


@torch.no_grad()
def wscale_from_q4(layer: QuantizedLinear) -> torch.Tensor:
    """Per-channel int8-grid scale from the exact dequantised extrema, on
    the layer's device: ``max(max_k |q * scale + zero|, 1e-8) / 127`` in
    fp32 (the reference's ``wscale_from_q4_host``). The dequantisation is a
    product and a sum, each rounded, as numpy computes it there."""
    amax = dequantize(layer).abs().amax(dim=0).clamp_min(1e-8)
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
    """Give every int4 ``QuantizedLinear`` under ``module`` that lacks one
    its exact w4a8 ``wscale`` (the reference's ``add_wscale_tree``; int8
    layers, such as a ``-mixed`` model's ``ada``, stay weight-only). In place;
    returns ``module``."""
    for layer in module.modules():
        if isinstance(layer, QuantizedLinear) and layer.bits == 4 and layer.wscale is None:
            layer.wscale = wscale_from_q4(layer)
    return module


@torch.no_grad()
def random_quantized_linear_(layer: QuantizedLinear, generator: torch.Generator,
                             scale: float = 0.02) -> QuantizedLinear:
    """Fill a QuantizedLinear in place with random packed weights, as the
    reference's ``random_quantized_linear`` does: uniform random nibbles (or
    bytes), ``scale = 2 * scale / qmax`` and ``zero = -scale`` everywhere
    (so w is uniform on [-scale, scale]), zero bias. Drawn on the layer's
    device from ``generator``, so a 12B model never exists in float."""
    if layer.bits == 4:
        layer.q4.random_(-(2**31), 2**31, generator=generator)
    else:
        layer.q8.random_(0, 256, generator=generator)
    layer.scales.fill_(2 * scale / (2**layer.bits - 1))
    layer.zeros.fill_(-scale)
    if layer.bias is not None:
        layer.bias.zero_()
    return layer


@torch.no_grad()
def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(K, N) integers 0..15 -> (K/8, N) int32 bit views of the words of
    ``pack_int4_host``."""
    k, n = q.shape
    q = q.long().reshape(k // 8, 8, n)
    shifts = torch.arange(0, 32, 4, dtype=torch.int64, device=q.device)
    words = (q << shifts[None, :, None]).sum(dim=1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def refine_default(bits: int, refine: Optional[bool] = None) -> bool:
    """The reference's ``refine`` rule: int4 takes the ALS grid unless
    ``DIFFUSIONKIT_TPU_QUANT_REFINE=0``; int8 always the min/max grid."""
    if bits != 4:
        return False
    if refine is None:
        return os.environ.get("DIFFUSIONKIT_TPU_QUANT_REFINE", "1") != "0"
    return bool(refine)


@torch.no_grad()
def quantize_weight(w: torch.Tensor, group_size: int, bits: int = 4,
                    refine: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The data-free grid of an (in, out) float kernel on its device, as
    the reference's ``quantize_kernel_host(bits, refine=refine)``: (codes
    (in, out) uint8, scales, zeros (in/g, out) fp32). int4 with refinement
    (``refine_default``): the ALS grid (``ops/gptq.als_grid``, scales and
    zeros on the f16 grid); else the min/max grid, ``scale = max((max -
    min) / qmax, 1e-8)``, ``zero = min``, with IEEE divisions, so it is the
    host function's bit for bit."""
    if refine_default(bits, refine):
        from .gptq import als_grid

        return als_grid(w, group_size)
    in_dim, out_dim = w.shape
    g = w.float().reshape(in_dim // group_size, group_size, out_dim)
    wmin, wmax = g.amin(dim=1), g.amax(dim=1)
    qmax = float(2**bits - 1)
    scale = ((wmax - wmin) / torch.full_like(wmin, qmax)).clamp_min(1e-8)
    q = torch.round((g - wmin[:, None, :]) / scale[:, None, :]).clamp_(0, qmax)
    return q.reshape(in_dim, out_dim).to(torch.uint8), scale, wmin


@torch.no_grad()
def quantize_linear(layer: nn.Linear, group_size: int, min_size: int = 1 << 16,
                    min_dim: int = MIN_DIM, bits: int = 4,
                    refine: Optional[bool] = None) -> nn.Module:
    """Quantize-at-load of one float ``nn.Linear`` by the reference's rules
    (``quantize_linear_params``): layers with fewer than ``min_size`` weights,
    a dimension below ``min_dim`` or an input dim that the group does not
    divide stay float; packed layers pass through. The grid is
    ``quantize_weight``'s, computed on the layer's own device."""
    if not isinstance(layer, nn.Linear):
        return layer
    out_dim, in_dim = layer.weight.shape
    if layer.weight.numel() < min_size or min(in_dim, out_dim) < min_dim or in_dim % group_size:
        return layer
    return packed_linear(layer, *quantize_weight(layer.weight.t(), group_size, bits, refine),
                         bits, group_size)


@torch.no_grad()
def packed_linear(like: nn.Linear, codes: torch.Tensor, scales: torch.Tensor,
                  zeros: torch.Tensor, bits: int, group_size: int) -> QuantizedLinear:
    """A ``QuantizedLinear`` of (codes (in, out) uint8, scales, zeros)
    with ``like``'s bias, on its device, the bias in its dtype."""
    k, n = codes.shape
    out = QuantizedLinear(k, n, group_size, bias=like.bias is not None, dtype=like.weight.dtype,
                          device=like.weight.device, bits=bits)
    if bits == 4:
        out.q4.copy_(_pack_int4(codes))
    else:
        out.q8.copy_(codes)
    out.scales.copy_(scales)
    out.zeros.copy_(zeros)
    if like.bias is not None:
        out.bias.copy_(like.bias)
    return out


def quantize_module_(module: nn.Module, group_size: int = 32, bits: int = 4,
                     overrides: Optional[Dict[str, Any]] = None,
                     refine: Optional[bool] = None) -> nn.Module:
    """Replace every eligible ``nn.Linear`` under ``module`` by its packed
    form, in place (the reference's ``quantize_tree``: int4 on the ALS grid
    unless refinement is off, int8 on the min/max grid; ``refine`` as in
    ``refine_default``). ``overrides`` maps an attribute name to the bits of
    that subtree, or None to leave it in its float dtype, wherever the name
    occurs (``MIXED_OVERRIDES``). Returns ``module``."""
    for name, child in list(module.named_children()):
        b = bits
        if overrides is not None and name in overrides:
            if overrides[name] is None:
                continue
            b = overrides[name]
        if isinstance(child, nn.Linear):
            setattr(module, name, quantize_linear(child, group_size, bits=b, refine=refine))
        else:
            quantize_module_(child, group_size, b, overrides, refine)
    return module
