"""w8a8 linears and dynamic int8 activations (the ``ActQuant`` pair).

Counterpart of ``diffusionkit_tpu/ops/w8a8.py``. Activations are quantized
per row (per token), symmetrically:

  amax   = max(max_k |x[m, k]|, 1e-8)        (fp32)
  xscale = amax / 127                         (IEEE division)
  x8     = clip(round_half_even(x / xscale), -127, 127)

A quantized linear then computes ``(x8 @ w8) * xscale * wscale + bias``
with exact int32 accumulation. ``ActQuant`` carries one quantized activation
to several sibling linears (q/k/v, and FLUX's parallel-MLP fc1), so the
quantization runs once.

The w8a8 weight format is ``W8A8Linear``: ``w8`` int8 in torch's (out, in)
layout (the reference's ``(in, out)`` leaf transposed bit for bit), a
per-channel symmetric fp32 ``wscale`` ``max_k |w[k, n]| / 127`` and an
optional bias in the model dtype. ``w8a8_linear`` quantizes a float input
with kernel D (``fused_quant.quantize``) and runs the product and its
epilogue in kernel #11 (``w4a8_matmul.w8_matmul``); at M <= 16 #11's
GEMV quantizes the float input itself (``w4a8_matmul.quantize_w8_matmul``).
``w8a8_module_`` is the reference's ``w8a8_tree``: it converts every
eligible ``nn.Linear`` and
packed ``QuantizedLinear`` on the layer's own device; the host numpy
functions are the reference's, for loaders and tests.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass
class ActQuant:
    """A pre-quantized activation: ``x8`` int8, ``xscale`` fp32 of shape
    ``x8.shape[:-1] + (1,)``, the float original or None (fused producers
    never form it), and the dtype consumers return when ``orig`` is None."""

    x8: torch.Tensor
    xscale: torch.Tensor
    orig: Optional[torch.Tensor] = None
    out_dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.orig.dtype if self.orig is not None else self.out_dtype

    @property
    def shape(self) -> torch.Size:
        return self.x8.shape

    def to_float(self) -> torch.Tensor:
        """The float view for consumers that do not quantize: the original
        where it exists, else the dequantized values ``x8 * xscale``."""
        if self.orig is not None:
            return self.orig
        return (self.x8.float() * self.xscale).to(self.out_dtype)


def quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization in fp32 (the reference's
    ``_quantize_rows``): returns ``(x8, xscale)``. Plain torch; the kernel
    is ``ops/fused_quant.quantize``."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    # A tensor divisor: torch computes a scalar one on CUDA as a product
    # with its reciprocal, which is not the reference's IEEE division.
    xscale = amax / torch.full_like(amax, 127.0)
    x8 = torch.round(x32 / xscale).clamp_(-127, 127).to(torch.int8)
    return x8, xscale


def quantize_shared(x) -> ActQuant:
    """Quantize an activation once for several quantized linears; an
    ``ActQuant`` passes through unchanged. Runs ``fused_quant.quantize``
    (kernel D on the card) and keeps the float original."""
    if isinstance(x, ActQuant):
        return x
    aq = quantize_float(x)
    return ActQuant(aq.x8, aq.xscale, x)


def quantize_float(x: torch.Tensor) -> ActQuant:
    """Per-row int8 quantization of a float activation by
    ``fused_quant.quantize`` (kernel D on the card), after a copy where x
    is a strided view (such as one stream's rows of a joint attention
    output with a CFG batch), since the kernel reads whole rows."""
    from .fused_quant import quantize

    return quantize(x.contiguous())


def needs_act_quant(layer: nn.Module) -> bool:
    """True for a linear that quantizes its activations: a ``W8A8Linear``,
    or an int4 ``QuantizedLinear`` carrying the w4a8 per-channel
    ``wscale``."""
    from .quantized import QuantizedLinear

    return isinstance(layer, W8A8Linear) or (
        isinstance(layer, QuantizedLinear) and layer.wscale is not None)


class W8A8Linear(nn.Module):
    """w8a8 linear: buffers ``w8`` int8 (out, in) and ``wscale`` fp32
    (out,), an optional ``bias`` in the model dtype. Applied by
    ``ops/common.linear`` through ``w8a8_linear``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("w8", torch.empty(out_features, in_features, dtype=torch.int8,
                                               device=device))
        self.register_buffer("wscale", torch.empty(out_features, dtype=torch.float32,
                                                   device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, dtype=dtype, device=device),
                                  requires_grad=False) if bias else None)

    @classmethod
    def from_host(cls, packed: Dict[str, Optional[np.ndarray]], dtype: torch.dtype,
                  device="cuda") -> "W8A8Linear":
        """From the reference's host format: ``w8`` int8 (in, out),
        transposed here bit for bit, ``wscale`` (out,), ``bias`` or None."""
        in_dim, out_dim = packed["w8"].shape
        bias = packed.get("bias")
        layer = cls(in_dim, out_dim, bias=bias is not None, dtype=dtype, device=device)
        with torch.no_grad():
            layer.w8.copy_(torch.from_numpy(np.ascontiguousarray(np.asarray(packed["w8"],
                                                                            np.int8).T)))
            layer.wscale.copy_(torch.from_numpy(np.asarray(packed["wscale"], np.float32)))
            if bias is not None:
                layer.bias.copy_(torch.from_numpy(np.asarray(bias, np.float32)))
        return layer

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"bias={self.bias is not None}")


def is_w8a8(layer: nn.Module) -> bool:
    return isinstance(layer, W8A8Linear)


# -- host conversion (the reference's numpy, for loaders and tests) ----------


def w8a8_from_kernel_host(w: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-channel symmetric int8 quantisation of an (in, out) float kernel:
    ``wscale = max(max_k |w|, 1e-8) / 127``, ``w8 = clip(round(w /
    wscale), -127, 127)``, in fp32 (the reference's host numpy)."""
    w = np.asarray(w, np.float32)
    amax = np.maximum(np.abs(w).max(axis=0), 1e-8)
    wscale = (amax / 127.0).astype(np.float32)
    w8 = np.clip(np.round(w / wscale[None, :]), -127, 127).astype(np.int8)
    return {"w8": w8, "wscale": wscale}


def _unpack_q(p: Dict[str, np.ndarray]) -> np.ndarray:
    """(in, out) fp32 values of the group-affine integer grid: the nibbles of
    ``q4`` words (value j of a word at bits [4j, 4j+4)) or the bytes of
    ``q8``."""
    if "q4" in p:
        packed = np.asarray(p["q4"], np.uint32)
        in8, out_dim = packed.shape
        q = np.empty((in8, 8, out_dim), np.float32)
        for j in range(8):
            q[:, j, :] = ((packed >> np.uint32(4 * j)) & np.uint32(0xF)).astype(np.float32)
        return q.reshape(in8 * 8, out_dim)
    return np.asarray(p["q8"], np.float32)


def w8a8_from_quantized_host(p: Dict[str, np.ndarray]) -> Dict[str, Optional[np.ndarray]]:
    """Re-express a group-affine weight-only linear (``q4`` or ``q8``
    leaves) as w8a8: dequantise ``q * scale + zero`` in fp32 (a product and
    a sum, each rounded), then ``w8a8_from_kernel_host``."""
    q = _unpack_q(p)
    scales = np.asarray(p["scales"], np.float32)
    zeros = np.asarray(p["zeros"], np.float32)
    g = q.shape[0] // scales.shape[0]
    w = q * np.repeat(scales, g, axis=0) + np.repeat(zeros, g, axis=0)
    out = w8a8_from_kernel_host(w)
    out["bias"] = p.get("bias")
    return out


# -- application ----------------------------------------------------------------


def w8a8_linear(layer: W8A8Linear, x, act: Optional[str] = None) -> torch.Tensor:
    """y = act(x @ w (+ bias)) with both operands in int8: x (..., K) float,
    quantized per row by kernel D, or an ``ActQuant`` used as it is; the
    product and the fp32 epilogue ``(acc * xscale) * wscale + bias`` in
    kernel #11; the result in x's dtype. A float x of at most 16 rows (the
    `ada` and embedder projections) goes to #11's GEMV, which quantizes it
    itself, bit for bit as D (``w4a8_matmul.quantize_w8_matmul``).
    ``act="gelu"`` applies the exact erf GELU to the fp32 epilogue value
    before that rounding, as the reference does."""
    from .w4a8_matmul import quantize_w8_matmul, w8_matmul, w8_quantizes_in_gemv

    lead, k = x.shape[:-1], x.shape[-1]
    out_dtype = torch.float32 if act == "gelu" else x.dtype
    bias = layer.bias
    if bias is not None and bias.dtype != out_dtype:
        bias = bias.to(out_dtype)
    if (not isinstance(x, ActQuant) and x.dtype in (torch.bfloat16, torch.float32)
            and w8_quantizes_in_gemv(math.prod(lead), k, layer.out_features)):
        y = quantize_w8_matmul(x.reshape(-1, k).contiguous(), layer.w8, layer.wscale, bias,
                               out_dtype)
    else:
        aq = x if isinstance(x, ActQuant) else quantize_float(x)
        y = w8_matmul(aq.x8.reshape(-1, k), layer.w8, layer.wscale, aq.xscale.reshape(-1, 1),
                      bias, out_dtype)
    if act == "gelu":
        y = F.gelu(y).to(x.dtype)
    return y.reshape(*lead, y.shape[-1])


# -- conversion on the device ---------------------------------------------------


@torch.no_grad()
def _w8a8_from_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(w8, wscale)`` of an (out, in) weight on its own device: the host
    function's grid, computed in fp32 with IEEE divisions."""
    w = w.float()
    amax = w.abs().amax(dim=1).clamp_min(1e-8)
    wscale = amax / torch.full_like(amax, 127.0)
    w8 = torch.round(w / wscale[:, None]).clamp_(-127, 127).to(torch.int8)
    return w8, wscale


@torch.no_grad()
def random_w8a8_linear_(layer: W8A8Linear, generator: torch.Generator,
                        scale: float = 0.02) -> W8A8Linear:
    """Fill a W8A8Linear in place as the reference's ``random_w8a8_linear``:
    ``w8`` uniform on [-127, 127], ``wscale = scale / 127``, zero bias;
    drawn on the layer's device from ``generator``."""
    layer.w8.random_(-127, 128, generator=generator)
    layer.wscale.fill_(scale / 127.0)
    if layer.bias is not None:
        layer.bias.zero_()
    return layer


# The reference's w8a8_tree rule: a float linear converts when it holds at
# least this many weights. Unlike the weight-only modes there is no minimum
# dimension (its min_dim is 0): int8 noise on the narrow adapters is mild.
W8A8_MIN_SIZE = 1 << 16


@torch.no_grad()
def w8a8_layer(layer: nn.Module) -> nn.Module:
    """One linear in w8a8 form, on its own device, by the reference's
    ``w8a8_tree`` rules: an ``nn.Linear`` with at least ``W8A8_MIN_SIZE``
    weights; any packed ``QuantizedLinear`` (dequantised in fp32, then
    requantised per channel). Other modules, and a ``W8A8Linear``, pass
    through."""
    from .quantized import QuantizedLinear, dequantize

    if isinstance(layer, nn.Linear):
        w = layer.weight
        if w.numel() < W8A8_MIN_SIZE:
            return layer
        dtype, bias = w.dtype, layer.bias
    elif isinstance(layer, QuantizedLinear):
        w = dequantize(layer).t()
        dtype = layer.bias.dtype if layer.bias is not None else torch.bfloat16
        bias = layer.bias
    else:
        return layer
    out = W8A8Linear(w.shape[1], w.shape[0], bias=bias is not None, dtype=dtype,
                     device=w.device)
    w8, wscale = _w8a8_from_weight(w)
    out.w8.copy_(w8)
    out.wscale.copy_(wscale)
    if bias is not None:
        out.bias.copy_(bias)
    return out


def w8a8_module_(module: nn.Module) -> nn.Module:
    """Replace every eligible linear under ``module`` by its w8a8 form, in
    place, each on its own device (the reference's ``w8a8_tree``). Returns
    ``module``."""
    for name, child in list(module.named_children()):
        converted = w8a8_layer(child)
        if converted is not child:
            setattr(module, name, converted)
        else:
            w8a8_module_(child)
    return module
