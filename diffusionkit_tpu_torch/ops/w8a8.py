"""Dynamic int8 activations: the ``ActQuant`` pair and its per-row grid.

Counterpart of ``diffusionkit_tpu/ops/w8a8.py:36-161`` for the w4a8 mode.
Activations are quantized per row (per token), symmetrically:

  amax   = max(max_k |x[m, k]|, 1e-8)        (fp32)
  xscale = amax / 127                         (IEEE division)
  x8     = clip(round_half_even(x / xscale), -127, 127)

A quantized linear then computes ``(x8 @ w8) * xscale * wscale + bias``
with exact int32 accumulation. ``ActQuant`` carries one quantized activation
to several sibling linears (q/k/v, and FLUX's parallel-MLP fc1), so the
quantization runs once. The w8a8 weight format, ``w8a8_linear`` and the
w8a8 tree conversion wait for the w8a8 mode.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
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
    from .fused_quant import quantize

    aq = quantize(x)
    return ActQuant(aq.x8, aq.xscale, x)


def needs_act_quant(layer: nn.Module) -> bool:
    """True for a linear that quantizes its activations: an int4
    ``QuantizedLinear`` carrying the w4a8 per-channel ``wscale``."""
    from .quantized import QuantizedLinear

    return isinstance(layer, QuantizedLinear) and layer.wscale is not None
