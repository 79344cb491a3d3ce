"""Kernel C: matmul with fused int4 dequantisation.

Replaces the Pallas kernel ``diffusionkit_tpu/ops/int4_matmul.py:int4_matmul``
(``_kernel``), which runs every block linear of the int4 MMDiT (FLUX.1-schnell
4-bit: q/k/v/o/fc1/fc2 and the AdaLN ``ada`` projections of 19 dual-stream
and 38 single-stream blocks). It computes ``y[M, N] = x[M, K] @ W`` where
``W = q * scale + zero`` is dequantised in fp32 from the packed words of
``ops/quantized.py``, ROUNDED TO x's DTYPE before the product, accumulated
in fp32 and rounded once. The CUDA source is ``csrc/int4_matmul.cu``; the
note there says what bounds it and how it is tiled.

``int4_matmul`` launches the kernel for a CUDA tensor and raises on what it
does not take (bf16 x, K a multiple of 64, N of 128, group 32 or a multiple
of 64); a CPU tensor goes to ``int4_matmul_plain``, the same math in plain
torch. The reference's TPU tile pickers (``pick_k_block``, ``pick_m_block``,
``_maybe_pad_n``) and its padding of M are not carried over: the kernel
masks the ragged M edge itself.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import kernels

# Kernel tiling constraints (csrc/int4_matmul.cu).
K_TILE, N_TILE = 64, 128


def dequantize_int4(
    q4: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """(K/8, N) packed words -> (K, N) weights: nibbles to fp32, ``q * scale
    + zero`` in fp32 (a product and a sum, each rounded), then one rounding
    to ``dtype``."""
    k8, n = q4.shape
    shifts = torch.arange(0, 32, 4, dtype=torch.int32, device=q4.device)
    q = (q4[:, None, :] >> shifts[None, :, None]) & 0xF
    q = q.reshape(k8 * 8, n).float()
    g = q.shape[0] // scales.shape[0]
    s = scales.float().repeat_interleave(g, dim=0)
    z = zeros.float().repeat_interleave(g, dim=0)
    return (q * s + z).to(dtype)


def int4_matmul_plain(
    x: torch.Tensor, q4: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor
) -> torch.Tensor:
    """Plain torch ``int4_matmul``: the weight dequantised and rounded to x's
    dtype, then one matmul (fp32 accumulation, one rounding)."""
    return torch.matmul(x, dequantize_int4(q4, scales, zeros, x.dtype))


def int4_matmul(
    x: torch.Tensor, q4: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor
) -> torch.Tensor:
    """y[M, N] = x[M, K] @ dequant(q4, scales, zeros), in x's dtype.

    On CUDA: x bf16 with a contiguous last axis and 16-byte aligned rows
    (other row strides, such as a slice of a wider activation, are read in
    place); q4 int32 (K/8, N), scales and zeros fp32 (K/g, N), contiguous.
    """
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q4, scales, zeros)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"int4_matmul: x must be bf16 on the card, got {x.dtype}")
    if x.ndim != 2 or q4.ndim != 2:
        raise ValueError(f"int4_matmul: x (M, K) and q4 (K/8, N), got {tuple(x.shape)}, "
                         f"{tuple(q4.shape)}")
    m, k = x.shape
    k8, n = q4.shape
    if k8 * 8 != k or k % K_TILE or n % N_TILE:
        raise ValueError(f"int4_matmul: K={k} must be 8 * {k8} and a multiple of {K_TILE}, "
                         f"N={n} a multiple of {N_TILE}")
    groups = scales.shape[0]
    if groups == 0 or k % groups:
        raise ValueError(f"int4_matmul: {groups} scale rows do not divide K={k}")
    group = k // groups
    if not (group == 32 or group % 64 == 0):
        raise ValueError(f"int4_matmul: group size {group} must be 32 or a multiple of 64")
    if q4.dtype != torch.int32 or scales.dtype != torch.float32 or zeros.dtype != torch.float32:
        raise TypeError("int4_matmul: q4 int32, scales and zeros fp32")
    for name, t in (("q4", q4), ("scales", scales), ("zeros", zeros)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int4_matmul: {name} must be contiguous and 16-byte aligned on "
                             f"{x.device}")
    if scales.shape != (groups, n) or zeros.shape != (groups, n):
        raise ValueError(f"int4_matmul: scales and zeros must be ({groups}, {n})")
    if x.stride(1) != 1 or x.stride(0) % 8 or x.data_ptr() % 16:
        raise ValueError(f"int4_matmul: x needs a contiguous last axis and 16-byte aligned rows, "
                         f"got strides {x.stride()}")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    err = kernels.library().dk_int4_matmul_bf16(
        x.data_ptr(), q4.data_ptr(), scales.data_ptr(), zeros.data_ptr(), y.data_ptr(),
        m, n, k, group, x.stride(0), kernels.stream_ptr(x.device),
    )
    kernels.check(err, "int4_matmul")
    int4_matmul.launches += 1
    return y


int4_matmul.launches = 0


def int4_linear(layer, x: torch.Tensor, act: Optional[str] = None) -> torch.Tensor:
    """Apply a ``QuantizedLinear`` to x (..., K) -> (..., N), as the
    reference's ``int4_linear``: the product rounded to x's dtype, then the
    bias added in fp32 and rounded again, then the exact (erf) GELU in x's
    dtype."""
    lead, k = x.shape[:-1], x.shape[-1]
    y = int4_matmul(x.reshape(-1, k), layer.q4, layer.scales, layer.zeros)
    y = y.reshape(*lead, y.shape[-1])
    if layer.bias is not None:
        y = (y.float() + layer.bias.float()).to(x.dtype)
    if act == "gelu":
        y = F.gelu(y)
    return y
