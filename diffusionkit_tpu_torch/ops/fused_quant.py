"""Kernel A: the fused AdaLN LayerNorm ``mod_ln`` (float path).

Replaces the Pallas kernel ``diffusionkit_tpu/ops/fused_quant.py:mod_ln``
(``_mod_ln_kernel`` -> ``_ln_modulate``), which runs at four sites per SD3
block and once in the final layer. The CUDA source is ``csrc/mod_ln.cu``:
memory-bound (one read of x, one write), one block per row with the row in
registers and 16-byte accesses; see the note there.

``mod_ln`` launches the kernel for a CUDA tensor and raises on what the
kernel does not take; a CPU tensor goes to ``mod_ln_plain``, the same math
in plain torch. The quantizing siblings (``mod_ln_quantize``,
``gelu_quantize``, ``quantize``) wait for the quantized slices.
"""

from __future__ import annotations

import torch

from . import kernels

_KERNELS = {torch.bfloat16: "dk_mod_ln_bf16", torch.float32: "dk_mod_ln_f32"}


def mod_ln_plain(
    x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Plain torch ``mod_ln``: per row fp32 mean and centred variance,
    ``(x - mean) * rsqrt(var + eps) * (1 + scale) + shift`` in fp32, one
    rounding to x's dtype (unlike ``modulated_layer_norm``, which rounds
    before modulating)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    h = xc * torch.rsqrt(var + eps)
    return (h * (1.0 + scale.float()) + shift.float()).to(x.dtype)


def mod_ln(
    x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Fused AdaLN LayerNorm ``norm(x) * (1 + scale) + shift``.

    x: (B, S, H) contiguous; shift, scale: (B, 1, H) with a contiguous
    last axis (views of the modulation vector are read in place).
    """
    if x.device.type == "cpu":
        return mod_ln_plain(x, shift, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"mod_ln: unsupported device {x.device}")
    if x.dtype not in _KERNELS:
        raise TypeError(f"mod_ln: dtype {x.dtype} not supported (bf16, fp32)")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"mod_ln: x must be a contiguous (B, S, H) tensor, got {tuple(x.shape)}")
    b, s, h = x.shape
    vec = 16 // x.element_size()
    if h % vec or h // vec > 1024:
        raise ValueError(f"mod_ln: hidden {h} must be a multiple of {vec} and <= {1024 * vec}")
    for name, m in (("shift", shift), ("scale", scale)):
        if m.shape != (b, 1, h) or m.dtype != x.dtype or m.device != x.device:
            raise ValueError(f"mod_ln: {name} must be ({b}, 1, {h}) {x.dtype} on {x.device}")
        if m.stride(-1) != 1 or m.stride(0) % vec or m.data_ptr() % 16:
            raise ValueError(f"mod_ln: {name} must have a contiguous, 16-byte aligned last axis")
    if shift.stride(0) != scale.stride(0):
        raise ValueError("mod_ln: shift and scale must share a batch stride")
    if x.data_ptr() % 16:
        raise ValueError("mod_ln: x must be 16-byte aligned")
    out = torch.empty_like(x)
    fn = getattr(kernels.library(), _KERNELS[x.dtype])
    err = fn(x.data_ptr(), shift.data_ptr(), scale.data_ptr(), out.data_ptr(),
             b, s, h, shift.stride(0), float(eps), kernels.stream_ptr(x.device))
    kernels.check(err, "mod_ln")
    mod_ln.launches += 1
    return out


mod_ln.launches = 0
