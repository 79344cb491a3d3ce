"""Row-wise fused kernels: AdaLN LayerNorm and per-row int8 quantization.

Four kernels of ``csrc/mod_ln.cu``, each replacing a Pallas kernel of
``diffusionkit_tpu/ops/fused_quant.py``:

- kernel A ``mod_ln`` (``_mod_ln_kernel`` -> ``_ln_modulate``): the float
  AdaLN LayerNorm, at four sites per SD3 block and in every final layer;
- kernel A' ``mod_ln_quantize`` (``_mod_ln_quant_kernel``): the same
  LayerNorm and modulation in fp32, NOT rounded to x's dtype, quantized per
  row to int8 for the w4a8 linears that read it (q/k/v, fc1);
- kernel D ``quantize`` (``_quant_kernel``): the per-row absmax -> int8
  pass in front of a w4a8 or w8a8 linear whose input is float (``ada``,
  ``o``, the embedders, T5's ``out_proj`` and ``wo``; a w8a8 linear of at
  most 16 rows quantizes inside #11's GEMV instead, bit for bit as D);
- kernel #4 ``gelu_quantize`` (``_gelu_quant_kernel``): the A&S-erf (or
  tanh) GELU of fc1's output quantized per row for fc2, in every w8a8 FFN
  and any w4a8 FFN the fused kernel-E chain does not take.

Each reads its rows once and keeps them in registers, with 16-byte
accesses: A one block a row; A' and D a warp (or a few) a row, several
rows a block, every load issued before the first reduction; #4, which is
bound by its instruction issue rather than the memory, a block a row with
several vectors a thread. A', D and #4 quantize without a per-element
division, bit for bit the reference's grid; see the note in the source.
Each wrapper launches its kernel for a CUDA tensor and raises on what the
kernel does not take; a CPU tensor goes to the plain torch version beside
it. The quantizers return an ``ActQuant`` with ``orig=None``.
"""

from __future__ import annotations

import torch

from . import kernels
from .w4a8_matmul import gelu_as
from .w8a8 import ActQuant, quantize_activations

_KERNELS = {torch.bfloat16: "dk_mod_ln_bf16", torch.float32: "dk_mod_ln_f32"}
_QUANT_KERNELS = {torch.bfloat16: "dk_quantize_bf16", torch.float32: "dk_quantize_f32"}
_MOD_LN_QUANT_KERNELS = {torch.bfloat16: "dk_mod_ln_quant_bf16",
                         torch.float32: "dk_mod_ln_quant_f32"}
_GELU_QUANT_KERNELS = {torch.bfloat16: "dk_gelu_quantize_bf16",
                       torch.float32: "dk_gelu_quantize_f32"}
GELU_FORMS = {"erf": 0, "tanh": 1}
# Widest row kernels D and #4 take (D: 8 warps of 8 bf16 or 16 fp32
# vectors a lane).
MAX_ROW = 16384


def _ln_modulate_f32(x, shift, scale, eps: float) -> torch.Tensor:
    """Per row fp32 mean and centred variance, then ``(x - mean) *
    rsqrt(var + eps) * (1 + scale) + shift``, all in fp32."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    h = xc * torch.rsqrt(var + eps)
    return h * (1.0 + scale.float()) + shift.float()


def mod_ln_plain(
    x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Plain torch ``mod_ln``: the fp32 LayerNorm and modulation, one
    rounding to x's dtype (unlike ``modulated_layer_norm``, which rounds
    before modulating)."""
    return _ln_modulate_f32(x, shift, scale, eps).to(x.dtype)


def mod_ln_quantize_plain(
    x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
) -> ActQuant:
    """Plain torch ``mod_ln_quantize``: the fp32 LayerNorm and modulation,
    quantized per row without a rounding to x's dtype in between."""
    x8, xscale = quantize_activations(_ln_modulate_f32(x, shift, scale, eps))
    return ActQuant(x8, xscale, None, out_dtype=x.dtype)


def quantize_plain(y: torch.Tensor) -> ActQuant:
    """Plain torch ``quantize``: the per-row int8 grid of
    ``w8a8.quantize_activations``."""
    x8, xscale = quantize_activations(y)
    return ActQuant(x8, xscale, None, out_dtype=y.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-form GELU, op for op as the reference's ``_gelu_tanh``."""
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x * x * x)))


def gelu_quantize_plain(y: torch.Tensor, form: str = "erf") -> ActQuant:
    """Plain torch ``gelu_quantize``: the fp32 GELU of y (``gelu_as``, the
    reference's A&S erf op for op, or ``gelu_tanh``), then the per-row
    int8 grid of ``quantize_activations``."""
    if form not in GELU_FORMS:
        raise ValueError(f"gelu_quantize: unknown GELU form {form!r}")
    g = (gelu_as if form == "erf" else gelu_tanh)(y.float())
    x8, xscale = quantize_activations(g)
    return ActQuant(x8, xscale, None, out_dtype=y.dtype)


def _check_mod_ln_args(name: str, x, shift, scale) -> None:
    """What kernels A and A' take: a contiguous (B, S, H) x, H a multiple of
    the 16-byte vector and at most 1024 vectors, (B, 1, H) shift/scale
    views with a contiguous 16-byte aligned last axis."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _KERNELS:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (bf16, fp32)")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (B, S, H) tensor, got {tuple(x.shape)}")
    b, s, h = x.shape
    vec = 16 // x.element_size()
    if h % vec or h // vec > 1024:
        raise ValueError(f"{name}: hidden {h} must be a multiple of {vec} and <= {1024 * vec}")
    for arg, m in (("shift", shift), ("scale", scale)):
        if m.shape != (b, 1, h) or m.dtype != x.dtype or m.device != x.device:
            raise ValueError(f"{name}: {arg} must be ({b}, 1, {h}) {x.dtype} on {x.device}")
        if m.stride(-1) != 1 or m.stride(0) % vec or m.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must have a contiguous, 16-byte aligned last axis")
    if shift.stride(0) != scale.stride(0):
        raise ValueError(f"{name}: shift and scale must share a batch stride")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be 16-byte aligned")


def mod_ln(
    x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Fused AdaLN LayerNorm ``norm(x) * (1 + scale) + shift``.

    x: (B, S, H) contiguous; shift, scale: (B, 1, H) with a contiguous
    last axis (views of the modulation vector are read in place).
    """
    if x.device.type == "cpu":
        return mod_ln_plain(x, shift, scale, eps)
    _check_mod_ln_args("mod_ln", x, shift, scale)
    b, s, h = x.shape
    out = torch.empty_like(x)
    fn = getattr(kernels.library(), _KERNELS[x.dtype])
    err = fn(x.data_ptr(), shift.data_ptr(), scale.data_ptr(), out.data_ptr(),
             b, s, h, shift.stride(0), float(eps), kernels.stream_ptr(x.device))
    kernels.check(err, "mod_ln")
    mod_ln.launches += 1
    mod_ln.f32_launches += x.dtype == torch.float32
    return out


mod_ln.launches = 0
mod_ln.f32_launches = 0  # of them, on fp32 rows


def mod_ln_quantize(
    x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
) -> ActQuant:
    """AdaLN LayerNorm fused with per-row int8 quantization of its fp32
    output: ``ActQuant(x8 (B, S, H) int8, xscale (B, S, 1) fp32, None,
    x.dtype)``. Takes what ``mod_ln`` takes."""
    if x.device.type == "cpu":
        return mod_ln_quantize_plain(x, shift, scale, eps)
    _check_mod_ln_args("mod_ln_quantize", x, shift, scale)
    b, s, h = x.shape
    x8 = torch.empty((b, s, h), dtype=torch.int8, device=x.device)
    xscale = torch.empty((b, s, 1), dtype=torch.float32, device=x.device)
    fn = getattr(kernels.library(), _MOD_LN_QUANT_KERNELS[x.dtype])
    err = fn(x.data_ptr(), shift.data_ptr(), scale.data_ptr(), x8.data_ptr(), xscale.data_ptr(),
             b, s, h, shift.stride(0), float(eps), kernels.stream_ptr(x.device))
    kernels.check(err, "mod_ln_quantize")
    mod_ln_quantize.launches += 1
    mod_ln_quantize.f32_launches += x.dtype == torch.float32
    return ActQuant(x8, xscale, None, out_dtype=x.dtype)


mod_ln_quantize.launches = 0
mod_ln_quantize.f32_launches = 0


def _quantize_rows(name: str, symbol: str, y: torch.Tensor, *extra) -> ActQuant:
    """Launch kernel D or #4 (``symbol``) over the rows of y (..., K): y bf16
    or fp32, contiguous and 16-byte aligned, K a multiple of the 16-byte
    vector and at most ``MAX_ROW``."""
    if y.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {y.device}")
    if y.dtype not in _QUANT_KERNELS:
        raise TypeError(f"{name}: dtype {y.dtype} not supported (bf16, fp32)")
    if not y.is_contiguous() or y.data_ptr() % 16:
        raise ValueError(f"{name}: y must be contiguous and 16-byte aligned")
    k = y.shape[-1]
    vec = 16 // y.element_size()
    if k == 0 or k % vec or k > MAX_ROW:
        raise ValueError(f"{name}: K={k} must be a multiple of {vec} and <= {MAX_ROW}")
    m = y.numel() // k
    x8 = torch.empty(y.shape, dtype=torch.int8, device=y.device)
    xscale = torch.empty((*y.shape[:-1], 1), dtype=torch.float32, device=y.device)
    if m:
        fn = getattr(kernels.library(), symbol)
        err = fn(y.data_ptr(), x8.data_ptr(), xscale.data_ptr(), m, k, *extra,
                 kernels.stream_ptr(y.device))
        kernels.check(err, name)
    return ActQuant(x8, xscale, None, out_dtype=y.dtype)


def quantize(y: torch.Tensor) -> ActQuant:
    """Per-row absmax int8 quantization of y (..., K): ``ActQuant(x8,
    xscale (..., 1), None, y.dtype)``. On the card y is bf16 or fp32,
    contiguous and 16-byte aligned, K a multiple of the 16-byte vector and
    at most 16384."""
    if y.device.type == "cpu":
        return quantize_plain(y)
    aq = _quantize_rows("quantize", _QUANT_KERNELS.get(y.dtype), y)
    if y.numel():
        quantize.launches += 1
        quantize.f32_launches += y.dtype == torch.float32
    return aq


quantize.launches = 0
quantize.f32_launches = 0


def gelu_quantize(y: torch.Tensor, form: str = "erf") -> ActQuant:
    """GELU fused with per-row int8 quantization: ``ActQuant(x8 (..., N),
    xscale (..., 1), None, y.dtype)`` for the quantized fc2 that follows.
    ``form`` is the reference's ``_gelu_form``: "erf" (the A&S erf, its
    default) or "tanh". Takes on the card what ``quantize`` takes."""
    if form not in GELU_FORMS:
        raise ValueError(f"gelu_quantize: unknown GELU form {form!r}")
    if y.device.type == "cpu":
        return gelu_quantize_plain(y, form)
    aq = _quantize_rows("gelu_quantize", _GELU_QUANT_KERNELS.get(y.dtype), y, GELU_FORMS[form])
    if y.numel():
        gelu_quantize.launches += 1
    return aq


gelu_quantize.launches = 0
