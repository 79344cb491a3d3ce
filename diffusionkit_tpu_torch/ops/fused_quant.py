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

Beside them, two-pass forms for rows split over tensor-parallel ranks:
D's and #4's (``row_absmax``, ``quantize_amax``, in D's geometry), and
kernel E's gelu_quant epilogue over 512-column scale tiles that straddle
ranks (``tile_absmax``, ``tile_quantize``: a split w4a8 FFN whose local
hidden is not whole tiles; pass 1 reads only the tiles a rank holds in
part, pass 2 quantizes the whole tiles on their own absmax in one read).

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
from .w4a8_matmul import SCALE_TILE, _div, gelu_as
from .w8a8 import ActQuant, quantize_activations

_KERNELS = {torch.bfloat16: "dk_mod_ln_bf16", torch.float32: "dk_mod_ln_f32"}
_QUANT_KERNELS = {torch.bfloat16: "dk_quantize_bf16", torch.float32: "dk_quantize_f32"}
_MOD_LN_QUANT_KERNELS = {torch.bfloat16: "dk_mod_ln_quant_bf16",
                         torch.float32: "dk_mod_ln_quant_f32"}
_GELU_QUANT_KERNELS = {torch.bfloat16: "dk_gelu_quantize_bf16",
                       torch.float32: "dk_gelu_quantize_f32"}
GELU_FORMS = {"erf": 0, "tanh": 1}
_TWO_PASS_KERNELS = {torch.bfloat16: "dk_quantize_two_pass_bf16",
                     torch.float32: "dk_quantize_two_pass_f32"}
# The two-pass form's row value: the GELU forms (#4), or y itself (D).
TWO_PASS_FORMS = {"erf": 0, "tanh": 1, None: 2}
# The one-pass kernel each form is the two-pass form of.
TWO_PASS_OF = {"erf": "gelu_quantize", "tanh": "gelu_quantize", None: "quantize"}
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


def _row_values(y: torch.Tensor, form) -> torch.Tensor:
    """The fp32 values a row quantizes: y, or its GELU in ``form``."""
    if form not in TWO_PASS_FORMS:
        raise ValueError(f"quantize_two_pass: unknown GELU form {form!r}")
    if form is None:
        return y.float()
    return (gelu_as if form == "erf" else gelu_tanh)(y.float())


def row_absmax_plain(y: torch.Tensor, form=None) -> torch.Tensor:
    """Plain torch ``row_absmax``: each row's max |value|, fp32 (..., 1)."""
    return _row_values(y, form).abs().amax(dim=-1, keepdim=True)


def quantize_amax_plain(y: torch.Tensor, amax: torch.Tensor, form=None) -> ActQuant:
    """Plain torch ``quantize_amax``: the rows of y (or of their GELU) on the
    grid of the given fp32 absmax (..., 1), ``quantize_activations``'
    arithmetic: ``max(amax, 1e-8) / 127`` by IEEE division, round half to
    even, clip."""
    v = _row_values(y, form)
    xscale = amax.float().clamp_min(1e-8)
    xscale = xscale / torch.full_like(xscale, 127.0)
    x8 = torch.round(v / xscale).clamp_(-127, 127).to(torch.int8)
    return ActQuant(x8, xscale, None, out_dtype=y.dtype)


def _two_pass_launch(name: str, n_pass: int, y: torch.Tensor, amax: torch.Tensor, form,
                     x8=None, xscale=None) -> None:
    """One pass of the two-pass kernel on checked rows: y contiguous and
    16-byte aligned, bf16 or fp32, K a multiple of the 16-byte vector."""
    if y.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {y.device}")
    if y.dtype not in _TWO_PASS_KERNELS:
        raise TypeError(f"{name}: dtype {y.dtype} not supported (bf16, fp32)")
    if not y.is_contiguous() or y.data_ptr() % 16:
        raise ValueError(f"{name}: y must be contiguous and 16-byte aligned")
    k = y.shape[-1]
    vec = 16 // y.element_size()
    if k == 0 or k % vec or k > MAX_ROW:
        raise ValueError(f"{name}: K={k} must be a multiple of {vec} and <= {MAX_ROW}")
    m = y.numel() // k
    if amax.dtype != torch.float32 or amax.numel() != m or not amax.is_contiguous() \
            or amax.device != y.device:
        raise ValueError(f"{name}: amax must be contiguous fp32 with one value a row on "
                         f"{y.device}")
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    err = getattr(kernels.library(), _TWO_PASS_KERNELS[y.dtype])(
        n_pass, TWO_PASS_FORMS[form], y.data_ptr(), amax.data_ptr(), ptr(x8), ptr(xscale), m, k,
        kernels.stream_ptr(y.device))
    kernels.check(err, name)


def row_absmax(y: torch.Tensor, form=None) -> torch.Tensor:
    """Pass 1 of the two-pass D (``form`` None) or #4 (``form`` "erf" or
    "tanh"): each row's local max |value| (of the GELU for #4), fp32
    (..., 1). Takes on the card y bf16 or fp32, contiguous and 16-byte
    aligned, K a multiple of the 16-byte vector and at most ``MAX_ROW``."""
    if y.device.type == "cpu":
        return row_absmax_plain(y, form)
    if form not in TWO_PASS_FORMS:
        raise ValueError(f"row_absmax: unknown GELU form {form!r}")
    amax = torch.empty((*y.shape[:-1], 1), dtype=torch.float32, device=y.device)
    if y.numel():
        _two_pass_launch("row_absmax", 1, y, amax, form)
        row_absmax.launches[TWO_PASS_OF[form]] += 1
    return amax


def quantize_amax(y: torch.Tensor, amax: torch.Tensor, form=None) -> ActQuant:
    """Pass 2 of the two-pass D or #4: the rows of y (or of their GELU) on
    the grid of ``amax`` (..., 1), the whole rows' absmax:
    ``ActQuant(x8, xscale (..., 1), None, y.dtype)``, kernel D's or #4's
    grid bit for bit. Takes on the card what ``row_absmax`` takes."""
    if y.device.type == "cpu":
        return quantize_amax_plain(y, amax, form)
    if form not in TWO_PASS_FORMS:
        raise ValueError(f"quantize_amax: unknown GELU form {form!r}")
    x8 = torch.empty(y.shape, dtype=torch.int8, device=y.device)
    xscale = torch.empty((*y.shape[:-1], 1), dtype=torch.float32, device=y.device)
    if y.numel():
        _two_pass_launch("quantize_amax", 2, y, amax, form, x8, xscale)
        quantize_amax.launches[TWO_PASS_OF[form]] += 1
    return ActQuant(x8, xscale, None, out_dtype=y.dtype)


row_absmax.launches = {"quantize": 0, "gelu_quantize": 0}
quantize_amax.launches = {"quantize": 0, "gelu_quantize": 0}


def quantize_two_pass(y: torch.Tensor, group, form=None) -> ActQuant:
    """Per-row int8 quantization of rows split over the ranks of ``group``
    (each rank holds its K / n of every row): ``row_absmax``, the max
    all-reduced over the group, then ``quantize_amax``; D's grid with
    ``form`` None, #4's (the GELU first) with "erf" or "tanh". A strided y
    is copied first, as the kernels read whole contiguous rows."""
    from ..parallel.collectives import all_reduce_max

    y = y.contiguous()
    amax = all_reduce_max(row_absmax(y, form), group)
    return quantize_amax(y, amax, form)


def _hidden_tiles(n: int, col0: int, device) -> torch.Tensor:
    """The global scale tile of each of a rank's n hidden columns from
    ``col0``."""
    return torch.arange(col0, col0 + n, device=device) // SCALE_TILE


def _local_tiles(n: int, col0: int) -> slice:
    """The global tiles a rank's n hidden columns from ``col0`` touch."""
    return slice(col0 // SCALE_TILE, (col0 + n - 1) // SCALE_TILE + 1)


def _whole_tiles(n: int, col0: int) -> slice:
    """The global tiles a rank's n hidden columns from ``col0`` hold whole."""
    return slice(-(-col0 // SCALE_TILE), (col0 + n) // SCALE_TILE)


def straddled_tiles(hidden: int, n: int) -> list:
    """The scale tiles of a hidden of ``hidden`` columns split evenly over n
    ranks that straddle a rank boundary, in order: the only tiles whose
    absmax the ranks must all-reduce (every other tile is one rank's whole,
    or no rank's in part). Every rank gets the same list."""
    bounds = (r * hidden // n for r in range(1, n))
    return sorted({b // SCALE_TILE for b in bounds if b % SCALE_TILE})


def _tile_maxima(g: torch.Tensor, col0: int, n_tiles: int) -> torch.Tensor:
    """The max |GELU| (``gelu_as``) of each row of g over its columns in
    each scale tile, fp32 (M, n_tiles), 0 in the tiles g holds no column
    of."""
    v = gelu_as(g.float()).abs()
    amax = torch.zeros((g.shape[0], n_tiles), dtype=torch.float32, device=g.device)
    return amax.scatter_reduce_(1, _hidden_tiles(g.shape[1], col0, g.device).expand_as(v), v,
                                "amax")


def tile_absmax_plain(g: torch.Tensor, col0: int, n_tiles: int) -> torch.Tensor:
    """Plain torch ``tile_absmax``: the max |GELU| of each row of g over its
    columns in each tile it holds in part, fp32 (M, n_tiles), 0 in the
    tiles it holds whole and in those it holds no column of."""
    amax = _tile_maxima(g, col0, n_tiles)
    amax[:, _whole_tiles(g.shape[1], col0)] = 0.0
    return amax


def tile_quantize_plain(g: torch.Tensor, amax: torch.Tensor, col0: int):
    """Plain torch ``tile_quantize``: E's gelu_quant grid by tile,
    ``(y8, yscale)``: a tile's absmax is g's own in the tiles g holds whole
    and ``amax``'s (the group's) in those it holds in part; ``a = max(absmax,
    1e-8)``, ``y8 = clip(rne(GELU(g) * (127 / a)))``, ``yscale = a / 127``
    in the tiles g holds columns of, 0 elsewhere."""
    n = g.shape[1]
    whole = _whole_tiles(n, col0)
    a = amax.float().clone()
    a[:, whole] = _tile_maxima(g, col0, amax.shape[-1])[:, whole]
    a = a.clamp_min(1e-8)
    tile = _hidden_tiles(n, col0, g.device)
    y8 = torch.round(gelu_as(g.float()) * _div(127.0, a)[:, tile]).clamp_(-127, 127)
    yscale = torch.zeros_like(a)
    local = _local_tiles(n, col0)
    yscale[:, local] = a[:, local] / torch.full_like(a[:, local], 127.0)
    return y8.to(torch.int8), yscale


def _tile_launch(name: str, n_pass: int, g: torch.Tensor, amax: torch.Tensor, col0: int,
                 y8=None, yscale=None) -> None:
    if g.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {g.device}")
    if g.dtype != torch.float32 or g.ndim != 2 or not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError(f"{name}: g must be contiguous fp32 (M, N), 16-byte aligned")
    m, n = g.shape
    if n % 4 or col0 % 4:
        raise ValueError(f"{name}: N={n} and col0={col0} must be multiples of 4")
    n_tiles = amax.shape[-1]
    if amax.dtype != torch.float32 or amax.shape != (m, n_tiles) or not amax.is_contiguous() \
            or amax.device != g.device or n_tiles * SCALE_TILE < col0 + n:
        raise ValueError(f"{name}: amax must be contiguous fp32 (M, tiles) on {g.device}, the "
                         f"tiles covering columns {col0} + {n}")
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    err = kernels.library().dk_tile_gelu_quantize(
        n_pass, g.data_ptr(), amax.data_ptr(), ptr(y8), ptr(yscale), m, n, col0, SCALE_TILE,
        n_tiles, kernels.stream_ptr(g.device))
    kernels.check(err, name)


def tile_absmax(g: torch.Tensor, col0: int, n_tiles: int) -> torch.Tensor:
    """Pass 1 of E's gelu_quant epilogue over scale tiles split between
    ranks: g (M, N) fp32, fc1's pre-GELU output on this rank, its column 0
    the hidden's column ``col0``; returns each row's max |GELU| over its
    columns in each of the hidden's ``n_tiles`` 512-column tiles that it
    holds in part (a tile straddling a rank boundary), fp32 (M, n_tiles), 0
    in the tiles it holds whole and in those it holds no column of. The
    group's max all-reduce of the straddled tiles' columns
    (``straddled_tiles``) then gives those tiles' absmax; ``tile_quantize``
    takes a whole tile's itself. On the card N and col0 multiples of 4."""
    if g.device.type == "cpu":
        return tile_absmax_plain(g, col0, n_tiles)
    if not g.numel():
        return torch.zeros((g.shape[0], n_tiles), dtype=torch.float32, device=g.device)
    amax = torch.empty((g.shape[0], n_tiles), dtype=torch.float32, device=g.device)
    _tile_launch("tile_absmax", 1, g, amax, col0)
    tile_absmax.launches += 1
    return amax


def tile_quantize(g: torch.Tensor, amax: torch.Tensor, col0: int):
    """Pass 2: g's GELU on E's gelu_quant grid by tile, ``(y8 (M, N) int8,
    yscale (M, n_tiles) fp32)``, each tile's absmax g's own where g holds
    the tile whole and the group's ``amax`` (M, n_tiles) where it holds it
    in part; yscale 0 in the tiles g holds no column of. Side by side over
    the ranks, E's gelu_quant output on the whole hidden bit for bit.
    Takes on the card what ``tile_absmax`` takes."""
    if g.device.type == "cpu":
        return tile_quantize_plain(g, amax, col0)
    y8 = torch.empty(g.shape, dtype=torch.int8, device=g.device)
    if not g.numel():
        return y8, torch.zeros_like(amax)
    yscale = torch.empty_like(amax)
    _tile_launch("tile_quantize", 2, g, amax, col0, y8, yscale)
    tile_quantize.launches += 1
    return y8, yscale


tile_absmax.launches = 0
tile_quantize.launches = 0


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
