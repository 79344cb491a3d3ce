"""The port's CUDA kernels against their plain torch versions.

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch. The ``gpu``-marked tests build the kernels
with nvcc and need a CUDA device; elsewhere they skip. On the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest configures JAX.) Inputs come from a
seeded ``torch.Generator``; the reference is the plain version run on fp32
upcasts of the same bf16 inputs.
"""

import numpy as np
import pytest
import torch

from diffusionkit_tpu_torch.ops import kernels
from diffusionkit_tpu_torch.ops.attention import sdpa, xla_sdpa
from diffusionkit_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_bshd,
    flash_attention_bshd_plain,
    flash_attention_plain,
    flash_attention_stats,
    flash_attention_stats_plain,
    wide_split,
)
from diffusionkit_tpu_torch.ops.fused_quant import (
    gelu_quantize,
    gelu_quantize_plain,
    mod_ln,
    mod_ln_plain,
    mod_ln_quantize,
    mod_ln_quantize_plain,
    quantize,
    quantize_amax,
    quantize_plain,
    row_absmax,
)
from diffusionkit_tpu_torch.ops.int4_matmul import (
    dequantize_int4,
    dequantize_int8,
    int4_matmul,
    int8_matmul,
)
from diffusionkit_tpu_torch.ops.quantized import QuantizedLinear, wscale_from_q4
from diffusionkit_tpu_torch.ops.w4a8_matmul import (
    quantize_w8_matmul,
    quantize_w8_matmul_plain,
    w4a8_matmul,
    w4a8_matmul_plain,
    w8_matmul,
    w8_matmul_plain,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """Every test of this file on one intra-op thread, set and restored
    around it: the line above runs when the module is imported, and a
    pytest-xdist worker imports every test file before it runs any, so a
    count set at import time by a later file would hold here. The CPU
    comparisons below hold two calls of one fp32 function bit for bit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# Main-path shapes of SD3-medium at 512² with CFG (batch 2): AdaLN sites on
# the image (1024 tokens) and text (154 tokens) streams, the joint attention
# (1024 + 154 tokens, 24 heads of 64) and the VAE mid-block (64x64 positions,
# one head of 512); FLUX.1 at 1024²: the joint attention (256 + 4096 tokens,
# 24 heads of 128). Plus small ragged shapes, and at d=64 and 128 the Hopper
# kernel's tile edges: S one past and one short of its 128-row / 128-key
# tiles, and S = 16, below one box.
MOD_LN_SHAPES = [(2, 1024, 1536), (2, 154, 1536), (1, 37, 256)]
TILE_EDGES = (128, 129, 255, 1153, 16)
FLASH_SHAPES = [(2, 1178, 24, 64), (1, 4096, 1, 512), (1, 77, 3, 64), (2, 300, 1, 512),
                (1, 4352, 24, 128), (1, 77, 3, 128)] + [
                    (1, s, 2, d) for d in (64, 128) for s in TILE_EDGES]
# (M, K, N, group) of kernel C: FLUX's unified-block q and fc2, an `ada`
# GEMV, the text stream at group 32, and ragged M at two tile heights.
INT4_SHAPES = [(4352, 3072, 3072, 64), (4352, 12288, 3072, 64), (1, 3072, 18432, 64),
               (256, 3072, 3072, 32), (77, 512, 256, 64), (1300, 1024, 384, 128)]


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    mag = x.abs().clamp_min(2.0**-126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def assert_flash_close(got: torch.Tensor, want: torch.Tensor) -> None:
    """Kernel B in bf16 against fp32 math, per element: one bf16 ulp of the
    exact value (the output rounding, across a binade edge) plus 2^-8 of the
    largest |output| for P rounded to bf16 before P.V. The plain version's
    own bf16 numerics use 0.31-0.40 of this at such shapes; an unmasked
    ragged kv edge exceeds it (2x at S=1178, 27x at S=77)."""
    diff = (got.float() - want).abs()
    bound = bf16_ulp(want) + 2.0**-8 * want.abs().max()
    assert torch.all(diff <= bound), (diff / bound).max().item()


def assert_fp32_flash_close(got: torch.Tensor, want: torch.Tensor) -> None:
    """An fp32 flash kernel against its fp32 plain version, per element:
    2^-16 of the largest |output| (the plain version in another order lands
    at 0.008-0.13 of it on the CPU, tests/test_torch_ops.py; a TF32 product
    or P rounded to bf16 exceeds it by far)."""
    assert got.dtype == want.dtype == torch.float32
    diff = (got - want).abs()
    bound = 2.0**-16 * want.abs().max()
    assert torch.isfinite(got).all() and torch.all(diff <= bound), (diff.max() / bound).item()


def test_cpu_tensors_take_the_plain_versions():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 5, 128, generator=g)
    m = torch.randn(1, 1, 128, generator=g)
    q, k, v = (torch.randn(1, 1100, 1, 64, generator=g) for _ in range(3))
    wrappers = (mod_ln, flash_attention_bshd, flash_attention, flash_attention_stats)
    counts = [fn.launches for fn in wrappers]
    assert torch.equal(mod_ln(x, m, m), mod_ln_plain(x, m, m))
    assert torch.equal(flash_attention_bshd(q, k, v, 0.125), flash_attention_bshd_plain(q, k, v, 0.125))
    # Above the flash threshold, but on the CPU 'auto' keeps the reference path.
    assert torch.equal(sdpa(q, k, v, 0.125, layout="bshd"), xla_sdpa(q, k, v, 0.125, layout="bshd"))
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    assert torch.equal(flash_attention(qh, kh, vh, 0.125), flash_attention_plain(qh, kh, vh, 0.125))
    for got, want in zip(flash_attention_stats(qh, kh, vh, 0.125, 700),
                         flash_attention_stats_plain(qh, kh, vh, 0.125, 700)):
        assert torch.equal(got, want)
    assert [fn.launches for fn in wrappers] == counts


def test_kernel_library_is_keyed_by_source_hash():
    path = kernels.library_path()
    assert path.parent == kernels.BUILD_DIR
    assert kernels.source_hash() in path.name
    assert {p.name for p in kernels.CSRC.glob("*.cu")} >= {"mod_ln.cu", "flash_attention.cu",
                                                             "gemv_sm90.cu", "w8_matmul.cu"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", MOD_LN_SHAPES)
def test_mod_ln_kernel_matches_plain(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, s, h = shape
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).bfloat16()
    mods = torch.randn(b, 6 * h, generator=g, device=cuda).bfloat16()
    shift, scale = mods[:, None, :h], mods[:, None, h : 2 * h]  # strided views
    launches = mod_ln.launches
    got = mod_ln(x, shift, scale)
    torch.cuda.synchronize()
    assert mod_ln.launches == launches + 1
    assert got.dtype == torch.bfloat16 and got.shape == shape
    want = mod_ln_plain(x.float(), shift.float(), scale.float())
    # One rounding of an fp32 value: half a bf16 ulp, plus fp32 noise of
    # the O(1) terms where they cancel to a near-zero output.
    diff = (got.float() - want).abs()
    assert torch.all(diff <= 0.5 * bf16_ulp(want) + 1e-5), diff.max().item()


@pytest.mark.gpu
def test_mod_ln_kernel_fp32(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 50, 384, generator=g, device=cuda)
    m = torch.randn(2, 2, 384, generator=g, device=cuda)
    got = mod_ln(x, m[:, :1], m[:, 1:])
    torch.testing.assert_close(got, mod_ln_plain(x, m[:, :1], m[:, 1:]), atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).bfloat16() for _ in range(3))
    scale = shape[-1] ** -0.5
    launches = flash_attention_bshd.launches
    got = flash_attention_bshd(q, k, v, scale)
    torch.cuda.synchronize()
    assert flash_attention_bshd.launches == launches + 1
    assert got.dtype == torch.bfloat16 and got.shape == shape and got.is_contiguous()
    assert_flash_close(got, flash_attention_bshd_plain(q.float(), k.float(), v.float(), scale))


def _stats_at_300(q, k, v, scale):
    """#14 with the first 300 keys valid, its (o, m, l) joined into one
    tensor so a call compares with torch.equal."""
    return torch.cat([t.flatten() for t in flash_attention_stats(q, k, v, scale, 300)])


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", ["bshd", "bhsd", "stats", "repeat"])
def test_flash_kernel_reads_strided_heads_in_place(cuda, case, d):
    """q/k/v as head slices of one packed (B, S, 3H, D) projection, as a
    fused qkv would give them: kernel B reads the strides directly, and #15
    and #14 the slices' transposed (B, H, S, D) views (the ring's input),
    each bit-identical to its call on contiguous copies; and ("repeat") two
    calls of each kernel on the same inputs are bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(2, 333, 3 * 4, d, generator=g, device=cuda).bfloat16()
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:]
    assert not q.is_contiguous()
    bhsd = tuple(t.transpose(1, 2) for t in (q, k, v))
    views = {"bshd": (flash_attention_bshd, (q, k, v)),
             "bhsd": (flash_attention, bhsd),
             "stats": (_stats_at_300, bhsd)}
    if case == "repeat":
        for fn, args in views.values():
            assert torch.equal(fn(*args, 0.125), fn(*args, 0.125))
        return
    fn, args = views[case]
    got = fn(*args, 0.125)
    want = fn(*(t.contiguous() for t in args), 0.125)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernel_wrappers_raise_on_unsupported_input(cuda):
    q = torch.zeros(1, 8, 2, 256, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bshd(q, q, q, 0.1)
    q = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention_bshd(q, q, q, 0.1)
    x = torch.zeros(1, 8, 128, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        mod_ln(x, x[:, :1], x[:, :1])
    x = torch.zeros(8, 2, 128, device=cuda, dtype=torch.bfloat16).transpose(0, 1)
    m = torch.zeros(2, 1, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        mod_ln(x, m, m)
    x = torch.zeros(1, 8, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="scale > 0"):
        flash_attention_bshd(x[..., None, :64], x[..., None, :64], x[..., None, :64], -1.0)


@pytest.mark.gpu
def test_sdpa_auto_takes_the_kernel_on_the_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    long_q = torch.randn(1, 1100, 2, 64, generator=g, device=cuda).bfloat16()
    short_q = long_q[:, :500].contiguous()
    launches = flash_attention_bshd.launches
    sdpa(short_q, short_q, short_q, 0.125, layout="bshd")
    assert flash_attention_bshd.launches == launches
    sdpa(long_q, long_q, long_q, 0.125, layout="bshd")
    assert flash_attention_bshd.launches == launches + 1
    # fp32 on the card is the kernel's to take too (its fp32 instantiation),
    # never the materialised scores.
    q32 = long_q.float()
    assert_fp32_flash_close(sdpa(q32, q32, q32, 0.125, layout="bshd"),
                            xla_sdpa(q32, q32, q32, 0.125, layout="bshd"))
    assert flash_attention_bshd.launches == launches + 2
    assert_flash_close(
        sdpa(short_q, short_q, short_q, 0.125, impl="flash", layout="bshd"),
        xla_sdpa(short_q.float(), short_q.float(), short_q.float(), 0.125, layout="bshd"),
    )
    # d=128 (FLUX) takes the kernel; d=256 passes the reference's flash
    # predicate but kernel B does not take it: it raises, never falls back.
    q128 = torch.randn(1, 1100, 2, 128, generator=g, device=cuda).bfloat16()
    sdpa(q128, q128, q128, 0.1, layout="bshd")
    assert flash_attention_bshd.launches == launches + 4
    q256 = torch.zeros(1, 1100, 1, 256, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        sdpa(q256, q256, q256, 0.1, layout="bshd")


# The d=512 kernel (B and #15 in bf16): split-KV chunks that end unevenly
# (1100 keys: 6 chunks of 192 on 132 SMs, the last 140), a ragged kv edge
# with two batches (4100: one chunk), FLUX 1024²'s decode (16384), and
# several heads at a ragged length.
WIDE_SHAPES = [(1, 1100, 1, 512), (2, 4100, 1, 512), (1, 16384, 1, 512), (3, 77, 2, 512)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", WIDE_SHAPES)
@pytest.mark.parametrize("kind", ["bshd", "bhsd"])
def test_flash_wide_kernel_matches_plain(cuda, shape, kind):
    """Kernel B and #15 at d=512, one counted launch each (the merge kernel
    behind the same entry), within kernel B's bound of fp32 math."""
    g = torch.Generator(device=cuda).manual_seed(23)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).bfloat16() for _ in range(3))
    fn, plain = flash_attention_bshd, flash_attention_bshd_plain
    if kind == "bhsd":
        fn, plain = flash_attention, flash_attention_plain
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    launches = fn.launches
    got = fn(q, k, v, 512**-0.5)
    torch.cuda.synchronize()
    assert fn.launches == launches + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape and got.is_contiguous()
    assert_flash_close(got, plain(q.float(), k.float(), v.float(), 512**-0.5))


@pytest.mark.gpu
@pytest.mark.parametrize("n_split", [1, 2, 3, 6, 18])
@pytest.mark.parametrize("kind", ["bshd", "bhsd"])
def test_flash_wide_kernel_at_every_split(cuda, n_split, kind):
    """1100 keys in 1, 2, 3, 6 and 18 chunks of whole 64-key tiles (the last
    one ragged), each merged result within kernel B's bound of fp32 math."""
    from diffusionkit_tpu_torch.ops.flash_attention import _launch_wide

    g = torch.Generator(device=cuda).manual_seed(24)
    q, k, v = (torch.randn(1, 1100, 2, 512, generator=g, device=cuda).bfloat16()
               for _ in range(3))
    plain = flash_attention_bshd_plain
    if kind == "bhsd":
        plain = flash_attention_plain
        q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out = torch.empty_like(q)
    _launch_wide(q, k, v, out, kind, 512**-0.5, n_split)
    torch.cuda.synchronize()
    assert_flash_close(out, plain(q.float(), k.float(), v.float(), 512**-0.5))


@pytest.mark.gpu
def test_flash_wide_kernel_reads_strided_heads_in_place(cuda):
    """d=512 q/k/v as head slices of one packed projection: kernel B reads
    the strides, #15 the transposed views, each bit-identical to its call
    on contiguous copies (the same chunks, so the same sums)."""
    g = torch.Generator(device=cuda).manual_seed(25)
    qkv = torch.randn(1, 1100, 3 * 2, 512, generator=g, device=cuda).bfloat16()
    q, k, v = qkv[:, :, :2], qkv[:, :, 2:4], qkv[:, :, 4:]
    assert not q.is_contiguous()
    assert wide_split(1, 2, 1100, torch.cuda.get_device_properties(cuda).multi_processor_count)[0] > 1
    for fn, args in ((flash_attention_bshd, (q, k, v)),
                     (flash_attention, tuple(t.transpose(1, 2) for t in (q, k, v)))):
        assert torch.equal(fn(*args, 0.05), fn(*(t.contiguous() for t in args), 0.05))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bshd", "bhsd"])
def test_flash_wide_kernel_at_a_2048_decode(cuda, kind):
    """Kernel B and #15 at the VAE mid-block of a 2048² decode (65536
    positions, one split, 1024 key tiles a block), within kernel B's bound
    of fp32 math; the plain version runs 4096 query rows at a time (all its
    scores would take 17 GB)."""
    g = torch.Generator(device=cuda).manual_seed(27)
    q, k, v = (torch.randn(1, 65536, 1, 512, generator=g, device=cuda).bfloat16()
               for _ in range(3))
    fn, plain, axis = flash_attention_bshd, flash_attention_bshd_plain, 1
    if kind == "bhsd":
        fn, plain, axis = flash_attention, flash_attention_plain, 2
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    got = fn(q, k, v, 512**-0.5)
    kf, vf = k.float(), v.float()
    want = torch.cat([plain(q.narrow(axis, r, 4096).float(), kf, vf, 512**-0.5)
                      for r in range(0, 65536, 4096)], dim=axis)
    assert_flash_close(got, want)


# (B, H, S, D) shapes of #15: SD3-medium 512² CFG, the VAE mid-block at 512²,
# FLUX.1-schnell at 1024², and small ragged ones.
BHSD_SHAPES = [(2, 24, 1178, 64), (1, 1, 4096, 512), (1, 24, 4352, 128), (1, 3, 77, 64),
               (2, 1, 300, 512), (1, 3, 77, 128)] + [
                   (1, 2, s, d) for d in (64, 128) for s in TILE_EDGES]
# (B, H, Sq, Skv, D) of #14: FLUX 2048² at one rank and one of four, SD3's
# padded 1178 tokens at four ranks, and small ragged chunks with Sq != Skv.
# Plus, at d = 64 and 128, the Hopper kernels' tile edges with Sq != Skv:
# one query or key past a 128-row tile, one short of two, and nine tiles;
# and at d = 64 the 64-row blocks' edges (Sq 1, 63, 64, 65 and SD3 512²'s
# 295-row chunk) against key chunks of other lengths, one of them past the
# 3-stage ring's 384 keys. SD3 1024² CFG's four-rank chunk besides.
STATS_EDGES = [(1, 2, sq, skv, d) for d in (64, 128)
               for sq, skv in ((128, 129), (129, 255), (255, 1153), (1153, 128))] + [
                   (1, 3, sq, skv, 64)
                   for sq, skv in ((1, 130), (63, 385), (64, 65), (65, 64), (295, 1063))]
STATS_SHAPES = [(1, 24, 4160, 4160, 128), (2, 24, 295, 295, 64), (2, 24, 1063, 1063, 64),
                (1, 3, 77, 130, 64), (2, 2, 150, 61, 128)] + STATS_EDGES


@pytest.mark.gpu
@pytest.mark.parametrize("shape", BHSD_SHAPES)
@pytest.mark.parametrize("view", ["contiguous", "transposed"])
def test_flash_bhsd_kernel_matches_plain(cuda, shape, view):
    """#15 within kernel B's bound of fp32 math, on contiguous (B, H, S, D)
    tensors and on transposed views of (B, S, H, D) ones (the layout switch's
    input), which the kernel reads in place."""
    g = torch.Generator(device=cuda).manual_seed(5)
    b, h, s, d = shape
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=cuda).bfloat16() for _ in range(3))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if view == "contiguous":
        q, k, v = (t.contiguous() for t in (q, k, v))
    launches = flash_attention.launches
    got = flash_attention(q, k, v, d**-0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    assert got.dtype == torch.bfloat16 and got.shape == shape and got.is_contiguous()
    assert_flash_close(got, flash_attention_plain(q.float(), k.float(), v.float(), d**-0.5))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", STATS_SHAPES)
@pytest.mark.parametrize("part", ["full", "partial", "none"])
def test_flash_stats_kernel_matches_plain(cuda, shape, part):
    """#14 against its plain version on fp32 upcasts: o within 2^-8 max|o| +
    1e-6 (P rounded to bf16 at other running maxima), m within 1e-5 and l
    within 1e-4 relative (fp32 sums in another order); a fully masked chunk
    exactly o = 0, l = 0, m = -1e30."""
    g = torch.Generator(device=cuda).manual_seed(6)
    b, h, sq, skv, d = shape
    q = torch.randn(b, h, sq, d, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(b, h, skv, d, generator=g, device=cuda).bfloat16() for _ in range(2))
    vlen = {"full": skv, "partial": skv * 2 // 3, "none": 0}[part]
    launches = flash_attention_stats.launches
    o, m, l = flash_attention_stats(q, k, v, d**-0.5, vlen)
    torch.cuda.synchronize()
    assert flash_attention_stats.launches == launches + 1
    assert o.dtype == m.dtype == l.dtype == torch.float32
    assert o.shape == (b, h, sq, d) and m.shape == l.shape == (b, h, sq, 1)
    assert_stats_close((o, m, l), q, k, v, d**-0.5, vlen)


def assert_stats_close(got, q, k, v, scale, vlen):
    """#14's (o, m, l) against its plain version on fp32 upcasts (see
    test_flash_stats_kernel_matches_plain); with no valid key exactly
    o = 0, l = 0, m = -1e30."""
    o, m, l = got
    if vlen == 0:
        assert torch.all(o == 0) and torch.all(l == 0) and torch.all(m == NEG_INF)
        return
    ow, mw, lw = flash_attention_stats_plain(q.float(), k.float(), v.float(), scale, vlen)
    assert torch.all((o - ow).abs() <= 2.0**-8 * ow.abs().max() + 1e-6)
    assert torch.all((m - mw).abs() <= 1e-5 * mw.abs() + 1e-6)
    assert torch.all((l - lw).abs() <= 1e-4 * lw)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", STATS_EDGES)
def test_flash_stats_kernel_at_key_tile_edges(cuda, shape):
    """#14 at valid lengths around its key tiles: none, one key, one short
    of 64, 64, one past it, one short of a 128-key tile, a tile, one past
    it, two short of every key and every key; each within
    test_flash_stats_kernel_matches_plain's bounds (none exactly)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    b, h, sq, skv, d = shape
    q = torch.randn(b, h, sq, d, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(b, h, skv, d, generator=g, device=cuda).bfloat16() for _ in range(2))
    for vlen in sorted({0, 1, 63, 64, 65, 127, 128, 129, skv - 2, skv} & set(range(skv + 1))):
        got = flash_attention_stats(q, k, v, d**-0.5, vlen)
        torch.cuda.synchronize()
        assert_stats_close(got, q, k, v, d**-0.5, vlen)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 24, 295, 295, 64), (1, 3, 65, 385, 64),
                                   (2, 4, 1063, 1063, 64), (1, 2, 129, 255, 128)])
@pytest.mark.parametrize("vlen_less", [0, 2])
def test_flash_stats_kernel_on_bshd_views_repeats_bit_for_bit(cuda, shape, vlen_less):
    """#14 on strided (B, H, S, D) views of (B, S, H, D) tensors, as the
    ring reads the MMDiT's q/k/v: within test_flash_stats_kernel_matches_plain's
    bounds, and a second call on the same inputs bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(8)
    b, h, sq, skv, d = shape
    q = torch.randn(b, sq, h, d, generator=g, device=cuda).bfloat16().transpose(1, 2)
    k, v = (torch.randn(b, skv, h, d, generator=g, device=cuda).bfloat16().transpose(1, 2)
            for _ in range(2))
    vlen = skv - vlen_less
    first = flash_attention_stats(q, k, v, d**-0.5, vlen)
    again = flash_attention_stats(q, k, v, d**-0.5, vlen)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(first, again))
    assert_stats_close(first, q, k, v, d**-0.5, vlen)


@pytest.mark.gpu
def test_flash_bhsd_and_stats_raise_on_unsupported_input(cuda):
    q = torch.zeros(1, 2, 8, 256, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q, 0.1)
    q512 = torch.zeros(1, 1, 8, 512, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_stats(q512, q512, q512, 0.1, 8)
    q = torch.zeros(1, 2, 8, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, q, q, 0.1)
    with pytest.raises(TypeError):
        flash_attention_stats(q, q, q, 0.1, 8)
    # q, k and v share one dtype; fp32 rows must be 16-byte aligned too.
    q32, k16 = torch.zeros(1, 2, 8, 64, device=cuda), torch.zeros(1, 2, 8, 64, device=cuda,
                                                                   dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        flash_attention(q32, k16, k16, 0.1)
    with pytest.raises(TypeError):
        flash_attention_stats(q32, q32, k16, 0.1, 8)
    odd = torch.zeros(1, 2, 8, 66, device=cuda)[..., :64]  # rows 264 bytes apart
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(odd, odd, odd, 0.1)
    q512 = torch.zeros(1, 1, 8, 512, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_stats(q512, q512, q512, 0.1, 8)


@pytest.mark.gpu
def test_sdpa_layout_switch_takes_the_bhsd_kernel(cuda, monkeypatch):
    """Under DIFFUSIONKIT_TPU_ATTN_LAYOUT=bhsd a bshd attention that would
    take kernel B takes #15 through transposed views; a bhsd call takes #15
    whatever the switch."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(2, 1100, 3, 64, generator=g, device=cuda).bfloat16() for _ in range(3))
    b_launches, launches = flash_attention_bshd.launches, flash_attention.launches
    want = sdpa(q, k, v, 0.125, layout="bshd")
    monkeypatch.setenv("DIFFUSIONKIT_TPU_ATTN_LAYOUT", "bhsd")
    got = sdpa(q, k, v, 0.125, layout="bshd")
    assert (flash_attention_bshd.launches, flash_attention.launches) == (b_launches + 1,
                                                                         launches + 1)
    assert got.shape == q.shape
    assert_flash_close(got, xla_sdpa(q.float(), k.float(), v.float(), 0.125, layout="bshd"))
    assert_flash_close(want, xla_sdpa(q.float(), k.float(), v.float(), 0.125, layout="bshd"))
    monkeypatch.delenv("DIFFUSIONKIT_TPU_ATTN_LAYOUT")
    sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), 0.125)
    assert flash_attention.launches == launches + 2


@pytest.mark.gpu
def test_ring_on_one_nccl_rank_takes_the_stats_kernel(cuda):
    """The ring on the card's 1x1 mesh (one NCCL rank): one #14 call over
    the whole sequence, merged, within kernel B's bound of fp32 math; the
    plain chunk body only when asked for."""
    from diffusionkit_tpu_torch.parallel import local_mesh, ring_attention

    mesh = local_mesh()
    try:
        assert torch.distributed.get_backend() == "nccl"
        g = torch.Generator(device=cuda).manual_seed(8)
        q, k, v = (torch.randn(2, 3, 1200, 128, generator=g, device=cuda).bfloat16()
                   for _ in range(3))
        want = flash_attention_plain(q.float(), k.float(), v.float(), 128**-0.5)
        launches = flash_attention_stats.launches
        assert_flash_close(sdpa(q, k, v, 128**-0.5, impl="ring", mesh=mesh), want)
        assert flash_attention_stats.launches == launches + 1
        plain = ring_attention(q, k, v, 128**-0.5, mesh, use_flash=False)
        assert flash_attention_stats.launches == launches + 1
        assert_flash_close(plain, want)
    finally:
        torch.distributed.destroy_process_group()


def random_int4(k, n, group, gen, device):
    """Random packed words, and scales/zeros giving weights of about
    +-1/sqrt(K), like a trained layer's."""
    q4 = torch.randint(-(2**31), 2**31, (k // 8, n), generator=gen, device=device,
                       dtype=torch.int32)
    scales = (torch.rand(k // group, n, generator=gen, device=device) + 0.5) * (2 / 15 / k**0.5)
    zeros = -(torch.rand(k // group, n, generator=gen, device=device) + 0.5) / k**0.5
    return q4, scales, zeros


def assert_int4_close(x, q4, scales, zeros, got):
    """Kernel C against fp32 math on the same bf16-rounded weights, per
    element: one bf16 ulp (the output rounding, across a binade edge) plus
    twice the worst-case fp32 summation error of K terms, K * 2^-24 *
    (|x| @ |w|), since the kernel and the reference sum in other orders."""
    w = dequantize_int4(q4, scales, zeros, torch.bfloat16).float()
    want = x.float() @ w
    slack = 2 * x.shape[1] * 2.0**-24 * (x.float().abs() @ w.abs())
    diff = (got.float() - want).abs()
    assert torch.all(diff <= bf16_ulp(want) + slack), (diff / (bf16_ulp(want) + slack)).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", INT4_SHAPES)
def test_int4_kernel_matches_plain(cuda, shape):
    m, k, n, group = shape
    g = torch.Generator(device=cuda).manual_seed(5)
    q4, scales, zeros = random_int4(k, n, group, g, cuda)
    x = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    launches = int4_matmul.launches
    got = int4_matmul(x, q4, scales, zeros)
    torch.cuda.synchronize()
    assert int4_matmul.launches == launches + 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert_int4_close(x, q4, scales, zeros, got)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [300, 9])
def test_int4_kernel_reads_strided_rows_in_place(cuda, m):
    """x as the image rows of a wider activation (a row stride above K), on
    the Hopper loop (300 rows) and the GEMV (9)."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q4, scales, zeros = random_int4(512, 256, 64, g, cuda)
    wide = torch.randn(m, 640, generator=g, device=cuda).bfloat16()
    x = wide[:, 64:576]
    assert x.stride(0) == 640
    assert torch.equal(int4_matmul(x, q4, scales, zeros), int4_matmul(x.contiguous(), q4, scales, zeros))


@pytest.mark.gpu
def test_int4_wrapper_raises_on_unsupported_input(cuda):
    g = torch.Generator(device=cuda).manual_seed(7)
    q4, scales, zeros = random_int4(512, 256, 64, g, cuda)
    x = torch.randn(8, 512, generator=g, device=cuda)
    with pytest.raises(TypeError):
        int4_matmul(x.half(), q4, scales, zeros)  # fp16 x: bf16 or fp32 only
    x = x.bfloat16()
    with pytest.raises(ValueError, match="multiple of 128"):
        int4_matmul(x, q4[:, :200], scales[:, :200], zeros[:, :200])
    q16, s16, z16 = random_int4(512, 256, 16, g, cuda)
    with pytest.raises(ValueError, match="group size"):
        int4_matmul(x, q16, s16, z16)


# Kernels A' and D at FLUX's AdaLN-site and `ada`/`o` shapes, FLUX 2048²'s
# image rows, SD3-medium's image and text rows with CFG, SD3.5-large's
# hidden 2432 (304 bf16 vectors, not a multiple of a warp's 32 lanes) at a
# ragged S, plus ragged rows and fp32.
QUANT_SHAPES = [(1, 4352, 3072), (1, 256, 3072), (1, 77, 3072), (2, 33, 1024),
                (1, 16384, 3072), (2, 154, 1536), (2, 1024, 1536), (1, 333, 2432)]


def assert_int8_close(got8, want8, share: float = 1e-2):
    """Equal but for one int8 step on a small share of the elements: the
    LayerNorm's sums (A') and exp's last bit (gelu_quant) run in another
    order or form than the plain version's."""
    diff = (got8.int() - want8.int()).abs()
    assert diff.max().item() <= 1, diff.max().item()
    assert (diff > 0).float().mean().item() <= share, (diff > 0).float().mean().item()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", QUANT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_kernel_matches_plain(cuda, shape, dtype):
    """Kernel D: max, IEEE division and round-half-even are exact, so the
    kernel equals its plain version."""
    g = torch.Generator(device=cuda).manual_seed(8)
    y = (torch.randn(shape, generator=g, device=cuda) * 3).to(dtype)
    launches = quantize.launches
    got = quantize(y)
    torch.cuda.synchronize()
    assert quantize.launches == launches + 1
    want = quantize_plain(y)
    assert torch.equal(got.x8, want.x8) and torch.equal(got.xscale, want.xscale)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", QUANT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mod_ln_quantize_kernel_matches_plain(cuda, shape, dtype):
    """Kernel A': x8 within one step on at most 1 % of the elements, scales
    within 1e-5 (fp32 sums in another order, rsqrt correctly rounded)."""
    g = torch.Generator(device=cuda).manual_seed(9)
    b, s, h = shape
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    mods = torch.randn(b, 6 * h, generator=g, device=cuda).to(dtype)
    shift, scale = mods[:, None, :h], mods[:, None, h : 2 * h]
    launches = mod_ln_quantize.launches
    got = mod_ln_quantize(x, shift, scale)
    torch.cuda.synchronize()
    assert mod_ln_quantize.launches == launches + 1
    want = mod_ln_quantize_plain(x, shift, scale)
    assert got.x8.shape == shape and got.xscale.shape == (b, s, 1) and got.dtype == dtype
    assert_int8_close(got.x8, want.x8)
    torch.testing.assert_close(got.xscale, want.xscale, rtol=1e-5, atol=0)


# Kernel A' at every split of a row: 1 to 6 warps a row and 1 to 6
# vectors a lane, the same vector counts in bf16 (8 values a vector) and
# fp32 (4), up to the widest row (1024 vectors).
ROW_SPLIT_VECS = [32, 64, 96, 128, 160, 192, 200, 256, 304, 384, 600, 768, 1024]


@pytest.mark.gpu
@pytest.mark.parametrize("nvec", ROW_SPLIT_VECS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mod_ln_quantize_kernel_at_every_row_split(cuda, nvec, dtype):
    g = torch.Generator(device=cuda).manual_seed(10)
    h = nvec * (8 if dtype == torch.bfloat16 else 4)
    b, s = 3, 13  # a prime S: one row a block
    x = (torch.randn(b, s, h, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    mods = torch.randn(b, 6 * h, generator=g, device=cuda).to(dtype)
    shift, scale = mods[:, None, 3 * h : 4 * h], mods[:, None, 4 * h : 5 * h]
    got, want = mod_ln_quantize(x, shift, scale), mod_ln_quantize_plain(x, shift, scale)
    assert_int8_close(got.x8, want.x8)
    torch.testing.assert_close(got.xscale, want.xscale, rtol=1e-5, atol=0)


def assert_graph_replays_bit_identical(call) -> None:
    """Two replays of one CUDA graph of ``call`` give the same ActQuant
    bit for bit, equal to an eager call's."""
    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    graph.replay()
    torch.cuda.synchronize()
    first = (out.x8.clone(), out.xscale.clone())
    graph.replay()
    torch.cuda.synchronize()
    for a, b, c in zip((out.x8, out.xscale), first, (eager.x8, eager.xscale)):
        assert torch.equal(a, b) and torch.equal(b, c)


@pytest.mark.gpu
def test_mod_ln_quantize_graph_replays_are_bit_identical(cuda):
    g = torch.Generator(device=cuda).manual_seed(11)
    x = (torch.randn(2, 154, 1536, generator=g, device=cuda) * 2 + 0.5).bfloat16()
    mods = torch.randn(2, 6 * 1536, generator=g, device=cuda).bfloat16()
    shift, scale = mods[:, None, :1536], mods[:, None, 1536:3072]
    assert_graph_replays_bit_identical(lambda: mod_ln_quantize(x, shift, scale))


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fl32(a * b + c) for float32 a, b, c, rounded once as an FMA rounds:
    the product exact in float64 (48 bits), the sum an exact float64 pair
    (two-sum), then one round-half-even to float32 (the pair's low part
    decides where the high part is a float32 midpoint)."""
    prod, c64 = a.double() * b.double(), c.double()
    hi = prod + c64
    back = hi - prod
    lo = (prod - (hi - back)) + (c64 - back)
    out = hi.float()
    up, down = (torch.nextafter(out, torch.full_like(out, d)) for d in (np.inf, -np.inf))
    mid_up = hi == (out.double() + up.double()) / 2  # hi halfway to the next float32 up
    mid_down = hi == (out.double() + down.double()) / 2
    out = torch.where(mid_up & (lo > 0), up, out)
    return torch.where(mid_down & (lo < 0), down, out)


def div_rn(a: torch.Tensor, b: torch.Tensor, rb: torch.Tensor) -> torch.Tensor:
    """csrc/mod_ln.cu div_rn in float32: q0 = a * rb, then q0 + (a - q0 b)
    rb in two FMAs."""
    q0 = a * rb
    return fma32(fma32(-q0, b, a), rb, q0)


def quant_rule(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The quantize step of kernels A' and #4 (csrc/mod_ln.cu store_row_i8_rcp)
    in float32: div_rn(v, s, r) with r = 1/s correctly rounded (s capped at
    the largest float), rounded half-even by adding 1.5 * 2^23 after the
    clip to +-127."""
    magic = 12582912.0
    q = div_rn(v, s.clamp(max=torch.finfo(torch.float32).max), torch.full_like(s, 1.0) / s)
    return (q.clamp(-127.0, 127.0) + magic) - magic


def stress_values(family: str):
    """(v, s) pairs in float32 that stress the rule: s from 1e-8 / 127 (the
    smallest scale a row gets) to 1e4 and on to 2.6e36 (a row near the
    largest float); v at the half-integers k + 0.5 of the grid times s and
    their float32 neighbours (``ties``), at +-127.5 and +-127 times s and
    their neighbours (``edges``), uniform over the grid (``random``), down
    to subnormal (``tiny``), or in a row holding an infinity, s = inf
    (``inf``)."""
    s64 = np.concatenate([np.geomspace(1e-8 / 127, 1e4, 3001), np.geomspace(1e4, 2.6e36, 301),
                          [np.float32(1e-8) / np.float32(127), 1.0, 1 / 127]])
    s = torch.from_numpy(s64.astype(np.float32))[:, None]
    gen = torch.Generator().manual_seed(5)
    if family == "random":
        u = torch.rand(s.shape[0], 4096, generator=gen, dtype=torch.float64)
        return ((u * 255 - 127.5) * s.double()).float(), s
    if family == "tiny":
        u = torch.rand(s.shape[0], 256, generator=gen, dtype=torch.float64) * 2 - 1
        return (u * torch.logspace(-45, -20, 256, dtype=torch.float64)).float(), s
    if family == "inf":
        v = torch.randn(4096, generator=gen) * torch.logspace(-30, 30, 4096)
        return v[None, :], torch.full((1, 1), np.inf)
    k = np.arange(-128, 128) + 0.5 if family == "ties" else np.array([-127.5, -127, 127, 127.5])
    v = (torch.from_numpy(k)[None, :].double() * s.double()).float()
    steps = [v]
    for _ in range(3):  # 1, 2 and 3 float32 steps either way
        steps = [torch.nextafter(steps[0], torch.full_like(v, -np.inf))] + steps + [
            torch.nextafter(steps[-1], torch.full_like(v, np.inf))]
    return torch.cat(steps, dim=1), s


@pytest.mark.parametrize("family", ["ties", "edges", "random", "tiny", "inf"])
def test_division_free_rounding_rule_is_bit_exact(family):
    """The rule A' and #4 quantize by equals clip(round_half_even(v / s))
    bit for bit, v / s an IEEE division: the corrected product is fl(v / s)
    itself. CPU float32 arithmetic is IEEE, as the kernels' __fmul_rn /
    __fmaf_rn / __frcp_rn are; ``fma32`` rounds once, as the FMA does."""
    v, s = stress_values(family)
    want = torch.round(v / s).clamp(-127.0, 127.0)
    got = quant_rule(v, s)
    assert torch.equal(got, want), (got != want).sum().item()
    if family == "ties":  # the product alone rounds many of them the other way
        q0 = v * (torch.full_like(s, 1.0) / s)
        assert not torch.equal(torch.round(q0).clamp(-127.0, 127.0), want)


@pytest.mark.parametrize("b", [127.0, 1536.0, 2432.0, 3072.0, 6144.0])
def test_division_by_a_rounded_reciprocal_is_ieee(b):
    """div_rn, as the kernels take a row's scale (amax / 127, amax from
    1e-8 to the largest float) and A' its mean and variance (a sum over H),
    equals the IEEE quotient bit for bit."""
    g = torch.Generator().manual_seed(8)
    a = torch.exp(torch.rand(200000, generator=g, dtype=torch.float64) * 106 - 18.5).float()
    a = torch.cat([a, -a, torch.tensor([1e-8, 0.0, torch.finfo(torch.float32).max])])
    bt = torch.full_like(a, b)
    assert torch.equal(div_rn(a, bt, torch.full_like(a, 1.0) / bt), a / bt)


def test_fma32_rounds_once():
    """fma32 against exact rational arithmetic, and where a float64 sum
    rounded to float32 would round twice."""
    from fractions import Fraction

    def exact(a, b, c):  # round-half-even of the exact value to float32
        x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
        lo = np.float32(float(x))
        near = (lo, np.nextafter(lo, np.float32(np.inf)), np.nextafter(lo, np.float32(-np.inf)))
        # the nearest, and of two as near the one with an even last bit
        return min(near, key=lambda y: (abs(Fraction(float(y)) - x),
                                        int(np.float32(y).view(np.int32)) & 1))

    g = torch.Generator().manual_seed(7)
    a = torch.randn(2000, generator=g)
    b = torch.randn(2000, generator=g)
    # c just off the product, so the sum spans more than float64's 53 bits.
    c = (-(a.double() * b.double()) * (1 + 2.0**-30)).float()
    c[::2] = torch.randn(1000, generator=g)
    # Sums 2^-70 off a float32 midpoint m +- 2^-24 (m in [1, 2), either
    # parity): float64 rounds them onto the midpoint, which then ties.
    m = 1 + torch.randint(0, 2**23, (400,), generator=g).double() * 2.0**-23
    below = torch.tensor([1 + 2.0**-23] * 400)  # a * b = 2^-24 (1 - 2^-46)
    half = torch.tensor([2.0**-24 * (1 - 2.0**-23)] * 400)
    a = torch.cat([a, below, -below])
    b = torch.cat([b, half, half])
    c = torch.cat([c, m.float(), (m + 2.0**-23).float()])
    got = fma32(a, b, c)
    want = torch.tensor([exact(x, y, z) for x, y, z in zip(a.tolist(), b.tolist(), c.tolist())])
    assert torch.equal(got, want)


def gelu_erf_sign_flip(x: torch.Tensor) -> torch.Tensor:
    """csrc/mod_ln.cu gelu_erf in float32 torch: ``gelu_as`` with the sign
    of z put on 1 - poly * e by a sign-bit flip, not a product with
    sign(z), and 1 + p|z| capped at 2^100 before its reciprocal."""
    a1, a2, a3, a4, a5 = 0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429
    z = x * 0.7071067811865476
    ax = z.abs()
    t = torch.full_like(ax, 1.0) / (1.0 + 0.3275911 * ax).clamp(max=2.0**100)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    w = 1.0 - poly * torch.exp(-ax * ax)
    erf = (w.view(torch.int32) ^ (z.view(torch.int32) & -(2**31))).view(torch.float32)
    return x * 0.5 * (1.0 + erf)


def test_gelu_sign_flip_equals_gelu_as():
    """Kernel #4's GELU (the sign as a bit flip, the reciprocal's argument
    capped) equals the plain A&S GELU bit for bit, at +-0, subnormals,
    values past 2^100, infinities and NaN too."""
    from diffusionkit_tpu_torch.ops.w4a8_matmul import gelu_as

    g = torch.Generator().manual_seed(6)
    x = torch.cat([torch.randn(1 << 16, generator=g) * 4,
                   torch.randn(1 << 12, generator=g) * 1e-3,
                   torch.tensor([0.0, -0.0, 1e-45, -1e-45, 1e-39, -1e-39, 3e38, -3e38,
                                 np.inf, -np.inf, np.nan])])
    assert torch.equal(gelu_erf_sign_flip(x).view(torch.int32), gelu_as(x).view(torch.int32))


def random_w4a8(k, n, group, gen, device):
    """A random packed layer with its exact wscale and a bf16 bias."""
    layer = QuantizedLinear(k, n, group, dtype=torch.bfloat16, device=device)
    q4, scales, zeros = random_int4(k, n, group, gen, device)
    layer.q4.copy_(q4)
    layer.scales.copy_(scales)
    layer.zeros.copy_(zeros)
    layer.bias.copy_(0.1 * torch.randn(n, generator=gen, device=device))
    layer.wscale = wscale_from_q4(layer)
    return layer


# (mode, M, K, N, group): FLUX's shapes of each mode (the text stream, the
# `ada` GEMV, a ragged M, group 32) at reduced N where N does not matter;
# the modes but plain at M <= 16 (the Hopper loop with one short block).
W4A8_CASES = [("plain", 1, 3072, 18432, 64), ("plain", 256, 3072, 3072, 64),
              ("norm_rope", 3, 1024, 512, 64), ("gelu_quant", 9, 1024, 1024, 32),
              ("grouped_xs", 16, 1024, 512, 128),
              ("plain", 77, 3072, 1024, 32), ("plain", 4352, 3072, 3072, 64),
              ("norm_rope", 4352, 3072, 3072, 64), ("norm_rope", 77, 3072, 512, 32),
              ("gelu_quant", 4352, 3072, 12288, 64), ("gelu_quant", 77, 3072, 1024, 32),
              ("grouped_xs", 4352, 12288, 3072, 64), ("grouped_xs", 77, 1024, 512, 32)]


def w4a8_inputs(mode, m, k, n, group, gen, device):
    layer = random_w4a8(k, n, group, gen, device)
    x8 = torch.randint(-127, 128, (m, k), generator=gen, device=device, dtype=torch.int8)
    cols = k // 512 if mode == "grouped_xs" else 1
    xs = (torch.rand(m, cols, generator=gen, device=device) + 0.5) / 127
    extra = {}
    if mode == "norm_rope":
        ang = torch.rand(m + 5, 64, generator=gen, device=device) * 6.28
        extra = dict(norm_w=(torch.rand(128, generator=gen, device=device) + 0.5).bfloat16(),
                     cos=torch.cos(ang), sin=torch.sin(ang))
    return layer, x8, xs, extra


@pytest.mark.gpu
@pytest.mark.parametrize("case", W4A8_CASES)
def test_w4a8_kernel_matches_plain(cuda, case):
    """Kernel E against its plain version on the same card: plain and
    grouped_xs bit-identical (exact int32 products, the fp32 epilogue in
    the same order); norm_rope within one bf16 ulp plus 2^-21 of the
    largest |output| (the 128-term mean's order and rsqrt's rounding move
    the fp32 terms by ~1e-7 relative, which a near-zero rotated output
    x1 cos - x2 sin does not scale down);
    gelu_quant's y8 one step apart on at most 0.1 % (exp's last bit), its
    scales within 1e-6."""
    mode, m, k, n, group = case
    g = torch.Generator(device=cuda).manual_seed(10)
    layer, x8, xs, extra = w4a8_inputs(mode, m, k, n, group, g, cuda)
    args = (x8, layer.q4, layer.scales, layer.zeros, layer.wscale, xs, layer.bias)
    if mode == "plain" and m > 16:  # mode plain's own route there is #10 then #11
        extra["_route"] = "sm90"
    launches = w4a8_matmul.mode_launches[mode]
    got = w4a8_matmul(*args, mode=mode, **extra)
    torch.cuda.synchronize()
    assert w4a8_matmul.mode_launches[mode] == launches + 1
    extra.pop("_route", None)
    want = w4a8_matmul_plain(*args, mode=mode, **extra)
    if mode == "gelu_quant":
        assert got[0].shape == (m, n) and got[1].shape == (m, n // 512)
        assert_int8_close(got[0], want[0], share=1e-3)
        torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0)
    elif mode == "norm_rope":
        want = want.float()
        bound = bf16_ulp(want) + 2.0**-21 * want.abs().max()
        diff = (got.float() - want).abs()
        assert torch.all(diff <= bound), (diff / bound).max().item()
    else:
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.gpu
def test_w4a8_wrapper_raises_on_unsupported_input(cuda):
    g = torch.Generator(device=cuda).manual_seed(11)
    layer, x8, xs, _ = w4a8_inputs("plain", 8, 512, 256, 64, g, cuda)
    args = (x8, layer.q4, layer.scales, layer.zeros, layer.wscale, xs, layer.bias)
    with pytest.raises(ValueError, match="multiple of 512"):
        w4a8_matmul(*args, mode="gelu_quant")
    with pytest.raises(TypeError):
        w4a8_matmul(x8.float(), *args[1:])
    with pytest.raises(TypeError, match="bias"):
        w4a8_matmul(*args[:-1], layer.bias.half())
    with pytest.raises(TypeError):
        w4a8_matmul(*args, out_dtype=torch.float16)
    with pytest.raises(TypeError, match="'mat' route"):  # #11 takes the output's dtype
        w4a8_matmul(x8.repeat(4, 1), *args[1:5], xs.repeat(4, 1), layer.bias.float())
    layer, x8, xs, extra = w4a8_inputs("norm_rope", 8, 512, 256, 64, g, cuda)
    args = (x8, layer.q4, layer.scales, layer.zeros, layer.wscale, xs, layer.bias)
    with pytest.raises(TypeError, match="norm_rope"):  # no fp32-upcast block has RoPE
        w4a8_matmul(*args, mode="norm_rope", out_dtype=torch.float32, **extra)
    with pytest.raises(TypeError, match="norm_rope"):
        w4a8_matmul(*args[:-1], layer.bias.float(), mode="norm_rope", **extra)


# C and #13 on fp32 x (csrc/dequant_f32.cu: 3xTF32 wgmma above 16 rows, an
# FMA tile at M <= 16): SD3.5-large's
# block 35 at 1024² with CFG (image rows 2 x 4096, text rows 2 x 154) at
# q/k/v/o, fc1 and fc2; its `ada` shape at M = 2; ragged M, N a multiple of
# 64 but not 128 inside the kernel's reach, group 32 and 128.
F32_DEQUANT_SHAPES = [(8192, 2432, 2432, 64), (308, 2432, 9728, 64), (308, 9728, 2432, 64),
                      (2, 2432, 14592, 64), (77, 512, 256, 32), (9, 1024, 384, 128),
                      (16, 512, 128, 64), (17, 512, 128, 64)]


def fp32_ulp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0**-126))) - 23)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", F32_DEQUANT_SHAPES)
def test_dequant_kernels_take_fp32(cuda, bits, shape):
    """Kernels C and #13 on fp32 x against fp32 math on the same fp32
    weights (TF32 off): one fp32 ulp + 2K 2^-24 (|x| @ |w|) per element, the
    kernel and cuBLAS summing in other orders; counted as fp32 launches."""
    m, k, n, group = shape
    assert not torch.backends.cuda.matmul.allow_tf32
    g = torch.Generator(device=cuda).manual_seed(30)
    if bits == 4:
        qw, scales, zeros = random_int4(k, n, group, g, cuda)
        fn, w = int4_matmul, dequantize_int4(qw, scales, zeros, torch.float32)
    else:
        qw, scales, zeros = random_int8(k, n, group, g, cuda)
        fn, w = int8_matmul, dequantize_int8(qw, scales, zeros, torch.float32)
    x = torch.randn(m, k, generator=g, device=cuda)
    launches, f32 = fn.launches, fn.f32_launches
    got = fn(x, qw, scales, zeros)
    torch.cuda.synchronize()
    assert (fn.launches, fn.f32_launches) == (launches + 1, f32 + 1)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    want = x @ w
    bound = fp32_ulp(want) + 2 * k * 2.0**-24 * (x.abs() @ w.abs())
    diff = (got - want).abs()
    assert torch.all(diff <= bound), (diff / bound).max().item()


@pytest.mark.gpu
def test_dequant_fp32_reads_strided_rows_in_place(cuda):
    g = torch.Generator(device=cuda).manual_seed(31)
    q4, scales, zeros = random_int4(512, 256, 64, g, cuda)
    for m in (300, 9):
        wide = torch.randn(m, 640, generator=g, device=cuda)
        x = wide[:, 64:576]
        assert torch.equal(int4_matmul(x, q4, scales, zeros),
                           int4_matmul(x.contiguous(), q4, scales, zeros))


# Kernel E with an fp32 bias and output, in the modes an fp32-upcast block
# runs (SD3.5-large's block 35 at 1024² with CFG): the `ada` GEMV (M = 2,
# K = 2432, N = 14592; its input is the model-dtype c, so bf16 out with an
# fp32 bias, and fp32 out), mode plain above 16 rows on #10 then #11 and
# on E's Hopper loop, gelu_quant at fc1 and grouped_xs at fc2 (image rows
# and text rows); (mode, M, K, N, group, out). norm_rope (no upcast block
# has RoPE) refuses an fp32 bias or output.
W4A8_F32_CASES = [("plain", 2, 2432, 14592, 64, torch.bfloat16),
                  ("plain", 2, 2432, 14592, 64, torch.float32),
                  ("plain", 8192, 2432, 2432, 64, torch.float32),
                  ("plain-sm90", 308, 2432, 2432, 64, torch.float32),
                  ("gelu_quant", 8192, 2432, 9728, 64, torch.float32),
                  ("gelu_quant", 308, 2432, 9728, 64, torch.float32),
                  ("grouped_xs", 8192, 9728, 2432, 64, torch.float32),
                  ("grouped_xs", 308, 9728, 2432, 64, torch.float32)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", W4A8_F32_CASES)
def test_w4a8_kernel_fp32_bias_and_output(cuda, case):
    """Kernel E (and #10 then #11 on mode plain's "mat" route) with an fp32
    bias against its plain version: plain and grouped_xs bit-identical in
    the output dtype, gelu_quant as in bf16; counted as fp32 launches."""
    mode, m, k, n, group, out_dtype = case
    g = torch.Generator(device=cuda).manual_seed(32)
    route = "sm90" if mode == "plain-sm90" else None
    mode = mode.split("-")[0]
    layer, x8, xs, extra = w4a8_inputs(mode, m, k, n, group, g, cuda)
    bias = layer.bias.float() + 1e-3 * torch.randn(n, generator=g, device=cuda)
    args = (x8, layer.q4, layer.scales, layer.zeros, layer.wscale, xs, bias)
    f32, mat = w4a8_matmul.f32_launches, w4a8_matmul.mat_launches
    got = w4a8_matmul(*args, mode=mode, out_dtype=out_dtype, _route=route, **extra)
    torch.cuda.synchronize()
    want = w4a8_matmul_plain(*args, mode=mode, out_dtype=out_dtype, **extra)
    if mode == "plain" and m > 16 and route is None:
        assert w4a8_matmul.mat_launches == mat + 1
    else:
        assert w4a8_matmul.f32_launches == f32 + 1
    if mode == "gelu_quant":
        assert_int8_close(got[0], want[0], share=1e-3)
        torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0)
    else:
        assert got.dtype == out_dtype and torch.equal(got, want)


# Kernel D on rows wider than 8192 (T5-XXL's wo input, a FLUX w8a8 FFN
# hidden) and kernel #4 at the SD3 w8a8 FFN hiddens (image and text rows),
# T5-XXL's, SD3.5-large's (9728), FLUX's (12288) and the widest row (16384)
# at ragged row counts, and at 1, 2, 3, 4, 6 and 8 vectors a thread.
WIDE_ROWS = [(256, 10240), (4352, 12288), (3, 16384), (77, 1032)]
GELU_SHAPES = [(2048, 6144), (308, 6144), (256, 10240), (77, 1536), (77, 9728), (33, 12288),
               (5, 16384), (9, 8192), (20, 3072)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", WIDE_ROWS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_kernel_takes_wide_rows(cuda, shape, dtype):
    """Kernel D at 1, 2 and 4 vectors a thread: bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(12)
    y = (torch.randn(shape, generator=g, device=cuda) * 3).to(dtype)
    got, want = quantize(y), quantize_plain(y)
    assert torch.equal(got.x8, want.x8) and torch.equal(got.xscale, want.xscale)
    with pytest.raises(ValueError, match="16384"):
        quantize(torch.zeros(2, 16384 + 128, device=cuda, dtype=dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GELU_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("form", ["erf", "tanh"])
def test_gelu_quantize_kernel_matches_plain(cuda, shape, dtype, form):
    """Kernel #4: y8 one step apart on at most 0.1 % of the elements (exp's
    and tanh's last bits), scales within 1e-6."""
    g = torch.Generator(device=cuda).manual_seed(13)
    y = (torch.randn(shape, generator=g, device=cuda) * 2).to(dtype)
    launches = gelu_quantize.launches
    got = gelu_quantize(y, form)
    torch.cuda.synchronize()
    assert gelu_quantize.launches == launches + 1
    want = gelu_quantize_plain(y, form)
    assert got.x8.shape == shape and got.xscale.shape == (shape[0], 1) and got.dtype == dtype
    assert_int8_close(got.x8, want.x8, share=1e-3)
    torch.testing.assert_close(got.xscale, want.xscale, rtol=1e-6, atol=0)


@pytest.mark.gpu
def test_gelu_quantize_graph_replays_are_bit_identical(cuda):
    g = torch.Generator(device=cuda).manual_seed(14)
    y = (torch.randn(308, 6144, generator=g, device=cuda) * 2).bfloat16()
    assert_graph_replays_bit_identical(lambda: gelu_quantize(y))


def random_w8(m, k, n, gen, device, bias=True, dtype=torch.bfloat16):
    x8 = torch.randint(-127, 128, (m, k), generator=gen, device=device, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (n, k), generator=gen, device=device, dtype=torch.int8)
    xs = (torch.rand(m, 1, generator=gen, device=device) + 0.5) / (127 * k**0.5)
    ws = (torch.rand(n, generator=gen, device=device) + 0.5) / 127
    b = (0.1 * torch.randn(n, generator=gen, device=device)).to(dtype) if bias else None
    return x8, w8, ws, xs, b


# (M, K, N) of kernel #11 on the SD3 w8a8 and T5-XXL w8a8 paths: q/k/v/o,
# fc1, fc2 of the image and text rows, the `ada` and embedder GEMVs, the
# x_embedder (K = 64), the context embedder, the final linear (N = 64),
# T5-XXL's projections; a ragged M.
# Plus the Hopper main loop's edges (M > 16, K % 128 == 0): M one past the
# small-M tile, at and around one and two 128-row tiles and at the
# microbench's 4352; N short of a 128-column tile, ragged and 12288 wide
# (two 256-wide tiles' grids); K one 128-deep stage, 24 and 80 of them.
INT8_EDGES = [(m, k, n) for m in (17, 64, 65, 128, 129, 4352)
              for k, n in ((128, 64), (3072, 200), (10240, 12288))]
W8_SHAPES = [(2048, 1536, 1536), (308, 1536, 6144), (2048, 6144, 1536), (2, 1536, 9216),
             (2, 256, 1536), (2048, 64, 1536), (308, 4096, 1536), (2048, 1536, 64),
             (256, 4096, 10240), (256, 10240, 4096), (77, 512, 200)] + INT8_EDGES


@pytest.mark.gpu
@pytest.mark.parametrize("shape", W8_SHAPES)
def test_w8_kernel_matches_plain(cuda, shape):
    """Kernel #11 against its plain version on the same card: bit-identical
    (exact int32 products, the fp32 epilogue in the same order)."""
    g = torch.Generator(device=cuda).manual_seed(14)
    args = random_w8(*shape, g, cuda)
    launches = w8_matmul.launches
    got = w8_matmul(*args)
    torch.cuda.synchronize()
    assert w8_matmul.launches == launches + 1
    assert got.dtype == torch.bfloat16 and got.shape == (shape[0], shape[2])
    assert torch.equal(got, w8_matmul_plain(*args))


@pytest.mark.gpu
def test_w8_kernel_fp32_and_no_bias(cuda):
    g = torch.Generator(device=cuda).manual_seed(15)
    args = random_w8(300, 1024, 512, g, cuda, dtype=torch.float32)
    assert torch.equal(w8_matmul(*args, out_dtype=torch.float32),
                       w8_matmul_plain(*args, out_dtype=torch.float32))
    args = random_w8(5, 1024, 512, g, cuda, bias=False)
    assert torch.equal(w8_matmul(*args), w8_matmul_plain(*args))


# #11 and #16 at M > 16 with K % 128 == 64 (w8_mm_sm90_k64): the SD3
# x_embedder's (2048, 64, 1536), M one past the small-M tile and one past a
# 128-row tile, K of three 64-deep stages (the ring's slot reused), N short
# of a 128-column tile and ragged.
K64_SHAPES = [(2048, 64, 1536), (17, 64, 1536), (129, 192, 200), (300, 64, 8),
              (4352, 320, 3072)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", K64_SHAPES)
@pytest.mark.parametrize("out_dtype,bias", [(torch.bfloat16, True), (torch.float32, True),
                                            (torch.bfloat16, False)])
def test_w8_k64_kernel_matches_plain(cuda, shape, out_dtype, bias):
    """#11 on its 64-deep Hopper loop against its plain version:
    bit-identical in bf16 and fp32, with and without a bias; and #16 there
    against the exact int32 product."""
    from diffusionkit_tpu_torch.ops.w4a8_matmul import int8_dot, int8_dot_plain, w8_route

    m, k, n = shape
    assert w8_route(m, k, n) == "sm90_k64"
    g = torch.Generator(device=cuda).manual_seed(17)
    args = random_w8(m, k, n, g, cuda, dtype=out_dtype, bias=bias)
    launches = w8_matmul.launches
    got = w8_matmul(*args, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert w8_matmul.launches == launches + 1
    assert got.dtype == out_dtype and torch.equal(got, w8_matmul_plain(*args, out_dtype=out_dtype))
    assert torch.equal(int8_dot(args[0], args[1]), int8_dot_plain(args[0], args[1]))


@pytest.mark.gpu
def test_w8_wrapper_raises_on_unsupported_input(cuda):
    g = torch.Generator(device=cuda).manual_seed(16)
    x8, w8, ws, xs, b = random_w8(8, 256, 128, g, cuda)
    with pytest.raises(ValueError, match="multiple of 64"):
        w8_matmul(x8[:, :96].contiguous(), w8[:, :96].contiguous(), ws, xs, b)
    with pytest.raises(ValueError, match="bias"):
        w8_matmul(x8, w8, ws, xs, b.float())
    with pytest.raises(TypeError):
        w8_matmul(x8.float(), w8, ws, xs, b)
    with pytest.raises(TypeError):
        w8_matmul(x8, w8, ws, xs, b, out_dtype=torch.float16)


def random_int8(k, n, group, gen, device):
    """Random bytes over the whole 0..255 range, and scales/zeros giving
    weights of about +-1/sqrt(K)."""
    q8 = torch.randint(0, 256, (k, n), generator=gen, device=device, dtype=torch.uint8)
    scales = (torch.rand(k // group, n, generator=gen, device=device) + 0.5) * (2 / 255 / k**0.5)
    zeros = -(torch.rand(k // group, n, generator=gen, device=device) + 0.5) / k**0.5
    return q8, scales, zeros


# (M, K, N, group) of kernel #13 on the SD3 int8 path: q/k/v/o, fc1, fc2,
# an `ada` GEMV, the context embedder, at the quantize-at-load group 32 and
# the random init's 64; a ragged M.
INT8_SHAPES = [(2048, 1536, 1536, 32), (2048, 1536, 6144, 32), (2048, 6144, 1536, 32),
               (308, 1536, 1536, 64), (2, 1536, 9216, 32), (308, 4096, 1536, 32),
               (77, 512, 256, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", INT8_SHAPES)
def test_int8_kernel_matches_plain(cuda, shape):
    """Kernel #13 against fp32 math on the same bf16-rounded weights, as
    kernel C: one bf16 ulp + 2K 2^-24 (|x| @ |w|) per element."""
    m, k, n, group = shape
    g = torch.Generator(device=cuda).manual_seed(17)
    q8, scales, zeros = random_int8(k, n, group, g, cuda)
    x = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    launches = int8_matmul.launches
    got = int8_matmul(x, q8, scales, zeros)
    torch.cuda.synchronize()
    assert int8_matmul.launches == launches + 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    w = dequantize_int8(q8, scales, zeros, torch.bfloat16).float()
    want = x.float() @ w
    slack = 2 * k * 2.0**-24 * (x.float().abs() @ w.abs())
    diff = (got.float() - want).abs()
    assert torch.all(diff <= bf16_ulp(want) + slack), (diff / (bf16_ulp(want) + slack)).max().item()


@pytest.mark.gpu
def test_int8_wrapper_raises_on_unsupported_input(cuda):
    g = torch.Generator(device=cuda).manual_seed(18)
    q8, scales, zeros = random_int8(512, 256, 64, g, cuda)
    x = torch.randn(8, 512, generator=g, device=cuda).bfloat16()
    with pytest.raises(TypeError):
        int8_matmul(x, q8.to(torch.int8), scales, zeros)
    with pytest.raises(ValueError, match="multiple of 128"):
        int8_matmul(x, q8[:, :200].contiguous(), scales[:, :200].contiguous(),
                    zeros[:, :200].contiguous())


# fp32 flash: kernel B (B, S, H, D) at the SD3, VAE-at-512² and FLUX 1024²
# shapes, #15 (B, H, S, D) at the same, and small ragged ones; #14 at SD3's
# padded four-rank chunk, a FLUX 2048² four-rank chunk and a ragged one.
# Plus, for the 3xTF32 kernels, odd lengths around their 64-row (d = 64
# and 128) and 32-row (d = 512) query blocks and their key tiles.
FP32_FLASH_SHAPES = [(2, 1178, 24, 64), (1, 4096, 1, 512), (1, 4352, 24, 128), (1, 77, 3, 64),
                     (2, 300, 1, 512), (1, 77, 3, 128), (1, 129, 2, 128), (2, 1025, 3, 128),
                     (1, 33, 1, 512), (1, 1100, 2, 512), (1, 129, 2, 64), (2, 1025, 3, 64)]
FP32_STATS_SHAPES = [(2, 24, 295, 295, 64), (1, 24, 4160, 4160, 128), (2, 2, 150, 61, 128),
                     (2, 2, 150, 61, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FP32_FLASH_SHAPES)
@pytest.mark.parametrize("kind", ["bshd", "bhsd"])
def test_flash_fp32_kernels_match_plain(cuda, shape, kind):
    """Kernel B and #15 on fp32 inputs: the fp32 kernel, counted, within
    2^-16 of the largest |output| of the fp32 plain version on the card
    (TF32 off); #15 reads transposed (B, S, H, D) views in place."""
    g = torch.Generator(device=cuda).manual_seed(19)
    q, k, v = (torch.randn(shape, generator=g, device=cuda) for _ in range(3))
    scale = shape[-1] ** -0.5
    fn, plain = flash_attention_bshd, flash_attention_bshd_plain
    if kind == "bhsd":
        fn, plain = flash_attention, flash_attention_plain
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    launches = fn.launches
    got = fn(q, k, v, scale)
    torch.cuda.synchronize()
    assert fn.launches == launches + 1
    assert got.shape == q.shape and got.is_contiguous()
    assert_fp32_flash_close(got, plain(q, k, v, scale))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FP32_STATS_SHAPES)
@pytest.mark.parametrize("part", ["full", "partial", "none"])
def test_flash_stats_fp32_kernel_matches_plain(cuda, shape, part):
    """#14 on fp32 inputs: o within 2^-16 of its largest |o|, m of its
    largest |m|, l of its largest l, against the fp32 plain version; a
    fully masked chunk exactly o = 0, l = 0, m = -1e30."""
    g = torch.Generator(device=cuda).manual_seed(20)
    b, h, sq, skv, d = shape
    q = torch.randn(b, h, sq, d, generator=g, device=cuda)
    k, v = (torch.randn(b, h, skv, d, generator=g, device=cuda) for _ in range(2))
    vlen = {"full": skv, "partial": skv * 2 // 3, "none": 0}[part]
    launches = flash_attention_stats.launches
    got = flash_attention_stats(q, k, v, d**-0.5, vlen)
    torch.cuda.synchronize()
    assert flash_attention_stats.launches == launches + 1
    if vlen == 0:
        o, m, l = got
        assert torch.all(o == 0) and torch.all(l == 0) and torch.all(m == NEG_INF)
        return
    for a, w in zip(got, flash_attention_stats_plain(q, k, v, d**-0.5, vlen)):
        assert_fp32_flash_close(a, w)


@pytest.mark.gpu
@pytest.mark.parametrize("vlen", [0, 1, 31, 33, 4159])
def test_flash_stats_fp32_kernel_at_odd_lengths(cuda, vlen):
    """#14 in fp32 at d = 128 (the 3xTF32 kernel) over a FLUX 2048²
    four-rank chunk's 4160 keys with 0, 1, 31, 33 and 4159 valid: within
    2^-16 of each output's largest magnitude of the fp32 plain version; no
    valid key exactly o = 0, l = 0, m = -1e30."""
    g = torch.Generator(device=cuda).manual_seed(26)
    q = torch.randn(1, 2, 4160, 128, generator=g, device=cuda)
    k, v = (torch.randn(1, 2, 4160, 128, generator=g, device=cuda) for _ in range(2))
    got = flash_attention_stats(q, k, v, 128**-0.5, vlen)
    torch.cuda.synchronize()
    if vlen == 0:
        o, m, l = got
        assert torch.all(o == 0) and torch.all(l == 0) and torch.all(m == NEG_INF)
        return
    for a, w in zip(got, flash_attention_stats_plain(q, k, v, 128**-0.5, vlen)):
        assert_fp32_flash_close(a, w)


@pytest.mark.gpu
def test_flash_fp32_kernel_reads_strided_heads_in_place(cuda):
    g = torch.Generator(device=cuda).manual_seed(21)
    qkv = torch.randn(2, 333, 3 * 4, 128, generator=g, device=cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:]
    got = flash_attention_bshd(q, k, v, 0.1)
    assert torch.equal(got, flash_attention_bshd(q.contiguous(), k.contiguous(), v.contiguous(), 0.1))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 4096, 1, 512), (2, 1178, 24, 64)])
def test_sdpa_fp32_takes_the_kernel(cuda, shape):
    """fp32 attention above the flash threshold (the VAE mid-block of an
    a16=False decode at 512², an fp32 SD3 MMDiT) runs kernel B's fp32
    instantiation, counted, within the fp32 bound of xla_sdpa."""
    g = torch.Generator(device=cuda).manual_seed(22)
    q, k, v = (torch.randn(shape, generator=g, device=cuda) for _ in range(3))
    scale = shape[-1] ** -0.5
    launches = flash_attention_bshd.launches
    got = sdpa(q, k, v, scale, layout="bshd")
    torch.cuda.synchronize()
    assert flash_attention_bshd.launches == launches + 1
    assert_fp32_flash_close(got, xla_sdpa(q, k, v, scale, layout="bshd"))


# -- the IEEE divisions of the denoise loop ------------------------------------


@pytest.mark.gpu
def test_euler_step_and_latent_unscaling_divide_as_on_the_cpu(cuda):
    """_cfg_euler_step (with a stub model that only moves data) and
    LatentFormat.process_out give the CPU's result bit for bit on the card:
    both divide by a tensor (the step by its 0-d device sigma), which torch
    divides in IEEE on CUDA too (a CPU scalar divisor there is a product
    with its rounded reciprocal)."""
    import numpy as np

    from diffusionkit_tpu_torch.pipeline import FluxLatentFormat, SD3LatentFormat, _cfg_euler_step

    def stub(x, cond, pooled, t, g, sdpa_impl=None, mesh=None):
        return x.flip(-1)

    def scalars(device, *values):
        return [torch.tensor(np.float32(v), device=device) for v in values]

    x = torch.from_numpy(np.random.RandomState(23).randn(1, 64, 64, 16).astype(np.float32))
    for sigma, nxt in ((np.float32(0.9372), np.float32(0.8711)), (np.float32(0.3), np.float32(0.0))):
        for cfg_on in (False, True):
            s, n, w = scalars("cpu", sigma, nxt, 5.0)
            want = _cfg_euler_step(stub, x, s, n, None, None, w, cfg_on)
            s, n, w = scalars(cuda, sigma, nxt, 5.0)
            got = _cfg_euler_step(stub, x.to(cuda), s, n, None, None, w, cfg_on)
            assert torch.equal(got.cpu(), want)
    for fmt in (SD3LatentFormat(), FluxLatentFormat()):
        assert torch.equal(fmt.process_out(x.to(cuda)).cpu(), fmt.process_out(x))


# -- #10 dequant_w8 and #16 int8_dot ---------------------------------------------

# (K, N, group) of #10: FLUX fc1, fc2 and q at group 64, q at the
# quantize-at-load group 32, a group of 128, a K that ends in a partial
# 256-k tile and an N that ends in a partial 128-column tile, groups that
# split a packed word, a K of 8 mod 16 (8-byte stores) at group 8, group 32
# with a ragged K and N, and a group of 192 (a multiple of 64, not of 128).
DEQUANT_SHAPES = [(3072, 12288, 64), (12288, 3072, 64), (3072, 3072, 64), (3072, 3072, 32),
                  (1024, 512, 128), (1000, 200, 40), (96, 64, 12), (64, 24, 4),
                  (520, 136, 8), (800, 392, 32), (3072, 4352, 192)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", DEQUANT_SHAPES)
def test_dequant_w8_kernel_matches_plain(cuda, shape):
    """#10 against its plain version on the card: bit-identical (N, K)."""
    from diffusionkit_tpu_torch.ops.w4a8_matmul import dequant_w8, dequant_w8_plain, scaled_affine

    k, n, group = shape
    g = torch.Generator(device=cuda).manual_seed(24)
    q4, scales, zeros = random_int4(k, n, group, g, cuda)
    ws = (torch.rand(n, generator=g, device=cuda) + 0.5) * (2 / 127 / k**0.5)
    s8, z8 = scaled_affine(scales, zeros, ws)
    launches = dequant_w8.launches
    got = dequant_w8(q4, s8, z8)
    torch.cuda.synchronize()
    assert dequant_w8.launches == launches + 1
    assert got.dtype == torch.int8 and got.shape == (n, k) and got.is_contiguous()
    assert torch.equal(got, dequant_w8_plain(q4, s8, z8))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4352, 77, 1])
def test_dequant_w8_then_w8_matmul_is_kernel_e(cuda, m):
    """#10's grid fed to #11 equals kernel E (mode plain) bit for bit on the
    same layer: the two dataflows share the requant grid."""
    from diffusionkit_tpu_torch.ops.w4a8_matmul import dequant_w8, scaled_affine

    g = torch.Generator(device=cuda).manual_seed(25)
    layer, x8, xs, _ = w4a8_inputs("plain", m, 3072, 1536, 64, g, cuda)
    s8, z8 = scaled_affine(layer.scales, layer.zeros, layer.wscale)
    fused = w4a8_matmul(x8, layer.q4, layer.scales, layer.zeros, layer.wscale, xs, layer.bias,
                        _route="sm90" if m > 16 else "tile")
    mat = w8_matmul(x8, dequant_w8(layer.q4, s8, z8), layer.wscale, xs, layer.bias)
    assert torch.equal(mat, fused)


@pytest.mark.gpu
@pytest.mark.parametrize("m,group", [(17, 64), (256, 64), (4352, 64), (4352, 32)])
def test_w4a8_linear_takes_the_materialised_route(cuda, m, group):
    """Above 16 rows a w4a8 layer's mode plain runs #10 then #11: one launch
    of each and none of kernel E, counted in ``mat_launches``; the output
    is kernel E's Hopper loop's on the same layer, bit for bit."""
    from diffusionkit_tpu_torch.ops.w4a8_matmul import dequant_w8, w4a8_linear, w4a8_route
    from diffusionkit_tpu_torch.ops.w8a8 import ActQuant

    assert w4a8_route(m, "plain") == "mat"
    g = torch.Generator(device=cuda).manual_seed(28)
    layer, x8, xs, _ = w4a8_inputs("plain", m, 3072, 1536, group, g, cuda)
    counters = (dequant_w8, w8_matmul, w4a8_matmul)
    before = [fn.launches for fn in counters] + [w4a8_matmul.mat_launches]
    got = w4a8_linear(layer, ActQuant(x8, xs, out_dtype=torch.bfloat16))
    torch.cuda.synchronize()
    after = [fn.launches for fn in counters] + [w4a8_matmul.mat_launches]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 0, 1]
    want = w4a8_matmul(x8, layer.q4, layer.scales, layer.zeros, layer.wscale, xs, layer.bias,
                       _route="sm90")
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


# (M, K, N) of #16: the microbench default, M = 1, a ragged M, K = 64 (the
# 64-deep k tile) and an N that ends in a partial tile.
INT8_DOT_SHAPES = [(4352, 3072, 12288), (1, 3072, 12288), (77, 3072, 3072), (300, 64, 200),
                   (16, 512, 136)] + INT8_EDGES


@pytest.mark.gpu
@pytest.mark.parametrize("shape", INT8_DOT_SHAPES)
def test_int8_dot_kernel_matches_plain(cuda, shape):
    """#16 against the exact int32 product (float64 on the card), and
    against torch._int_mm where its shape rules allow."""
    from diffusionkit_tpu_torch.ops.w4a8_matmul import int8_dot, int8_dot_plain

    m, k, n = shape
    g = torch.Generator(device=cuda).manual_seed(26)
    x8 = torch.randint(-127, 128, (m, k), generator=g, device=cuda, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8)
    launches = int8_dot.launches
    got = int8_dot(x8, w8)
    torch.cuda.synchronize()
    assert int8_dot.launches == launches + 1
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, int8_dot_plain(x8, w8))
    if m > 16:
        assert torch.equal(got, torch._int_mm(x8, w8.t()))


@pytest.mark.gpu
def test_dequant_w8_and_int8_dot_raise_on_unsupported_input(cuda):
    from diffusionkit_tpu_torch.ops.w4a8_matmul import dequant_w8, int8_dot

    g = torch.Generator(device=cuda).manual_seed(27)
    q4, scales, zeros = random_int4(256, 64, 64, g, cuda)
    with pytest.raises(TypeError):
        dequant_w8(q4.float(), scales, zeros)
    with pytest.raises(ValueError, match="multiple of 8"):
        dequant_w8(q4[:, :60].contiguous(), scales[:, :60].contiguous(), zeros[:, :60].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        dequant_w8(q4, scales.t().contiguous().t(), zeros)
    x8 = torch.zeros(8, 96, device=cuda, dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of 64"):
        int8_dot(x8, x8)
    with pytest.raises(TypeError):
        int8_dot(x8.float(), x8)


@pytest.mark.gpu
def test_tools_run_on_the_card(cuda):
    """Both tools at a small shape: a time on every row, mat_pl and mat_xla
    equal to kernel and int8_dot to torch._int_mm, and each counter rising
    by exactly the launches a run makes."""
    from diffusionkit_tpu_torch.ops import w4a8_matmul as tw
    from diffusionkit_tpu_torch.tools import bench_w4a8_mat, microbench_int8

    counters = {"dequant_w8": tw.dequant_w8, "w8_matmul": tw.w8_matmul, "int8_dot": tw.int8_dot,
                "quantize": quantize}
    before = {name: fn.launches for name, fn in counters.items()}
    plain_e = w4a8_matmul.mode_launches["plain"]
    rows = {r["name"]: r for r in bench_w4a8_mat.run(256, 512, 1024, iters=3)}
    rows.update({r["name"]: r for r in microbench_int8.run(256, 512, 1024, iters=3)})
    assert all(r["ms"] > 0 for r in rows.values())
    for key in ("y0", "y"):
        assert torch.equal(rows["mat_pl"][key], rows["kernel"][key])
        assert torch.equal(rows["mat_xla"][key], rows["kernel"][key])
        assert torch.equal(rows["int8_dot"][key], rows["int_mm"][key])
    want = {**bench_w4a8_mat.launches(3), **microbench_int8.launches(3)}
    assert w4a8_matmul.mode_launches["plain"] - plain_e == want.pop("w4a8_matmul[plain]")
    assert {name: fn.launches - before[name] for name, fn in counters.items()} == want


# Kernels E, C and #13 on their two main loops, and w4a8's mode plain above
# 16 rows on #10 then #11. The routes: the split-K GEMV ("tile") at M <= 16
# (the `ada` projections; for E mode plain only), for mode plain above it
# the materialised dataflow ("mat"), the Hopper loop otherwise; every shape
# the wrappers took before takes one.
ROUTE_ROWS = [1, 2, 16, 17, 77, 255, 256, 257, 4352, 16384, 16640]
E_ACCEPTED = [(k, n, group, mode) for mode in ("plain", "gelu_quant", "grouped_xs", "norm_rope")
              for k in (512, 3072) for n in (512, 3072) for group in (32, 64, 128, 256)]


@pytest.mark.parametrize("m", ROUTE_ROWS)
def test_w4a8_route_takes_every_accepted_shape(m):
    """Every (K, N, group, mode) the wrapper takes goes to the tile in mode
    plain at M <= 16, to #10 then #11 in mode plain above it, and to the
    Hopper loop in the other modes; the Hopper loop also takes mode plain
    at any M when asked, the tile and "mat" no other mode, the tile no M
    above 16; and what the wrapper refused it still refuses."""
    from diffusionkit_tpu_torch.ops.w4a8_matmul import w4a8_kernel, w4a8_route

    for k, n, group, mode in E_ACCEPTED:
        want = ("tile" if m <= 16 else "mat") if mode == "plain" else "sm90"
        assert w4a8_route(m, mode) == want
        symbol = {"tile": "dk_w4a8_matmul", "mat": "dk_dequant_w8", "sm90": "dk_w4a8_matmul_sm90"}
        assert w4a8_kernel(m, k, k // 8, n, k // group, mode) == symbol[want]
        assert w4a8_kernel(m, k, k // 8, n, k // group, mode, "sm90") == symbol["sm90"]
        for route in ("tile", "mat"):
            if mode == "plain" and (route == "mat" or m <= 16):
                assert w4a8_kernel(m, k, k // 8, n, k // group, mode, route) == symbol[route]
            else:
                with pytest.raises(ValueError, match="route"):
                    w4a8_kernel(m, k, k // 8, n, k // group, mode, route)
    for k, n, group, mode in [(3072, 3072, 48, "plain"), (3072, 3072, 96, "plain"),
                              (384, 3072, 64, "grouped_xs"), (3072, 384, 64, "gelu_quant"),
                              (3072, 3072 + 64, 64, "plain"), (3072 + 64, 3072, 64, "plain")]:
        with pytest.raises(ValueError):
            w4a8_kernel(m, k, k // 8, n, k // group, mode)
        with pytest.raises(ValueError):
            w4a8_kernel(m, k, k // 8, n, k // group, mode, "mat")
    with pytest.raises(ValueError, match="route"):
        w4a8_kernel(m, 3072, 384, 3072, 48, "plain", "gemv")


@pytest.mark.parametrize("m", ROUTE_ROWS)
@pytest.mark.parametrize("name", ["int4_matmul", "int8_matmul"])
def test_dequant_route_takes_every_accepted_shape(m, name):
    """As for kernel E: C and #13 at every (K, N, group) they take."""
    from diffusionkit_tpu_torch.ops.int4_matmul import dequant_kernel, dequant_route

    suffix = "_bf16" if m <= 16 else "_sm90_bf16"
    assert dequant_route(m) == ("tile" if m <= 16 else "sm90")
    for k in (64, 512, 1536, 3072, 12288):
        for n in (128, 384, 3072):
            for group in (32, 64, 128, 192):
                if k % group == 0:
                    assert dequant_kernel(name, m, k, k, n, k // group) == f"dk_{name}{suffix}"
                    assert dequant_kernel(name, m, k, k, n, k // group, torch.bfloat16,
                                          torch.float32) == f"dk_{name}{suffix}_f32out"
    for k, n, group in [(3072, 3072, 16), (3072, 3072, 96), (3072 + 32, 3072, 32),
                        (3072, 3072 + 64, 64)]:
        with pytest.raises(ValueError):
            dequant_kernel(name, m, k, k, n, k // group)


# The Hopper loops' edges: M one past the GEMV's, short of, at and one
# past a 256-row block, the unified blocks' 4352; groups 32, 64 and 128.
EDGE_ROWS = (17, 77, 255, 256, 257, 4352)
EDGE_GROUPS = (32, 64, 128)


@pytest.mark.gpu
@pytest.mark.parametrize("m", EDGE_ROWS)
@pytest.mark.parametrize("group", EDGE_GROUPS)
@pytest.mark.parametrize("mode", ["plain", "gelu_quant", "grouped_xs", "norm_rope"])
def test_w4a8_hopper_loop_at_its_edges(cuda, m, group, mode):
    """Kernel E on the Hopper loop at its row-block edges and every group
    size, each mode held to its plain version as in
    test_w4a8_kernel_matches_plain."""
    test_w4a8_kernel_matches_plain(cuda, (mode, m, 1024, 512, group))


@pytest.mark.gpu
@pytest.mark.parametrize("m", EDGE_ROWS)
@pytest.mark.parametrize("group", EDGE_GROUPS)
def test_int4_and_int8_hopper_loop_at_its_edges(cuda, m, group):
    test_int4_kernel_matches_plain(cuda, (m, 1024, 384, group))
    test_int8_kernel_matches_plain(cuda, (m, 1024, 384, group))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [300, 9])
def test_int8_kernel_reads_strided_rows_in_place(cuda, m):
    """#13 on x as the image rows of a wider activation, on either loop."""
    g = torch.Generator(device=cuda).manual_seed(19)
    q8, scales, zeros = random_int8(512, 256, 64, g, cuda)
    wide = torch.randn(m, 640, generator=g, device=cuda).bfloat16()
    x = wide[:, 64:576]
    assert x.stride(0) == 640
    assert torch.equal(int8_matmul(x, q8, scales, zeros),
                       int8_matmul(x.contiguous(), q8, scales, zeros))


# The fp32-output form of C and #13 (a row-parallel linear's partial
# product): SD3-medium's o and fc2 split over two ranks (K 768 and 3072, N
# 1536) at 2048 and 308 rows, a ragged M on the Hopper loop and the GEMV's
# M <= 16 (the `ada`-width GEMV, an embedder's); groups 32 and 64.
F32OUT_SHAPES = [(2048, 768, 1536, 32), (2048, 3072, 1536, 32), (308, 768, 1536, 32),
                 (308, 3072, 1536, 64), (77, 1024, 384, 64), (2, 768, 1536, 32),
                 (9, 3072, 1536, 64), (16, 1024, 384, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", F32OUT_SHAPES)
def test_dequant_kernels_write_fp32_sums(cuda, bits, shape):
    """C and #13 on bf16 x with ``out_dtype=torch.float32``: the bf16 form's
    products before its last rounding, so the fp32 output rounded to bf16
    is the bf16 form's output bit for bit, and it is within one fp32 ulp +
    2K 2^-24 (|x| @ |w|) of fp32 math on the same bf16-rounded weights;
    counted in ``f32out_launches`` (and not in ``f32_launches``)."""
    m, k, n, group = shape
    g = torch.Generator(device=cuda).manual_seed(33)
    if bits == 4:
        qw, scales, zeros = random_int4(k, n, group, g, cuda)
        fn, deq = int4_matmul, dequantize_int4
    else:
        qw, scales, zeros = random_int8(k, n, group, g, cuda)
        fn, deq = int8_matmul, dequantize_int8
    x = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    counts = fn.launches, fn.f32out_launches, fn.f32_launches
    got = fn(x, qw, scales, zeros, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert (fn.launches, fn.f32out_launches, fn.f32_launches) == (
        counts[0] + 1, counts[1] + 1, counts[2])
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert torch.equal(got.bfloat16(), fn(x, qw, scales, zeros))
    w = deq(qw, scales, zeros, torch.bfloat16).float()
    want = x.float() @ w
    bound = fp32_ulp(want) + 2 * k * 2.0**-24 * (x.float().abs() @ w.abs())
    diff = (got - want).abs()
    assert torch.all(diff <= bound), (diff / bound).max().item()


@pytest.mark.parametrize("bits", [4, 8])
def test_plain_fp32_output_is_the_unrounded_product(bits):
    """On the CPU: the plain C / #13 with an fp32 ``out_dtype`` (and the
    wrapper, which takes it for a CPU tensor) is ``F.linear`` of the fp32
    upcast of x on the weight dequantised in x's dtype, upcast: no rounding
    of the sums; the default output is that product rounded to bf16 by
    the bf16 matmul, at most one bf16 step from it."""
    import torch.nn.functional as F

    from diffusionkit_tpu_torch.ops.int4_matmul import int4_matmul_plain, int8_matmul_plain

    g = torch.Generator().manual_seed(34)
    k, n, group = 512, 256, 32
    if bits == 4:
        qw, scales, zeros = random_int4(k, n, group, g, "cpu")
        fn, plain, deq = int4_matmul, int4_matmul_plain, dequantize_int4
    else:
        qw, scales, zeros = random_int8(k, n, group, g, "cpu")
        fn, plain, deq = int8_matmul, int8_matmul_plain, dequantize_int8
    x = torch.randn(37, k, generator=g).bfloat16()
    w = deq(qw, scales, zeros, torch.bfloat16).float()
    want = F.linear(x.float(), w.t())
    for got in (plain(x, qw, scales, zeros, torch.float32),
                fn(x, qw, scales, zeros, out_dtype=torch.float32)):
        assert got.dtype == torch.float32 and torch.equal(got, want)
    rounded = plain(x, qw, scales, zeros)
    assert rounded.dtype == torch.bfloat16
    assert torch.all((rounded.float() - want).abs() <= want.abs() * 2.0**-8 + 1e-30)
    assert not torch.equal(rounded.float(), want)


# -- the split-K GEMV of C, #13 and E at M <= 16 (csrc/gemv_sm90.cu) -----------

# (K, N, group) of the `ada` GEMVs on the measured paths: FLUX's dual and
# single blocks (C and E, group 64) and SD3's blocks at the quantize-at-load
# group 32 (#13); then shapes where K caps S below the card's fill: SD3's
# final layer, its t embedder and its y embedder.
GEMV_PATH_SHAPES = [(3072, 18432, 64), (3072, 9216, 64), (1536, 9216, 32)]
GEMV_NARROW_SHAPES = [(1536, 3072, 32), (256, 1536, 32), (2048, 1536, 32)]


def _gemv_accepted(name):
    if name == "w4a8_matmul":
        return [(k, n, group) for k, n, group, mode in E_ACCEPTED if mode == "plain"]
    return [(k, n, group) for k in (64, 512, 1536, 3072, 12288) for n in (128, 384, 3072)
            for group in (32, 64, 128, 192) if k % group == 0]


@pytest.mark.parametrize("name", ["int4_matmul", "int8_matmul", "w4a8_matmul"])
def test_gemv_splits_cover_k_in_whole_parts_and_groups(name):
    """At every (K, N, group) the route tests take at M <= 16, S splits K
    exactly, each split a whole number of the GEMV's 64-k parts and of
    groups, and S is at most 8."""
    from diffusionkit_tpu_torch.ops.int4_matmul import gemv_splits

    for k, n, group in _gemv_accepted(name):
        s = gemv_splits(k, n, group)
        assert 1 <= s <= 8 and k % s == 0, (k, n, group, s)
        assert (k // s) % 64 == 0 and (k // s) % group == 0, (k, n, group, s)


@pytest.mark.parametrize("shape", GEMV_PATH_SHAPES)
def test_gemv_splits_fill_the_card_at_the_path_shapes(shape):
    """The path's GEMVs put a block on every SM of the H100's 132 and more
    than one on most: 216 or 432 blocks, in one or two waves of the
    kernel's 264 resident blocks."""
    from diffusionkit_tpu_torch.ops.int4_matmul import gemv_splits

    k, n, group = shape
    assert (n // 128) * gemv_splits(k, n, group) >= 1.5 * 132


@pytest.mark.parametrize("shape", GEMV_NARROW_SHAPES)
def test_gemv_splits_take_the_most_that_k_allows(shape):
    """Where even the largest split that K allows leaves the card's
    resident blocks short of one wave, S is that split."""
    from diffusionkit_tpu_torch.ops.int4_matmul import gemv_splits

    k, n, group = shape
    allowed = [s for s in range(1, 9) if k % (s * 64) == 0 and (k // s) % group == 0]
    assert (n // 128) * max(allowed) < 2 * 132
    assert gemv_splits(k, n, group) == max(allowed)


# (M, K, N, group) of the GPU GEMV cases: the path's `ada` shapes (FLUX at
# M = 1, SD3 at M = 2), then M from 1 to 16 against groups 32 to 256, K
# from 128 to 12288 and N from 128 to 18432. Every case runs C, #13 and E.
GEMV_CASES = [(1, 3072, 18432, 64), (1, 3072, 9216, 64), (2, 1536, 9216, 32),
              (2, 1536, 3072, 32), (2, 256, 1536, 32), (2, 2048, 1536, 64), (3, 128, 128, 32),
              (8, 12288, 384, 128), (15, 4096, 640, 256), (16, 512, 18432, 64),
              (1, 12288, 128, 256), (16, 128, 256, 64)]


def _gemv_call(kind, m, k, n, group, gen, device, x_offset=0):
    """One GEMV call of ``kind`` (int4, int8, w4a8) on random inputs; C and
    #13 read x as a column slice of a wider activation when ``x_offset``.
    Returns (the call, its wrapper, a check of an output)."""
    if kind == "w4a8":
        layer, x8, xs, _ = w4a8_inputs("plain", m, k, n, group, gen, device)
        args = (x8, layer.q4, layer.scales, layer.zeros, layer.wscale, xs, layer.bias)
        want = w4a8_matmul_plain(*args)

        def check(got):
            assert got.dtype == torch.bfloat16 and torch.equal(got, want)
        return (lambda: w4a8_matmul(*args)), w4a8_matmul, check
    if kind == "int4":
        qw, scales, zeros = random_int4(k, n, group, gen, device)
        w = dequantize_int4(qw, scales, zeros, torch.bfloat16).float()
        fn = int4_matmul
    else:
        qw, scales, zeros = random_int8(k, n, group, gen, device)
        w = dequantize_int8(qw, scales, zeros, torch.bfloat16).float()
        fn = int8_matmul
    wide = torch.randn(m, k + 2 * x_offset, generator=gen, device=device).bfloat16()
    x = wide[:, x_offset:x_offset + k]
    want = x.float() @ w
    slack = 2 * k * 2.0**-24 * (x.float().abs() @ w.abs())

    def check(got):
        assert got.dtype == torch.bfloat16 and got.shape == (m, n)
        diff = (got.float() - want).abs()
        bound = bf16_ulp(want) + slack
        assert torch.all(diff <= bound), (diff / bound).max().item()
    return (lambda: fn(x, qw, scales, zeros)), fn, check


@pytest.mark.gpu
@pytest.mark.parametrize("case", GEMV_CASES)
@pytest.mark.parametrize("kind", ["int4", "int8", "w4a8"])
def test_gemv_matches_plain(cuda, kind, case):
    """The GEMV against its plain version, one launch a call on the GEMV
    route: E bit-identical; C and #13 within one bf16 ulp + 2K 2^-24
    (|x| @ |w|) of fp32 math on the same bf16 weights, x read in place from
    a wider row (C, #13); a repeat bit-identical."""
    m, k, n, group = case
    g = torch.Generator(device=cuda).manual_seed(31)
    call, fn, check = _gemv_call(kind, m, k, n, group, g, cuda, x_offset=64)
    launches, gemv = fn.launches, fn.gemv_launches
    got = call()
    torch.cuda.synchronize()
    assert (fn.launches, fn.gemv_launches) == (launches + 1, gemv + 1)
    check(got)
    assert torch.equal(call(), got)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("kind", ["int4", "int8", "w4a8"])
def test_gemv_at_every_split(cuda, kind, splits, monkeypatch):
    """Every split the GEMV can be given at K = 3072 (the last block of a
    column tile adds the S partials in split order), M = 2 and M = 16."""
    from diffusionkit_tpu_torch.ops import int4_matmul as c_ops
    from diffusionkit_tpu_torch.ops import w4a8_matmul as e_ops

    monkeypatch.setattr(c_ops, "gemv_splits", lambda k, n, group: splits)
    monkeypatch.setattr(e_ops, "gemv_splits", lambda k, n, group: splits)
    g = torch.Generator(device=cuda).manual_seed(32)
    for m in (2, 16):
        call, _, check = _gemv_call(kind, m, 3072, 384, 64, g, cuda)
        check(call())


@pytest.mark.gpu
@pytest.mark.parametrize("k", [64, 192, 320])
@pytest.mark.parametrize("kind", ["int4", "int8"])
def test_gemv_at_k_short_of_128(cuda, kind, k, monkeypatch):
    """C and #13 at a K that is a multiple of 64 but not of 128, in one
    block along K: C's parts then end in a chunk of one word row, and at
    group 32 a group starts at a chunk's second row."""
    from diffusionkit_tpu_torch.ops import int4_matmul as c_ops

    monkeypatch.setattr(c_ops, "gemv_splits", lambda k, n, group: 1)
    g = torch.Generator(device=cuda).manual_seed(34)
    for m, group in ((1, 32), (16, 64)):
        if k % group == 0:
            call, _, check = _gemv_call(kind, m, k, 256, group, g, cuda)
            check(call())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["int4", "int8", "w4a8"])
def test_gemv_graph_replays_are_bit_identical(cuda, kind):
    """Two replays of one CUDA graph of the GEMV give the same output bit
    for bit, equal to an eager call's: nothing in the kernel carries state
    from one launch to the next."""
    g = torch.Generator(device=cuda).manual_seed(33)
    call, _, check = _gemv_call(kind, 2, 1536, 9216, 32, g, cuda)
    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    graph.replay()
    torch.cuda.synchronize()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, first) and torch.equal(first, eager)
    check(first)


# -- kernel D's rows, and #11's split-K GEMV at M <= 16 ---------------------------

# Kernel D at every split of a row: 1 to 8 warps a row and 1 to 16 vectors
# a lane (vector counts from 8 to the widest fp32 row's 4096), at a few
# rows (more warps a row), at 701 rows (two rows a block, the last block
# half empty) and at 4099 (up to eight rows a block, ragged).
QUANT_SPLIT_VECS = [8, 32, 96, 192, 200, 384, 600, 1024, 1536, 2048, 3072, 4096]


@pytest.mark.gpu
@pytest.mark.parametrize("nvec", QUANT_SPLIT_VECS)
@pytest.mark.parametrize("m", [2, 13, 701, 4099])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_kernel_at_every_row_split(cuda, nvec, m, dtype):
    k = nvec * (8 if dtype == torch.bfloat16 else 4)
    if k > 16384:
        pytest.skip(f"K={k} is past the widest row kernel D takes (16384)")
    g = torch.Generator(device=cuda).manual_seed(40)
    y = (torch.randn(m, k, generator=g, device=cuda) * 3).to(dtype)
    got, want = quantize(y), quantize_plain(y)
    assert torch.equal(got.x8, want.x8) and torch.equal(got.xscale, want.xscale)


def special_rows(k: int, dtype, gen, device) -> torch.Tensor:
    """Nine rows of width k: random values with +-0 and subnormals set in
    them; all zeros; one 1e30; one 3e38 (a scale near the largest float);
    one +inf; one -inf; one NaN; subnormals only (amax below 1e-8); NaN
    only."""
    rows = torch.randn(9, k, generator=gen, device=device) * 3
    rows[0, :6] = torch.tensor([0.0, -0.0, 1e-40, -1e-40, 1e-39, -3e-39])
    rows[1] = 0.0
    rows[2, 5] = 1e30
    rows[3, 7] = -3e38
    rows[4, 1] = float("inf")
    rows[5, k - 1] = float("-inf")
    rows[6, 3] = float("nan")
    rows[7] = rows[7].sign() * 1e-39
    rows[8] = float("nan")
    return rows.to(dtype)


def quantize_rule(y: torch.Tensor):
    """Kernel D's x8 and scale on any input (the plain version's where the
    rows are finite): amax the largest |y| that is not NaN (fmaxf from 0),
    s = max(amax, 1e-8) / 127 (inf in a row holding an infinity), x8 =
    clip(rne(y / s)) with a NaN quotient at -127 (fmaxf(NaN, -127) is
    -127), both divisions IEEE."""
    v = y.float()
    a = torch.where(torch.isnan(v), torch.zeros_like(v), v.abs()).amax(dim=-1, keepdim=True)
    s = a.clamp_min(1e-8) / torch.full_like(a, 127.0)
    q = v / s
    q = torch.where(torch.isnan(q), torch.full_like(q, -127.0), q)
    return torch.round(q.clamp(-127.0, 127.0)).to(torch.int8), s


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1536, 3072, 10240])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_kernel_on_special_values(cuda, k, dtype):
    """Kernel D at +-0, subnormals, 1e30, 3e38, +-inf, an all-zero row and
    NaN: its rule bit for bit (the IEEE division, NaN to -127, as the
    per-element division of its earlier form gave), the plain version
    itself on the finite rows; and #11's
    quantizing GEMV on the same rows equals D then #11, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(41)
    y = special_rows(k, dtype, g, cuda)
    got = quantize(y)
    x8, s = quantize_rule(y)
    assert torch.equal(got.x8, x8) and torch.equal(got.xscale.view(torch.int32),
                                                   s.view(torch.int32))
    finite = [0, 1, 2, 3, 7]
    want = quantize_plain(y[finite])
    assert torch.equal(got.x8[finite], want.x8) and torch.equal(got.xscale[finite], want.xscale)
    _, w8, ws, _, b = random_w8(9, k, 256, g, cuda, dtype=dtype)
    fused = quantize_w8_matmul(y, w8, ws, b, out_dtype=dtype)
    staged = w8_matmul(got.x8, w8, ws, got.xscale, b, out_dtype=dtype)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(fused.view(bits), staged.view(bits))


@pytest.mark.gpu
@pytest.mark.parametrize("form", [None, "erf", "tanh"])
@pytest.mark.parametrize("shape", [(256, 5120), (4352, 1536), (2048, 3072), (13, 1000), (9, 200),
                                   (1, 5120), (3, 5120), (256, 16384), (8192, 1216)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_two_pass_quantizers_are_the_one_pass_kernels(cuda, form, shape, dtype):
    """The two-pass D (form None) and #4 on whole rows, and over the rows'
    columns split in 2 and 4 with the pass-1 absmaxes combined by max: the
    one-pass kernel's x8 and xscale bit for bit; also on D's special
    values (+-0, subnormals, 1e30, 3e38, +-inf, NaN). Rows of 1 and 3 (a
    few warps or blocks cover the card), of 16384 (8 warps of 8 or 16
    vectors a lane whole; 8192 and 4096 split), and path x's o input."""
    m, k = shape
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    g = torch.Generator(device=cuda).manual_seed(43)
    y = (torch.randn(m, k, generator=g, device=cuda) * 3).to(dtype)
    one = quantize if form is None else (lambda t: gelu_quantize(t, form))
    want = one(y)
    for n in (1, 2, 4):
        if (k // n) % vec:
            continue
        parts = [t.contiguous() for t in y.chunk(n, dim=-1)]
        amax = torch.stack([row_absmax(t, form) for t in parts]).amax(dim=0)
        got = [quantize_amax(t, amax, form) for t in parts]
        assert torch.equal(torch.cat([a.x8 for a in got], dim=-1), want.x8), n
        assert all(torch.equal(a.xscale, want.xscale) for a in got), n
    if form is None:
        special = special_rows(k - k % vec, dtype, g, cuda)
        got = quantize_amax(special, row_absmax(special))
        want = quantize(special)
        assert torch.equal(got.x8, want.x8)
        assert torch.equal(got.xscale.view(torch.int32), want.xscale.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("m, k, hidden", [(333, 2432, 9728), (77, 1024, 2560), (1, 2432, 9728),
                                          (8193, 2432, 9728), (77, 1024, 1024)])
def test_tile_passes_are_e_gelu_quant(cuda, m, k, hidden):
    """The tiles route's kernels (``tile_absmax``, ``tile_quantize``) on the
    columns of E's fp32 mode-plain output split over 1, 2 and 4 ranks
    (scale tiles straddling ranks; at hidden 9728 over 4, rank 1 holds two
    straddled parts; at 1024 over 4, each rank part of one tile), the
    absmaxes combined by max: E's gelu_quant bytes side by side, and its
    scales in each rank's tiles, bit for bit; the plain versions the same.
    Pass 1 is 0 in every tile no rank boundary cuts, as its plain version."""
    from diffusionkit_tpu_torch.ops.fused_quant import (
        straddled_tiles, tile_absmax, tile_absmax_plain, tile_quantize, tile_quantize_plain,
    )

    g = torch.Generator(device=cuda).manual_seed(47)
    layer = random_w4a8(k, hidden, 64, g, cuda)
    x8 = torch.randint(-127, 128, (m, k), generator=g, device=cuda, dtype=torch.int8)
    xs = torch.rand(m, 1, generator=g, device=cuda) * 0.02
    args = (x8, layer.q4, layer.scales, layer.zeros, layer.wscale, xs, layer.bias.float())
    want8, want_s = w4a8_matmul(*args, mode="gelu_quant")
    y = w4a8_matmul(*args, out_dtype=torch.float32)
    tiles = hidden // 512
    for n in (1, 2, 4):
        n1 = hidden // n
        parts = [y[:, r * n1:(r + 1) * n1].contiguous() for r in range(n)]
        uncut = [t for t in range(tiles) if t not in straddled_tiles(hidden, n)]
        for absmax, quant in ((tile_absmax, tile_quantize),
                              (tile_absmax_plain, tile_quantize_plain)):
            amaxes = [absmax(t, r * n1, tiles) for r, t in enumerate(parts)]
            assert not any(a[:, uncut].any() for a in amaxes), n
            amax = torch.stack(amaxes).amax(0)
            got = [quant(t, amax, r * n1) for r, t in enumerate(parts)]
            assert torch.equal(torch.cat([a for a, _ in got], dim=-1), want8), n
            for r, (_, ys) in enumerate(got):
                held = slice(r * n1 // 512, ((r + 1) * n1 - 1) // 512 + 1)
                assert torch.equal(ys[:, held], want_s[:, held]), (n, r)


@pytest.mark.gpu
@pytest.mark.parametrize("form", [None, "erf"])
@pytest.mark.parametrize("m, k", [(256, 5120), (3, 5120), (2048, 3072)])
def test_two_pass_graph_replays_are_bit_identical(cuda, form, m, k):
    from diffusionkit_tpu_torch.ops.fused_quant import quantize_amax, row_absmax

    g = torch.Generator(device=cuda).manual_seed(42)
    y = (torch.randn(m, k, generator=g, device=cuda) * 3).bfloat16()
    assert_graph_replays_bit_identical(lambda: quantize_amax(y, row_absmax(y, form), form))


@pytest.mark.gpu
@pytest.mark.parametrize("n1, col0", [(4864, 0), (4864, 4864), (2432, 2432), (256, 256)])
def test_tile_graph_replays_are_bit_identical(cuda, n1, col0):
    """The tiles passes on one rank's columns (rank 0 and 1 of hidden 9728
    over 2, rank 1 over 4, and a rank holding part of one tile), under a
    graph: the int8 hidden and the scales bit for bit."""
    from types import SimpleNamespace

    from diffusionkit_tpu_torch.ops.fused_quant import tile_absmax, tile_quantize

    g = torch.Generator(device=cuda).manual_seed(43)
    y = torch.randn(777, n1, generator=g, device=cuda) * 2
    tiles = 19 if n1 > 256 else 2

    def call():
        y8, ys = tile_quantize(y, tile_absmax(y, col0, tiles), col0)
        return SimpleNamespace(x8=y8, xscale=ys)

    assert_graph_replays_bit_identical(call)


@pytest.mark.gpu
def test_quantize_graph_replays_are_bit_identical(cuda):
    g = torch.Generator(device=cuda).manual_seed(42)
    y = (torch.randn(2048, 1536, generator=g, device=cuda) * 3).bfloat16()
    assert_graph_replays_bit_identical(lambda: quantize(y))


# (M, K, N) of #11's GEMV: the five shapes of the SD3 w8a8 path's `ada` and
# embedder projections (the blocks' `ada`, the final layer's, the t
# embedder's two, the y embedder's first), then M = 1, 3 and 16 at the
# blocks' `ada`, N past one wave of column tiles, one 64-column tile, and
# K split 2 and 6 ways (a cluster of blocks a tile).
W8_GEMV_CASES = [(2, 1536, 9216), (2, 1536, 3072), (2, 256, 1536), (2, 1536, 1536),
                 (2, 2048, 1536), (1, 1536, 9216), (3, 1536, 9216), (16, 1536, 9216),
                 (5, 4096, 18432), (16, 256, 64), (2, 12288, 128)]


def w8_gemv_args(m, k, n, gen, device, x_dtype, out_dtype, bias=True):
    """#11's inputs: x bf16 or fp32 (quantized by kernel D for the int8
    entry), w8, wscale and the bias in the output dtype."""
    x = (torch.randn(m, k, generator=gen, device=device) * 2).to(x_dtype)
    w8 = torch.randint(-127, 128, (n, k), generator=gen, device=device, dtype=torch.int8)
    ws = (torch.rand(n, generator=gen, device=device) + 0.5) / (127 * k**0.5)
    b = (0.1 * torch.randn(n, generator=gen, device=device)).to(out_dtype) if bias else None
    return x, w8, ws, b


@pytest.mark.gpu
@pytest.mark.parametrize("case", W8_GEMV_CASES)
@pytest.mark.parametrize("x_dtype,out_dtype,bias", [
    (torch.bfloat16, torch.bfloat16, True), (torch.float32, torch.float32, True),
    (torch.bfloat16, torch.float32, False)])
def test_w8_gemv_matches_plain(cuda, case, x_dtype, out_dtype, bias):
    """#11's GEMV, int8 entry and quantizing entry, one launch each on the
    GEMV route: the int8 entry equals ``w8_matmul_plain`` and the
    quantizing one ``quantize_plain`` then ``w8_matmul_plain``, bit for
    bit; a repeat bit-identical."""
    m, k, n = case
    g = torch.Generator(device=cuda).manual_seed(43)
    x, w8, ws, b = w8_gemv_args(m, k, n, g, cuda, x_dtype, out_dtype, bias)
    aq = quantize_plain(x)
    launches = (w8_matmul.launches, w8_matmul.gemv_launches, w8_matmul.quantizing_launches)
    got = w8_matmul(aq.x8, w8, ws, aq.xscale, b, out_dtype)
    fused = quantize_w8_matmul(x, w8, ws, b, out_dtype)
    torch.cuda.synchronize()
    assert (w8_matmul.launches, w8_matmul.gemv_launches, w8_matmul.quantizing_launches) == (
        launches[0] + 2, launches[1] + 2, launches[2] + 1)
    want = w8_matmul_plain(aq.x8, w8, ws, aq.xscale, b, out_dtype)
    assert got.dtype == fused.dtype == out_dtype and got.shape == (m, n)
    assert torch.equal(got, want) and torch.equal(fused, want)
    assert torch.equal(quantize_w8_matmul_plain(x, w8, ws, b, out_dtype), want)
    assert torch.equal(quantize_w8_matmul(x, w8, ws, b, out_dtype), fused)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 6, 8])
def test_w8_gemv_at_every_split(cuda, splits, monkeypatch):
    """Every split the GEMV can be given at K = 6144, M = 1, 2 and 16, both
    entries: the S blocks of a column tile's cluster add their partials."""
    from diffusionkit_tpu_torch.ops import w4a8_matmul as e_ops

    monkeypatch.setattr(e_ops, "w8_gemv_splits", lambda k: splits)
    g = torch.Generator(device=cuda).manual_seed(44)
    for m in (1, 2, 16):
        x, w8, ws, b = w8_gemv_args(m, 6144, 384, g, cuda, torch.bfloat16, torch.bfloat16)
        aq = quantize_plain(x)
        want = w8_matmul_plain(aq.x8, w8, ws, aq.xscale, b)
        assert torch.equal(w8_matmul(aq.x8, w8, ws, aq.xscale, b), want)
        assert torch.equal(quantize_w8_matmul(x, w8, ws, b), want)


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["int8", "quantizing"])
def test_w8_gemv_graph_replays_are_bit_identical(cuda, entry):
    """Two replays of one CUDA graph of the GEMV give the same output bit
    for bit, equal to an eager call's: the arrival counters are back at 0
    after every launch."""
    g = torch.Generator(device=cuda).manual_seed(45)
    x, w8, ws, b = w8_gemv_args(2, 1536, 9216, g, cuda, torch.bfloat16, torch.bfloat16)
    aq = quantize(x)
    if entry == "int8":
        call = lambda: w8_matmul(aq.x8, w8, ws, aq.xscale, b)  # noqa: E731
    else:
        call = lambda: quantize_w8_matmul(x, w8, ws, b)  # noqa: E731
    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    graph.replay()
    torch.cuda.synchronize()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, first) and torch.equal(first, eager)


@pytest.mark.gpu
def test_w8a8_linear_takes_the_quantizing_gemv(cuda):
    """A w8a8 linear on a float x of 2 rows launches #11's quantizing GEMV
    and no kernel D; on 17 rows, D then #11's Hopper loop; an ActQuant of
    2 rows the GEMV's int8 entry. Each equals the plain path bit for bit."""
    from diffusionkit_tpu_torch.ops.w8a8 import W8A8Linear, quantize_shared, w8a8_linear

    g = torch.Generator(device=cuda).manual_seed(46)
    layer = W8A8Linear(1536, 3072, device=cuda)
    layer.w8.random_(-127, 128, generator=g)
    layer.wscale.copy_((torch.rand(3072, generator=g, device=cuda) + 0.5) / 127 / 40)
    layer.bias.copy_(0.1 * torch.randn(3072, generator=g, device=cuda))
    plain = W8A8Linear(1536, 3072, device="cpu")
    plain.load_state_dict({k: v.cpu() for k, v in layer.state_dict().items()})
    for m, d_launches, quantizing in ((2, 0, 1), (17, 1, 0)):
        x = torch.randn(m, 1536, generator=g, device=cuda).bfloat16()
        before = (quantize.launches, w8_matmul.quantizing_launches)
        got = w8a8_linear(layer, x)
        torch.cuda.synchronize()
        assert (quantize.launches - before[0], w8_matmul.quantizing_launches - before[1]) == (
            d_launches, quantizing)
        assert torch.equal(got.cpu(), w8a8_linear(plain, x.cpu()))
    x = torch.randn(2, 1536, generator=g, device=cuda).bfloat16()
    aq = quantize_shared(x)
    gemv = w8_matmul.gemv_launches
    assert torch.equal(w8a8_linear(layer, aq), w8a8_linear(layer, x))
    assert w8_matmul.gemv_launches == gemv + 2


W8_ACCEPTED = [(k, n) for k in (64, 192, 256, 1536, 2048, 3072, 10240)
               for n in (8, 64, 128, 200, 1536, 3072, 9216)]


@pytest.mark.parametrize("m", ROUTE_ROWS)
def test_w8_route_takes_every_accepted_shape(m):
    """#11 at every (K, N) its wrapper takes goes to a main loop that takes
    it: the GEMV at M <= 16 with K a multiple of 256 and N of 64 (its S
    splits of K each whole 256-k parts), the Hopper loop above 16 rows
    with K a multiple of 128, its 64-deep loop above 16 rows with K % 128
    == 64 (the x_embedder's K = 64; K = 192), the mma.sync tile otherwise
    (M <= 16, any K a multiple of 64, N of 8); the quantizing entry only on
    the GEMV's route; what the wrapper refused it still refuses."""
    from diffusionkit_tpu_torch.ops.w4a8_matmul import (
        w8_gemv_splits,
        w8_quantizes_in_gemv,
        w8_route,
    )

    for k, n in W8_ACCEPTED:
        route = w8_route(m, k, n)
        if m <= 16 and k % 256 == 0 and n % 64 == 0:  # every slab here fits
            assert route == "gemv"
            s = w8_gemv_splits(k)
            assert 1 <= s <= 8 and k % (s * 256) == 0, (k, n, s)
            assert w8_quantizes_in_gemv(m, k, n)
        else:
            want = ("sm90" if k % 128 == 0 else "sm90_k64") if m > 16 else "tile"
            assert route == want
            assert not w8_quantizes_in_gemv(m, k, n)
    for k, n in [(96, 128), (1536, 100), (0, 128), (1536 + 32, 1536)]:
        with pytest.raises(ValueError):
            w8_route(m, k, n)
        assert not w8_quantizes_in_gemv(m, k, n)


@pytest.mark.parametrize("shape", [(1536, 9216), (1536, 3072), (256, 1536), (1536, 1536),
                                   (2048, 1536)])
def test_gemv_splits_cover_k_in_whole_parts_at_w8_shapes(shape):
    """At #11's five GEMV shapes of the SD3 w8a8 path, S covers K in whole
    256-k parts (four warps' parts of 64-k chunks) and is one: no block
    streams more than 2048 k, so no cluster sums partials (at the blocks'
    `ada`, 1536 x 9216, 144 blocks of 64 columns); wider K splits into the
    fewest parts of at most 2048 k."""
    from diffusionkit_tpu_torch.ops.w4a8_matmul import w8_gemv_splits

    k, n = shape
    s = w8_gemv_splits(k)
    assert s == 1 and k % (s * 256) == 0
    assert [w8_gemv_splits(k) for k in (2304, 4096, 10240, 12288, 256 * 13)] == [3, 2, 5, 6, 1]


def test_quantizing_gemv_route_is_bounded_by_its_shared_memory():
    """The GEMV holds its block's M x (K / S + 64) bytes of x beside the
    partials in the card's 227 KB a block: the route leaves wider slabs to
    the tile (and a float x to kernel D then the tile)."""
    from diffusionkit_tpu_torch.ops.w4a8_matmul import w8_quantizes_in_gemv, w8_route

    assert w8_quantizes_in_gemv(16, 10240, 128)  # S = 5: slabs of 2048 k
    assert not w8_quantizes_in_gemv(16, 256 * 79, 128)  # S = 1: 16 x 20288 bytes
    assert w8_route(16, 256 * 79, 128) == "tile"
    assert w8_quantizes_in_gemv(2, 256 * 79, 128)
    assert not w8_quantizes_in_gemv(0, 1536, 1536)


# -- the denoise loop as a CUDA graph -----------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["sd3", "flux-dev", "sd35", "sd35-int4", "sd35-w4a8"])
def test_denoise_graph_is_the_synced_loop(cuda, model):
    """The default scan (one step captured as a CUDA graph, replayed once a
    step) against the synced loop on a small bf16 MMDiT on the card:
    bit-identical latents, and the wrappers' counters rising by the same
    launches (a replay adds the capture's delta); a second request reuses
    the graph. FLUX-dev exercises RoPE's cached tables and the guidance
    scalar; SD3.5 (3 blocks, block 1 upcast to fp32) its fp32 block on the
    fp32 kernels, in bf16 and with int4 or w4a8 block linears."""
    import dataclasses

    from diffusionkit_tpu_torch.config import FLUX_DEV, SD3_2b, SD3_8b
    from diffusionkit_tpu_torch.models import init_mmdit
    from diffusionkit_tpu_torch.ops import launches
    from diffusionkit_tpu_torch.pipeline import DiffusionPipeline, FluxPipeline

    gen = torch.Generator(device=cuda).manual_seed(25)
    if model == "sd3":
        cfg = dataclasses.replace(SD3_2b, depth_multimodal=2, num_heads=4,
                                  hidden_size_override=256, max_latent_resolution=32)
        pipe = DiffusionPipeline(load=False, low_memory_mode=False, device=cuda, use_t5=False)
        cfg_weight, text_dim, pooled_dim = 5.0, 4096, 2048
    elif model.startswith("sd35"):
        cfg = dataclasses.replace(SD3_8b, depth_multimodal=3, num_heads=4, hidden_size_override=256,
                                  max_latent_resolution=32, upcast_multimodal_blocks=(1,))
        mode = {"sd35-int4": "int4", "sd35-w4a8": "w4a8"}.get(model, False)
        pipe = DiffusionPipeline(load=False, low_memory_mode=False,
                                 device=cuda, use_t5=False, quantize_mmdit=mode,
                                 quantize_group_size=64)
        cfg_weight, text_dim, pooled_dim = 5.0, 4096, 2048
    else:
        cfg = dataclasses.replace(FLUX_DEV, depth_multimodal=1, depth_unified=2, num_heads=4,
                                  hidden_size_override=512, rope_axes_dim=(16, 56, 56))
        pipe = FluxPipeline(load=False, low_memory_mode=False, device=cuda)
        cfg_weight, text_dim, pooled_dim = 0.0, 4096, 768
    pipe.mmdit = init_mmdit(cfg, gen, cuda)
    rows = 2 if cfg_weight > 1 else 1
    cond = torch.randn(rows, 77, text_dim, generator=gen, device=cuda)
    pooled = torch.randn(rows, pooled_dim, generator=gen, device=cuda)
    # 1024 image + 77 text tokens: past the flash threshold.
    kw = dict(num_steps=4, cfg_weight=cfg_weight, latent_size=(64, 64), seed=3, guidance=4.0)

    def run(use_scan):
        pipe.use_scan = use_scan
        before = launches.snapshot()
        lat, it = pipe.denoise_latents(cond, pooled, **kw)
        torch.cuda.synchronize()
        return lat, it, launches.delta(before, launches.snapshot())

    graph, it, counted = run(True)
    again, _, counted_again = run(True)
    loop, it_loop, counted_loop = run(False)
    assert len(pipe._scans) == 1 and next(iter(pipe._scans.values())).graph.graph is not None
    assert torch.isfinite(graph).all() and graph.shape == (1, 64, 64, 16)
    assert torch.equal(graph, loop) and torch.equal(again, graph)
    assert counted == counted_again == counted_loop
    assert counted[("mod_ln", "launches")] > 0
    assert counted[("flash_attention_bshd", "launches")] == 4 * (len(pipe.mmdit.mm_blocks) + (
        len(pipe.mmdit.uni_blocks) or 1))
    upcast = len(cfg.upcast_multimodal_blocks)
    assert counted[("flash_attention_bshd", "f32_launches")] == 4 * upcast
    if model == "sd35-int4":  # block 1's six linears a stream on the fp32 tile
        assert counted[("int4_matmul", "f32_launches")] == 4 * 2 * 6
    if model == "sd35-w4a8":  # its fc1 / fc2 and `ada` GEMVs with fp32 bias or output
        assert counted[("w4a8_matmul", "f32_launches")] == 4 * 2 * 3
    assert len(it) == len(it_loop) == 4 and len(set(it)) == 1


@pytest.mark.gpu
def test_img2img_encoder_on_the_card(cuda, tmp_path):
    """img2img on a small bf16 SD3 MMDiT with a small fp32 VAE encoder on
    the card: the encoder's mid-block (48 x 48 positions, one head of 64)
    on kernel B's fp32 form, once an encode, the encode within 1e-4
    relative L2 of the same weights in fp32 on the CPU; the graph's latents
    the synced loop's bit for bit; after a txt2img request (a longer cached
    schedule) the img2img latents the first request's bit for bit."""
    import dataclasses

    from PIL import Image

    from diffusionkit_tpu_torch.config import SD3_2b, VAEEncoderConfig
    from diffusionkit_tpu_torch.models import init_mmdit, init_vae_encoder
    from diffusionkit_tpu_torch.ops import launches
    from diffusionkit_tpu_torch.pipeline import DiffusionPipeline, _encode_step

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(26)
    cfg = dataclasses.replace(SD3_2b, depth_multimodal=2, num_heads=4, hidden_size_override=256,
                              max_latent_resolution=64)
    pipe = DiffusionPipeline(load=False, low_memory_mode=False, device=cuda, use_t5=False)
    pipe.mmdit = init_mmdit(cfg, gen, cuda)
    pipe.encoder = init_vae_encoder(VAEEncoderConfig(block_out_channels=(64,) * 4,
                                                     resnet_groups=32), gen, cuda)
    src = tmp_path / "src.png"
    Image.fromarray(np.random.RandomState(0).randint(0, 256, (384, 384, 3)).astype(np.uint8)
                    ).save(src)
    cond = torch.randn(2, 77, 4096, generator=gen, device=cuda)
    pooled = torch.randn(2, 2048, generator=gen, device=cuda)
    kw = dict(num_steps=4, cfg_weight=5.0, latent_size=(48, 48), seed=3)
    img2img = dict(kw, image_path=str(src), denoise=0.5)

    before = launches.snapshot()
    latents = pipe.encode_image_to_latents(str(src), seed=3)
    torch.cuda.synchronize()
    counted = launches.delta(before, launches.snapshot())
    assert counted[("flash_attention_bshd", "f32_launches")] == 1
    with torch.inference_mode():
        image = torch.from_numpy(pipe.read_image(str(src)))
        noise = torch.from_numpy(pipe.get_noise(3, np.zeros((1, 48, 48, 16), np.float32)))
        want = _encode_step(pipe.encoder.cpu(), image, noise)
    pipe.encoder.to(cuda)
    rel = ((latents.cpu() - want).norm() / want.norm()).item()
    assert latents.shape == (1, 48, 48, 16) and rel < 1e-4

    first, it = pipe.denoise_latents(cond, pooled, **img2img)
    pipe.use_scan = False
    loop, _ = pipe.denoise_latents(cond, pooled, **img2img)
    pipe.use_scan = True
    pipe.denoise_latents(cond, pooled, **kw)  # txt2img: 5 sigmas cached
    again, _ = pipe.denoise_latents(cond, pooled, **img2img)
    assert len(it) == 2 and torch.isfinite(first).all()
    assert torch.equal(loop, first) and torch.equal(again, first)


@pytest.mark.gpu
@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("qmax", [15, 255])
@pytest.mark.parametrize("identity", [False, True], ids=["gptq", "als"])
def test_gptq_group_kernel_is_its_plain_version(cuda, gs, qmax, identity):
    """The GPTQ group step (csrc/gptq.cu) against its plain version on the
    card, bit for bit: codes, scales, zeros and err, over 3 groups of a
    ragged width, with a block of U (rows of a wider matrix) or the
    identity repeated (the ALS grid); and the ALS grid against the CPU's
    (numpy's _als_refine_host there)."""
    from diffusionkit_tpu_torch.ops.gptq import als_grid, gptq_group, gptq_group_plain

    g = torch.Generator(device=cuda).manual_seed(gs + qmax)
    w = 0.02 * torch.randn(3, gs, 333, generator=g, device=cuda)
    w[0, :, :5] = 0.0
    if identity:
        u = torch.eye(gs, device=cuda).expand(3, gs, gs)
    else:
        wide = torch.triu(torch.rand(gs, 2 * gs, generator=g, device=cuda), 1) * 0.1
        wide[:, :gs] += torch.eye(gs, device=cuda)
        u = wide[:, :gs].unsqueeze(0).expand(3, gs, gs)
    launches = gptq_group.launches
    got = gptq_group(w, u, qmax)
    want = gptq_group_plain(w, u, qmax)
    torch.cuda.synchronize()
    assert gptq_group.launches == launches + 1
    assert_gptq_bits(got, want)
    if identity and qmax == 15:
        k = 3 * gs
        for a, b in zip(als_grid(w.reshape(k, 333), gs), als_grid(w.reshape(k, 333).cpu(), gs)):
            assert torch.equal(a.cpu(), b)


def assert_gptq_bits(got, want) -> None:
    """The group step's four outputs equal bit for bit (the fp32 ones by
    their bits, so a zero's sign counts too)."""
    for a, b, label in zip(got, want, ("codes", "scales", "zeros", "err")):
        assert a.dtype == b.dtype and a.shape == b.shape, label
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), (label, int((a != b).sum()))


def gptq_case(case: str, gs: int, g, cuda):
    """(w, u) of one edge case of the group step (see its test)."""
    def upper(k):
        m = torch.triu(torch.rand(k, k, generator=g, device=cuda), 1) * 0.1
        return m + torch.diag(0.5 + torch.rand(k, generator=g, device=cuda))

    n = {"ragged-1": 1, "ragged-7": 7, "ragged-37": 37, "ragged-1000": 1000}.get(case, 200)
    groups = 1 if case == "whole-u" else 3
    w = 0.02 * torch.randn(groups, gs, n, generator=g, device=cuda)
    if case == "whole-u":
        # A diagonal block of a whole U, as gptq_quantize passes it: rows 4 gs
        # apart, the block at an offset.
        full = upper(4 * gs)
        u = full[gs:2 * gs, gs:2 * gs].unsqueeze(0)
        assert u.stride(1) == 4 * gs
    elif case == "own-blocks":
        u = torch.stack([upper(gs) for _ in range(groups)])
    elif case == "als":
        u = torch.eye(gs, device=cuda).expand(groups, gs, gs)
        assert u.stride(0) == 0
    else:
        u = upper(gs).expand(groups, gs, gs)
    if case == "constant-and-dead":
        w[0, :, :40] = 0.37       # wmax = wmin: the 1e-8 scale
        w[1, :, 40:80] = -0.0041  # constant and negative
        w[2, ::3] = 0.0           # dead rows (zeroed inputs) among live ones
        w[1, 5] = 0.0
    if case == "special-values":
        # Columns of tiny, subnormal, huge (a scale past 2^30) and mixed
        # magnitudes: quotients near the ends of fp32's range.
        w[:, :, :20] *= 1e-28
        w[:, :, 20:40] *= 1e-38
        w[:, :, 40:60] *= 1e27
        w[:, ::2, 60:80] *= 1e-25
        w[:, 1::2, 60:80] *= 1e15
    return w, u


GPTQ_CASES = ["ragged-1", "ragged-7", "ragged-37", "ragged-1000", "whole-u", "own-blocks", "als",
              "constant-and-dead", "special-values"]


@pytest.mark.gpu
@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("case", GPTQ_CASES)
def test_gptq_group_kernel_edge_cases(cuda, gs, case):
    """The group step's kernel against its plain version on the card, bit
    for bit, at its edges: N not a multiple of a block's 32 columns or of a
    warp's 8 (1, 7, 37, 1000); a diagonal block of a whole U (u_row_stride
    4 gs, as gptq_quantize passes it); G = 3 with blocks of their own and
    with one block repeated (group stride 0, the ALS grid); constant groups
    (wmax = wmin) and zeroed rows; and w of tiny, subnormal and huge
    magnitudes."""
    from diffusionkit_tpu_torch.ops.gptq import gptq_group, gptq_group_plain

    g = torch.Generator(device=cuda).manual_seed(gs + GPTQ_CASES.index(case))
    for qmax in (15, 255):
        w, u = gptq_case(case, gs, g, cuda)
        launches = gptq_group.launches
        got = gptq_group(w, u, qmax)
        torch.cuda.synchronize()
        assert gptq_group.launches == launches + 1
        assert_gptq_bits(got, gptq_group_plain(w, u, qmax))


@pytest.mark.gpu
@pytest.mark.parametrize("gs", [32, 64, 128])
def test_gptq_quantize_on_card_is_plain_gptq(cuda, gs):
    """A whole GPTQ on the card (H from correlated rows, dead inputs among
    them) with the kernel as its group step equals the same GPTQ with the
    plain version as its group step, bit for bit, with one launch a group."""
    from diffusionkit_tpu_torch.ops import gptq

    g = torch.Generator(device=cuda).manual_seed(gs)
    k, n = 8 * gs, 300
    w = 0.02 * torch.randn(k, n, generator=g, device=cuda)
    x = torch.randn(1024, k, generator=g, device=cuda)
    x += 0.5 * torch.randn(1024, 16, generator=g, device=cuda) @ torch.randn(
        16, k, generator=g, device=cuda)
    x[:, 3] = 0.0
    H = x.t() @ x
    launches = gptq.gptq_group.launches
    got = gptq.gptq_quantize(w, H, 4, gs)
    torch.cuda.synchronize()
    assert gptq.gptq_group.launches == launches + k // gs
    assert_gptq_bits(got, gptq.gptq_quantize(w, H, 4, gs, group_step=gptq.gptq_group_plain))


@pytest.mark.gpu
def test_gptq_group_kernel_raises_on_other_group_sizes(cuda):
    from diffusionkit_tpu_torch.ops.gptq import gptq_group

    w = torch.zeros(1, 16, 128, device=cuda)
    with pytest.raises(ValueError):
        gptq_group(w, torch.eye(16, device=cuda)[None], 15)
