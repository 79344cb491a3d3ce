"""The port's CUDA kernels against their plain torch versions.

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch. The ``gpu``-marked tests build the kernels
with nvcc and need a CUDA device; elsewhere they skip. On the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest configures JAX.) Inputs come from a
seeded ``torch.Generator``; the reference is the plain version run on fp32
upcasts of the same bf16 inputs.
"""

import pytest
import torch

from diffusionkit_tpu_torch.ops import kernels
from diffusionkit_tpu_torch.ops.attention import sdpa, xla_sdpa
from diffusionkit_tpu_torch.ops.flash_attention import (
    flash_attention_bshd,
    flash_attention_bshd_plain,
)
from diffusionkit_tpu_torch.ops.fused_quant import mod_ln, mod_ln_plain

torch.set_num_threads(1)

# Main-path shapes of SD3-medium at 512² with CFG (batch 2): AdaLN sites on
# the image (1024 tokens) and text (154 tokens) streams, the joint attention
# (1024 + 154 tokens, 24 heads of 64) and the VAE mid-block (64x64 positions,
# one head of 512). Plus small ragged shapes.
MOD_LN_SHAPES = [(2, 1024, 1536), (2, 154, 1536), (1, 37, 256)]
FLASH_SHAPES = [(2, 1178, 24, 64), (1, 4096, 1, 512), (1, 77, 3, 64), (2, 300, 1, 512)]


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


def test_cpu_tensors_take_the_plain_versions():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 5, 128, generator=g)
    m = torch.randn(1, 1, 128, generator=g)
    q, k, v = (torch.randn(1, 1100, 1, 64, generator=g) for _ in range(3))
    counts = (mod_ln.launches, flash_attention_bshd.launches)
    assert torch.equal(mod_ln(x, m, m), mod_ln_plain(x, m, m))
    assert torch.equal(flash_attention_bshd(q, k, v, 0.125), flash_attention_bshd_plain(q, k, v, 0.125))
    # Above the flash threshold, but on the CPU 'auto' keeps the reference path.
    assert torch.equal(sdpa(q, k, v, 0.125), xla_sdpa(q, k, v, 0.125))
    assert (mod_ln.launches, flash_attention_bshd.launches) == counts


def test_kernel_library_is_keyed_by_source_hash():
    path = kernels.library_path()
    assert path.parent == kernels.BUILD_DIR
    assert kernels.source_hash() in path.name
    assert {p.name for p in kernels.CSRC.glob("*.cu")} >= {"mod_ln.cu", "flash_attention.cu"}


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


@pytest.mark.gpu
def test_flash_kernel_reads_strided_heads_in_place(cuda):
    """q/k/v as head slices of one packed (B, S, 3H, D) projection, as a
    fused qkv would give them: the kernel reads the strides directly."""
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(2, 333, 3 * 4, 64, generator=g, device=cuda).bfloat16()
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:]
    assert not q.is_contiguous()
    got = flash_attention_bshd(q, k, v, 0.125)
    want = flash_attention_bshd(q.contiguous(), k.contiguous(), v.contiguous(), 0.125)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernel_wrappers_raise_on_unsupported_input(cuda):
    q = torch.zeros(1, 8, 2, 128, device=cuda, dtype=torch.bfloat16)
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
    sdpa(short_q, short_q, short_q, 0.125)
    assert flash_attention_bshd.launches == launches
    sdpa(long_q, long_q, long_q, 0.125)
    assert flash_attention_bshd.launches == launches + 1
    # fp32 on the card is the kernel's to take: it raises until the kernel
    # supports fp32, rather than quietly materialising the scores.
    with pytest.raises(TypeError):
        sdpa(long_q.float(), long_q.float(), long_q.float(), 0.125)
    assert_flash_close(
        sdpa(short_q, short_q, short_q, 0.125, impl="flash"),
        xla_sdpa(short_q.float(), short_q.float(), short_q.float(), 0.125),
    )
