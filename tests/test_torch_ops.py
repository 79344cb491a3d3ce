"""Ops of the PyTorch port held against the JAX package on the CPU.

Inputs are drawn with numpy from a fixed seed and fed to both sides. Where
the JAX function reaches a Pallas kernel it runs in interpret mode, as the
JAX package's own tests run it. The CUDA kernels themselves are checked
against their plain versions by the ``gpu``-marked tests at the end, which
skip on a machine without a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffusionkit_tpu.ops import common as jcommon
from diffusionkit_tpu.ops import norms as jnorms
from diffusionkit_tpu.ops.attention import xla_sdpa as jax_xla_sdpa
from diffusionkit_tpu.ops.flash_attention import flash_attention_bshd as jax_flash_bshd
from diffusionkit_tpu.ops.fused_quant import mod_ln as jax_mod_ln
from diffusionkit_tpu.sampler import FluxSampler as JaxFluxSampler
from diffusionkit_tpu.sampler import ModelSamplingDiscreteFlow as JaxSD3Sampler
from diffusionkit_tpu_torch.ops import common, norms
from diffusionkit_tpu_torch.ops.attention import sdpa, xla_sdpa
from diffusionkit_tpu_torch.ops.flash_attention import (
    flash_attention_bshd,
    flash_attention_bshd_plain,
)
from diffusionkit_tpu_torch.ops.fused_quant import mod_ln, mod_ln_plain
from diffusionkit_tpu_torch.sampler import FluxSampler, ModelSamplingDiscreteFlow

# The suite runs under several pytest-xdist workers; one intra-op thread each.
torch.set_num_threads(1)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bf16 values (8 significant bits) at the magnitude of x."""
    mag = np.maximum(np.abs(x), 2.0**-126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def assert_within_bf16_ulps(got: np.ndarray, want: np.ndarray, n: int, atol: float = 0.0) -> None:
    """|got - want| <= n bf16 ulps at the larger of the two magnitudes,
    plus ``atol`` for outputs that come from cancelling larger terms."""
    diff = np.abs(got - want)
    ulp = bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(diff <= n * ulp + atol), ((diff - atol) / ulp).max()


def _pair(a: np.ndarray, dtype):
    """The same values as a torch tensor and a JAX array of one dtype
    (both round fp32 -> bf16 to nearest even, so the bits agree)."""
    t = torch.from_numpy(a).to(dtype)
    j = jnp.asarray(a, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    return t, j


# ---------------------------------------------------------------------------
# Kernel A's plain version against the Pallas mod_ln (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mod_ln_plain_matches_pallas_interpret(dtype):
    rs = np.random.RandomState(0)
    b, s, h = 2, 37, 256  # ragged S exercises the Pallas row padding
    x, jx = _pair((rs.randn(b, s, h) * 2 + 0.5).astype(np.float32), dtype)
    sh, jsh = _pair(rs.randn(b, 1, h).astype(np.float32), dtype)
    sc, jsc = _pair((rs.randn(b, 1, h) * 0.5).astype(np.float32), dtype)
    want = _np(jax_mod_ln(jx, jsh, jsc, eps=1e-6, interpret=True))
    got = mod_ln_plain(x, sh, sc, eps=1e-6)
    assert got.dtype == dtype and got.shape == (b, s, h)
    # The CPU wrapper takes the plain path: same result, no launch counted.
    launches = mod_ln.launches
    np.testing.assert_array_equal(_np(mod_ln(x, sh, sc, eps=1e-6)), _np(got))
    assert mod_ln.launches == launches
    got = _np(got)
    if dtype == torch.float32:
        # fp32 statistics in both; only the reduction order differs.
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        # Both compute in fp32 and round once: a differently ordered fp32
        # sum can flip that rounding by at most one bf16 ulp. Outputs near
        # zero cancel O(1) terms, whose fp32 rounding (~1e-6) can exceed
        # the result's own ulp: an absolute 1e-5 covers them.
        assert_within_bf16_ulps(got, want, 1, atol=1e-5)


def test_mod_ln_rounds_once_unlike_modulated_layer_norm():
    """mod_ln rounds after modulating; the non-fused modulated_layer_norm
    rounds the normalised tensor first (the reference's two branches)."""
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(1, 64, 128).astype(np.float32)).bfloat16()
    sh = torch.from_numpy(rs.randn(1, 1, 128).astype(np.float32)).bfloat16()
    sc = torch.from_numpy(rs.randn(1, 1, 128).astype(np.float32)).bfloat16()
    fused = _np(mod_ln_plain(x, sh, sc))
    exact = _np(mod_ln_plain(x.float(), sh.float(), sc.float()))
    split = _np(norms.modulated_layer_norm(x, sh, sc))
    assert_within_bf16_ulps(fused, exact, 1)
    assert not np.array_equal(fused, split)


def test_mod_ln_rejects_non_cpu_non_cuda_device():
    x = torch.empty(1, 4, 128, device="meta")
    m = torch.empty(1, 1, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mod_ln(x, m, m)


# ---------------------------------------------------------------------------
# Kernel B's plain version against the Pallas flash_attention_bshd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "shape",
    [
        (1, 200, 3, 64),  # odd head count, ragged sequence (SD3 head dim)
        (1, 300, 1, 512),  # one wide head (the VAE mid-block)
    ],
)
def test_flash_plain_matches_pallas_interpret(shape):
    rs = np.random.RandomState(2)
    q, k, v = (rs.randn(*shape).astype(np.float32) for _ in range(3))
    scale = shape[-1] ** -0.5
    want = _np(jax_flash_bshd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              scale=scale, interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = flash_attention_bshd_plain(tq, tk, tv, scale)
    assert got.shape == shape and got.is_contiguous()
    # fp32 throughout; the Pallas kernel sums in tiles, the plain version
    # in one pass.
    np.testing.assert_allclose(_np(got), want, atol=2e-5, rtol=1e-4)
    launches = flash_attention_bshd.launches
    np.testing.assert_array_equal(_np(flash_attention_bshd(tq, tk, tv, scale)), _np(got))
    assert flash_attention_bshd.launches == launches


def test_flash_plain_bf16_rounds_p_before_pv():
    """In bf16 the plain version rounds the unnormalised P to bf16 before
    P.V, like the kernels: its result equals that recipe computed by hand,
    and stays within a few bf16 ulps of the fp32 result."""
    rs = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rs.randn(1, 50, 2, 64).astype(np.float32)).bfloat16()
               for _ in range(3))
    scale = 0.125
    got = flash_attention_bshd_plain(q, k, v, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    p = torch.exp((s - s.amax(-1, keepdim=True)) * scale)
    pv = torch.einsum("bhqk,bkhd->bhqd", p.bfloat16().float(), v.float())
    want = (pv / p.sum(-1, keepdim=True)).permute(0, 2, 1, 3).bfloat16()
    assert torch.equal(got, want)
    exact = _np(flash_attention_bshd_plain(q.float(), k.float(), v.float(), scale))
    assert np.abs(_np(got) - exact).max() < 0.02


def test_flash_plain_rejects_nonpositive_scale():
    q = torch.zeros(1, 4, 1, 64)
    with pytest.raises(ValueError, match="scale > 0"):
        flash_attention_bshd_plain(q, q, q, 0.0)


# ---------------------------------------------------------------------------
# sdpa dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", [None, "xla", "flash"])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_sdpa_matches_jax_xla_sdpa(impl, layout):
    rs = np.random.RandomState(4)
    q, k, v = (rs.randn(2, 40, 3, 64).astype(np.float32) for _ in range(3))
    if layout == "bhsd":
        # Only bshd is ported (every caller passes it); bhsd must not be
        # silently read as bshd.
        tq = torch.from_numpy(q.transpose(0, 2, 1, 3).copy())
        with pytest.raises(ValueError, match="bshd"):
            sdpa(tq, tq, tq, scale=0.125, impl=impl, layout=layout)
        with pytest.raises(ValueError, match="bshd"):
            xla_sdpa(tq, tq, tq, 0.125, layout=layout)
        return
    want = _np(jax_xla_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.125, layout=layout))
    got = sdpa(*map(torch.from_numpy, (q, k, v)), scale=0.125, impl=impl, layout=layout)
    np.testing.assert_allclose(_np(got), want, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(
        _np(xla_sdpa(*map(torch.from_numpy, (q, k, v)), 0.125, layout=layout)),
        want, atol=2e-5, rtol=1e-4,
    )


# ---------------------------------------------------------------------------
# common.py and norms.py
# ---------------------------------------------------------------------------


def _torch_linear(kernel: np.ndarray, bias: np.ndarray, dtype) -> torch.nn.Linear:
    lin = torch.nn.Linear(*kernel.shape, dtype=dtype)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(kernel.T.copy()))
        lin.bias.copy_(torch.from_numpy(bias))
    return lin


@pytest.mark.parametrize("act", [None, "gelu"])
def test_linear_matches_jax(act):
    rs = np.random.RandomState(5)
    x = rs.randn(3, 7, 32).astype(np.float32)
    kernel = (rs.randn(32, 48) / 6).astype(np.float32)
    bias = rs.randn(48).astype(np.float32)
    jp = {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}
    want = _np(jcommon.linear(jp, jnp.asarray(x), act=act))
    got = common.linear(_torch_linear(kernel, bias, torch.float32), torch.from_numpy(x), act=act)
    np.testing.assert_allclose(_np(got), want, atol=1e-5, rtol=1e-5)

    # bf16 activations against fp32 weights: the product runs in fp32 and
    # is rounded to bf16 BEFORE the GELU, on both sides. Without the GELU
    # only the summation order differs (one rounding flip, one ulp). JAX
    # evaluates a bf16 GELU as a chain of separately rounded bf16 ops (up
    # to 3 ulps from the exact value measured on 1e5 samples), torch in fp32
    # with one rounding; near-zero GELU outputs get an absolute 1e-3.
    xb, jxb = _pair(x, torch.bfloat16)
    want = _np(jcommon.linear(jp, jxb, act=act))
    got = common.linear(_torch_linear(kernel, bias, torch.float32), xb, act=act)
    assert got.dtype == torch.bfloat16
    if act is None:
        assert_within_bf16_ulps(_np(got), want, 1)
    else:
        assert_within_bf16_ulps(_np(got), want, 4, atol=1e-3)


def test_linear_rounds_before_gelu():
    rs = np.random.RandomState(6)
    lin = _torch_linear((rs.randn(16, 16) / 4).astype(np.float32),
                        rs.randn(16).astype(np.float32), torch.bfloat16)
    x = torch.from_numpy(rs.randn(4, 16).astype(np.float32)).bfloat16()
    y = common.linear(lin, x)
    assert torch.equal(common.linear(lin, x, act="gelu"), torch.nn.functional.gelu(y))


def test_ffn_gelu_matches_jax():
    rs = np.random.RandomState(7)
    x = rs.randn(2, 5, 32).astype(np.float32)
    k1, b1 = (rs.randn(32, 128) / 6).astype(np.float32), rs.randn(128).astype(np.float32)
    k2, b2 = (rs.randn(128, 32) / 11).astype(np.float32), rs.randn(32).astype(np.float32)
    jp = {"fc1": {"kernel": jnp.asarray(k1), "bias": jnp.asarray(b1)},
          "fc2": {"kernel": jnp.asarray(k2), "bias": jnp.asarray(b2)}}
    want = _np(jcommon.ffn_gelu(jp, jnp.asarray(x)))
    got = common.ffn_gelu(_torch_linear(k1, b1, torch.float32),
                          _torch_linear(k2, b2, torch.float32), torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), want, atol=1e-5, rtol=1e-5)


def test_mlp_silu_matches_jax():
    rs = np.random.RandomState(8)
    x = rs.randn(2, 24).astype(np.float32)
    k1, b1 = (rs.randn(24, 32) / 5).astype(np.float32), rs.randn(32).astype(np.float32)
    k2, b2 = (rs.randn(32, 32) / 6).astype(np.float32), rs.randn(32).astype(np.float32)
    jp = {"fc1": {"kernel": jnp.asarray(k1), "bias": jnp.asarray(b1)},
          "fc2": {"kernel": jnp.asarray(k2), "bias": jnp.asarray(b2)}}
    mlp = common.MLPSiLU(24, 32)
    mlp.fc1, mlp.fc2 = _torch_linear(k1, b1, torch.float32), _torch_linear(k2, b2, torch.float32)
    np.testing.assert_allclose(
        _np(mlp(torch.from_numpy(x))), _np(jcommon.mlp_silu(jp, jnp.asarray(x))),
        atol=1e-5, rtol=1e-5,
    )


def test_timestep_embedding_matches_jax():
    t = np.array([0.0, 1.0, 250.5, 999.0], np.float32)
    want = _np(jcommon.timestep_embedding(jnp.asarray(t), 256))
    got = _np(common.timestep_embedding(torch.from_numpy(t), 256))
    assert got.shape == (4, 256)
    # fp32 on both sides; an argument near 1000 rad amplifies a one-ulp
    # difference in the frequency table to ~1e-4 in cos/sin.
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_patchify_and_unpatchify_match_jax():
    rs = np.random.RandomState(9)
    x = rs.randn(2, 8, 6, 16).astype(np.float32)
    np.testing.assert_array_equal(
        _np(common.patchify(torch.from_numpy(x), 2)), _np(jcommon.patchify(jnp.asarray(x), 2))
    )
    y = rs.randn(2, 12, 64).astype(np.float32)
    np.testing.assert_array_equal(
        _np(common.unpatchify_sd3(torch.from_numpy(y), (8, 6), 2, 16)),
        _np(jcommon.unpatchify_sd3(jnp.asarray(y), (8, 6), 2, 16)),
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norms_match_jax(dtype):
    rs = np.random.RandomState(10)
    x, jx = _pair((rs.randn(2, 9, 64) * 3 + 1).astype(np.float32), dtype)
    w, jw = _pair(rs.randn(64).astype(np.float32), dtype)
    b, jb = _pair(rs.randn(64).astype(np.float32), dtype)
    sh, jsh = _pair(rs.randn(2, 1, 64).astype(np.float32), dtype)
    sc, jsc = _pair(rs.randn(2, 1, 64).astype(np.float32), dtype)
    pairs = [
        (norms.layer_norm(x), jnorms.layer_norm(jx)),
        (norms.layer_norm_affine(x, w, b), jnorms.layer_norm_affine(jx, jw, jb)),
        (norms.modulated_layer_norm(x, sh, sc), jnorms.modulated_layer_norm(jx, jsh, jsc)),
    ]
    for got, want in pairs:
        assert got.dtype == dtype
        got, want = _np(got), _np(want)
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        else:
            # One rounding of the norm plus one of the affine/modulation in
            # bf16: each can land one ulp apart after an fp32 tie.
            assert_within_bf16_ulps(got, want, 2)


def test_group_norm_matches_jax():
    rs = np.random.RandomState(11)
    x = (rs.randn(2, 5, 6, 16) * 2 + 0.3).astype(np.float32)  # NHWC
    w = rs.randn(16).astype(np.float32)
    b = rs.randn(16).astype(np.float32)
    want = _np(jnorms.group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 4))
    got = norms.group_norm(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w),
                           torch.from_numpy(b), 4)
    np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)), want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Sampler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps", [2, 4, 50])
def test_sigma_grids_equal_jax(steps):
    np.testing.assert_array_equal(
        ModelSamplingDiscreteFlow(shift=3.0).get_sigmas(steps),
        JaxSD3Sampler(shift=3.0).get_sigmas(steps),
    )
    np.testing.assert_array_equal(
        FluxSampler(shift=1.0).get_sigmas(steps), JaxFluxSampler(shift=1.0).get_sigmas(steps)
    )


def test_sd3_sigma_endpoint_quirk():
    s = ModelSamplingDiscreteFlow(shift=3.0)
    sigmas = s.get_sigmas(50)
    assert len(sigmas) == 51 and sigmas[-1] == 0.0
    # The grid ends at timestep(sigma(1)), so the last nonzero sigma is the
    # shift map applied twice.
    s1 = 3.0 * 0.001 / (1 + 2 * 0.001)
    np.testing.assert_allclose(sigmas[-2], 3.0 * s1 / (1 + 2 * s1), rtol=1e-5)


# ---------------------------------------------------------------------------
# Host code copied across: FLOP accounting and image metrics
# ---------------------------------------------------------------------------


def test_step_flops_match_jax():
    from diffusionkit_tpu.config import SD3_2b as JaxSD3
    from diffusionkit_tpu.flops import mmdit_step_flops as jax_flops
    from diffusionkit_tpu_torch.config import SD3_2b
    from diffusionkit_tpu_torch.flops import device_peak_flops, mmdit_step_flops

    for cfg_on in (True, False):
        assert mmdit_step_flops(SD3_2b, (64, 64), 154, cfg=cfg_on) == jax_flops(
            JaxSD3, (64, 64), 154, cfg=cfg_on)
    assert device_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert device_peak_flops("cpu") == 0.0


def test_psnr_matches_jax():
    from diffusionkit_tpu.utils import compute_psnr as jax_psnr
    from diffusionkit_tpu_torch.utils import compute_psnr, device_memory_stats

    rs = np.random.RandomState(12)
    a = rs.rand(8, 8, 3)
    b = a + rs.randn(8, 8, 3) * 0.01
    assert compute_psnr(a, b) == jax_psnr(a, b)
    assert compute_psnr(a, a) == float("inf")
    assert device_memory_stats("cpu") == {"peak_memory": None, "active_memory": None}
