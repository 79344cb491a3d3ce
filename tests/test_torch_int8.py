"""The int8 weight-only mode and the "-mixed" overrides of the PyTorch port
against the JAX package.

Host quantizing is compared bit for bit; kernel #13's plain version
(``int8_matmul_plain``) and ``int8_linear`` against the reference's Pallas
``int8_matmul`` / ``int8_linear`` in interpret mode; quantize-at-load with
``MIXED_OVERRIDES`` against ``quantize_tree``; a tiny SD3 int8 MMDiT and
``DiffusionPipeline(quantize_mmdit="int8")`` against the JAX package, whose
CPU backend computes an int8 linear by dequantising and one fp32 dot (its
kernel dispatch gates on the TPU backend): the same weights, the product
rounded once fewer, so fp32 agreement.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionkit_tpu.config import FLUX_SCHNELL as JAX_FLUX
from diffusionkit_tpu.config import SD3_2b as JAX_SD3
from diffusionkit_tpu.models import apply_mmdit, init_mmdit_params
from diffusionkit_tpu.ops import quantized as jq
from diffusionkit_tpu.ops import w4a8_matmul as jw
from diffusionkit_tpu.ops.int4_matmul import int8_linear as jax_int8_linear
from diffusionkit_tpu.ops.int4_matmul import int8_matmul as jax_int8_matmul
from diffusionkit_tpu_torch import config as tcfg
from diffusionkit_tpu_torch.convert import mmdit_from_jax
from diffusionkit_tpu_torch.models import init_mmdit
from diffusionkit_tpu_torch.ops import int4_matmul as ti
from diffusionkit_tpu_torch.ops import quantized as tq
from diffusionkit_tpu_torch.ops.common import linear
from diffusionkit_tpu_torch.ops.w8a8 import W8A8Linear
from diffusionkit_tpu_torch.pipeline import DiffusionPipeline, FluxPipeline

from test_torch_models import randomize, torch_config

torch.set_num_threads(1)

K, N = 512, 256
# int8_matmul_plain against the Pallas kernel: fp32, the same products in
# another order; bf16, both round the dequantised weight to bf16, sum in
# fp32 and round once: one bf16 ulp (2^-8 relative) of the output apart.
TOLS = {torch.float32: dict(atol=1e-5, rtol=1e-5), torch.bfloat16: dict(atol=2e-2, rtol=2**-7)}


@pytest.fixture(autouse=True)
def _minmax_grid(monkeypatch):
    # The reference's quantize_tree takes the min/max int4 grid with this off,
    # and the pipelines take it (not GPTQ) with DIFFUSIONKIT_TPU_GPTQ=0.
    monkeypatch.setenv("DIFFUSIONKIT_TPU_QUANT_REFINE", "0")
    monkeypatch.setenv("DIFFUSIONKIT_TPU_GPTQ", "0")


def q8_weights(group, seed=0, k=K, n=N):
    w = np.random.RandomState(seed).randn(k, n).astype(np.float32) / np.sqrt(k)
    return {key: np.asarray(v) for key, v in jq.quantize_kernel_host(w, 8, group).items()}


@pytest.mark.parametrize("group", [32, 64])
def test_quantize_kernel_host_int8_is_bit_identical(group):
    """The min/max int8 grid: ``q8`` uint8 over [0, 255] (values above 127
    included), scales and zeros, bit for bit on the host; and the same
    grid computed on the layer's device by ``quantize_linear``."""
    w = np.random.RandomState(1).randn(K, N).astype(np.float32)
    want = jq.quantize_kernel_host(w, 8, group)
    got = tq.quantize_kernel_host(w, group, bits=8)
    assert set(got) == {"q8", "scales", "zeros"} and got["q8"].dtype == np.uint8
    assert got["q8"].max() == 255 and got["q8"].min() == 0
    for key in got:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    lin = torch.nn.Linear(K, N)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T.copy()))
    layer = tq.quantize_linear(lin, group, bits=8)
    assert layer.bits == 8 and layer.group_size == group
    np.testing.assert_array_equal(layer.q8.numpy(), got["q8"])
    np.testing.assert_array_equal(layer.scales.numpy(), got["scales"])
    np.testing.assert_array_equal(layer.zeros.numpy(), got["zeros"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [32, 64])
def test_int8_matmul_plain_matches_pallas(group, dtype):
    p = q8_weights(group)
    x = np.random.RandomState(2).randn(70, K).astype(np.float32)  # ragged M
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_int8_matmul(jnp.asarray(x, jdt), *map(jnp.asarray, (p["q8"], p["scales"],
                                                                   p["zeros"])),
                           bm=64, bk=256, bn=128, interpret=True)
    xt = torch.from_numpy(x).to(dtype)
    args = (torch.from_numpy(p["q8"]), torch.from_numpy(p["scales"]), torch.from_numpy(p["zeros"]))
    launches = ti.int8_matmul.launches
    got = ti.int8_matmul(xt, *args)
    assert ti.int8_matmul.launches == launches  # a CPU tensor takes the plain version
    assert torch.equal(got, ti.int8_matmul_plain(xt, *args))
    assert got.dtype == dtype and got.shape == (70, N)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_linear_bias_gelu_matches_jax(dtype):
    p = q8_weights(32, seed=3)
    rs = np.random.RandomState(4)
    p["bias"] = rs.randn(N).astype(np.float32)
    x = rs.randn(2, 35, K).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jp["bias"] = jp["bias"].astype(jdt)
    want = jax_int8_linear(jp, jnp.asarray(x, jdt), bm=32, act="gelu", interpret=True)
    layer = tq.QuantizedLinear.from_host(p, dtype, device="cpu")
    got = linear(layer, torch.from_numpy(x).to(dtype), act="gelu")
    assert got.shape == (2, 35, N) and got.dtype == dtype
    tol = TOLS[dtype] if dtype == torch.float32 else dict(atol=3e-2, rtol=2**-6)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_random_int8_linear_is_seeded_and_bounded():
    def make():
        layer = tq.QuantizedLinear(256, 128, 64, dtype=torch.float32, bits=8)
        return tq.random_quantized_linear_(layer, torch.Generator().manual_seed(0), scale=0.02)

    a, b = make(), make()
    assert torch.equal(a.q8, b.q8) and len(torch.unique(a.q8)) == 256
    w = ti.dequantize_int8(a.q8, a.scales, a.zeros, torch.float32)
    assert w.min() >= -0.02 and w.max() <= 0.02 + 1e-7
    with pytest.raises(ValueError, match="wscale"):
        tq.QuantizedLinear(256, 128, 64, bits=8, wscale=True)


# -- quantize-at-load: int8 and the -mixed overrides --------------------------


def tiny_flux():
    return dataclasses.replace(JAX_FLUX, depth_multimodal=1, depth_unified=1, num_heads=2,
                               hidden_size_override=256, mlp_ratio=2,
                               token_level_text_embed_dim=256, pooled_text_embed_dim=32,
                               dtype=jnp.float32)


def kinds(model):
    """Each linear's form: 4 / 8 (packed), "w4a8", "w8a8" or None (float)."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, tq.QuantizedLinear):
            out[name] = "w4a8" if m.wscale is not None else m.bits
        elif isinstance(m, W8A8Linear):
            out[name] = "w8a8"
        elif isinstance(m, torch.nn.Linear):
            out[name] = None
    return out


@pytest.mark.parametrize("mode", ["int8", "int4-mixed", "w4a8-mixed"])
def test_quantize_at_load_modes_match_quantize_tree(mode):
    """``FluxPipeline(quantize_mmdit=mode)`` packs an assigned float MMDiT
    as the reference's quantize-at-load does for that mode
    (``quantize_tree`` with its bits, ``MIXED_OVERRIDES`` for "-mixed",
    group 32, then ``add_wscale_tree`` for w4a8): every linear's form and
    every leaf, bit for bit. Under the overrides the AdaLN ``ada`` is int8
    weight-only, the final layer and the embedders float, the rest int4."""
    jcfg = tiny_flux()
    params = randomize(init_mmdit_params(jax.random.PRNGKey(0), jcfg), seed=5)
    base, mixed = mode.split("-")[0], mode.endswith("-mixed")
    jax_q = jq.quantize_tree(params, bits=8 if base == "int8" else 4, group_size=32,
                             overrides=jq.MIXED_OVERRIDES if mixed else None)
    if base == "w4a8":
        jax_q = jw.add_wscale_tree(jax_q)
    pipe = FluxPipeline(load=False, low_memory_mode=False,
                        device="cpu", quantize_mmdit=mode, quantize_group_size=32)
    pipe.mmdit = mmdit_from_jax(params, torch_config(jcfg, tcfg.MMDiTConfig), device="cpu")
    want = mmdit_from_jax(jax_q, torch_config(jcfg, tcfg.MMDiTConfig), device="cpu")
    assert kinds(pipe.mmdit) == kinds(want)
    form = kinds(pipe.mmdit)
    if mixed:
        bulk = "w4a8" if base == "w4a8" else 4
        assert form["uni_blocks.0.ada"] == form["mm_blocks.0.img.ada"] == 8
        assert form["uni_blocks.0.fc1"] == form["mm_blocks.0.txt.q"] == bulk
        assert form["context_embedder"] is None and form["final_layer.ada"] is None
    else:
        assert form["context_embedder"] == form["uni_blocks.0.ada"] == 8
        assert form["x_embedder"] is None  # 64 inputs < MIN_DIM
    got, want = pipe.mmdit.state_dict(), want.state_dict()
    assert set(got) == set(want)
    for key in got:
        assert torch.equal(got[key], want[key]), key


def test_init_mmdit_builds_int8_and_w8a8_blocks():
    cfg = torch_config(dataclasses.replace(
        JAX_FLUX, depth_multimodal=1, depth_unified=1, num_heads=2, hidden_size_override=128,
        rope_axes_dim=(8, 28, 28), dtype=jnp.float32), tcfg.MMDiTConfig)
    blocks = {f"{b}.{p}" for b in ("mm_blocks.0.img", "mm_blocks.0.txt", "uni_blocks.0")
              for p in ("q", "k", "v", "ada", "o", "fc1", "fc2")}
    for bits, want in ((8, 8), ("w8a8", "w8a8")):
        model = init_mmdit(cfg, torch.Generator().manual_seed(0), device="cpu", quantize_bits=bits)
        form = kinds(model)
        assert {n for n, f in form.items() if f is not None} == blocks
        assert {form[n] for n in blocks} == {want}
    with pytest.raises(ValueError):
        init_mmdit(cfg, torch.Generator(), device="cpu", quantize_bits=2)


# -- the tiny SD3 int8 model and pipeline ----------------------------------------


def tiny_sd3(pooled=32):
    return dataclasses.replace(JAX_SD3, depth_multimodal=2, num_heads=2,
                               hidden_size_override=256, max_latent_resolution=16,
                               pooled_text_embed_dim=pooled, dtype=jnp.float32)


def test_sd3_int8_mmdit_matches_jax(monkeypatch):
    """A tiny SD3 MMDiT quantized to int8 at load (group 32) against the JAX
    ``apply_mmdit`` on ``quantize_tree(bits=8)`` of the same weights: the
    same packed leaves, 30 int8 products a forward (25 block linears, the
    context embedder, the y/t embedders' 256-wide linears and the final
    ``ada``), and fp32 agreement (the reference's CPU dot rounds once
    where the kernel path rounds the product before the bias: the model
    test's 2e-4 / 1e-3)."""
    monkeypatch.setenv("DIFFUSIONKIT_TPU_FUSED_QUANT", "interpret")
    jcfg = tiny_sd3()
    params = randomize(init_mmdit_params(jax.random.PRNGKey(0), jcfg), seed=6)
    jax_q = jq.quantize_tree(params, bits=8, group_size=32)
    pipe = DiffusionPipeline(load=False, low_memory_mode=False,
                             device="cpu", quantize_mmdit="int8", use_t5=False)
    pipe.mmdit = mmdit_from_jax(params, torch_config(jcfg, tcfg.MMDiTConfig), device="cpu")
    calls = []
    plain = ti.int8_matmul_plain
    monkeypatch.setattr(ti, "int8_matmul_plain", lambda *a: calls.append(1) or plain(*a))
    rs = np.random.RandomState(7)
    args = [rs.randn(2, 8, 8, 16).astype(np.float32), rs.randn(2, 7, 4096).astype(np.float32),
            rs.randn(2, 32).astype(np.float32), np.array([500.0, 500.0], np.float32)]
    want = np.asarray(apply_mmdit(jax_q, jcfg, *map(jnp.asarray, args)))
    with torch.no_grad():
        got = pipe.mmdit(*map(torch.from_numpy, args)).numpy()
    assert len(calls) == 30
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max(), rtol=1e-3)


def test_sd3_int8_pipeline_matches_jax(monkeypatch):
    """``DiffusionPipeline(quantize_mmdit="int8")`` on the tiny SD3
    pipeline against the JAX pipeline on the reference's int8 quantized
    tree: latents after two CFG-5 Euler steps within the float pipeline
    test's 1e-3, and a whole ``generate_image``."""
    from test_torch_pipeline import NEGATIVE, PROMPT, SEED, build_pipelines

    monkeypatch.setenv("DIFFUSIONKIT_TPU_FUSED_QUANT", "interpret")
    jp, tp = build_pipelines()
    jcfg = tiny_sd3(pooled=16)
    float_params = randomize(init_mmdit_params(jax.random.PRNGKey(0), jcfg), seed=8)
    jp.mmdit_params = jq.quantize_tree(float_params, bits=8, group_size=32)
    jp.mmdit_config = jcfg
    qp = DiffusionPipeline(load=False, low_memory_mode=False,
                           shift=3.0, use_t5=False, a16=False, device="cpu",
                           quantize_mmdit="int8")
    for name in ("clip_l", "clip_g", "decoder", "tokenizer_l", "tokenizer_g"):
        setattr(qp, name, getattr(tp, name))
    qp.mmdit = mmdit_from_jax(float_params, torch_config(jcfg, tcfg.MMDiTConfig), device="cpu")
    kw = dict(num_steps=2, cfg_weight=5.0, latent_size=(8, 8), seed=SEED)
    jc, jpool = jp.encode_text(PROMPT, 5.0, NEGATIVE)
    tc, tpool = qp.encode_text(PROMPT, 5.0, NEGATIVE)
    jlat, _ = jp.denoise_latents(jc, jpool, **kw)
    tlat, _ = qp.denoise_latents(tc, tpool, **kw)
    assert np.abs(np.asarray(jlat)).max() > 0.5
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), atol=1e-3, rtol=1e-3)
    img, log = qp.generate_image(PROMPT, verbose=False, negative_text=NEGATIVE, **kw)
    assert np.asarray(img).shape == (64, 64, 3) and len(log["denoising"]["iter_time"]) == 2
