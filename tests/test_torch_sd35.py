"""SD3.5-large of the PyTorch port against the JAX package: the fp32-upcast
block segments, their quantized forms, SD3 with T5 and the per-version
tables.

The MMDiTs are tiny SD3.5s (``tests/test_models.py``'s ``TINY_SD35``: three
dual-stream blocks, block 1 upcast to fp32, QK-norm; widened to hidden 256
with 4 heads of 64 where a quantized form needs it). Both sides run on the
same weights: the JAX initialisers build the tree, numpy redraws it, and
``convert.py`` carries it into the port. Inputs come from numpy seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionkit_tpu import model_io
from diffusionkit_tpu.config import MMDiTConfig as JaxMMDiTConfig
from diffusionkit_tpu.models import apply_mmdit, init_mmdit_params
from diffusionkit_tpu.models import mmdit as jax_mmdit
from diffusionkit_tpu.ops import quantized as jq
from diffusionkit_tpu.ops import w4a8_matmul as jw
from diffusionkit_tpu.ops import w8a8 as jw8
from diffusionkit_tpu.scripts import generate_images as cli
from diffusionkit_tpu_torch import config as tcfg
from diffusionkit_tpu_torch.convert import clip_from_jax, mmdit_from_jax, t5_from_jax, vae_decoder_from_jax
from diffusionkit_tpu_torch.models import MMDiT
from diffusionkit_tpu_torch.ops import quantized as tq
from diffusionkit_tpu_torch.ops import w4a8_matmul as tw
from diffusionkit_tpu_torch.ops.w8a8 import W8A8Linear
from diffusionkit_tpu_torch.pipeline import DiffusionPipeline
from diffusionkit_tpu_torch.tokenizer import CLIPTokenizer

from test_pipeline import TinyT5Tokenizer, build_sd3_pipeline
from test_torch_flux import randomize_packed
from test_torch_models import randomize, torch_config
from test_torch_w4a8 import assert_close_up_to_flips, jax_tpu_dispatch  # noqa: F401

torch.set_num_threads(1)

PROMPT, NEGATIVE, SEED = "a photo of a cat", "blurry", 42

# tests/test_models.py's TINY_SD35, and the same at hidden 256 (4 heads of
# 64, SD3.5's head width) where the quantize modes' shape rules need it.
TINY_SD35 = JaxMMDiTConfig(depth_multimodal=3, num_heads=2, hidden_size_override=64,
                           max_latent_resolution=16, use_qk_norm=True,
                           upcast_multimodal_blocks=(1,), dtype=jnp.float32)
WIDE_SD35 = dataclasses.replace(TINY_SD35, num_heads=4, hidden_size_override=256)


def port_config(jcfg, dtype=torch.float32):
    return dataclasses.replace(torch_config(jcfg, tcfg.MMDiTConfig), dtype=dtype)


def in_dtype(tree, dtype):
    """The tree's float leaves in ``dtype`` (a model loaded in that dtype)."""
    return jax.tree.map(
        lambda a: a.astype(dtype) if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a,
        tree)


def with_unit_qk_scales(params):
    for stream in ("img", "txt"):
        for name in ("q_scale", "k_scale"):
            qk = params["mm_blocks"][stream]["qk_norm"]
            qk[name] = qk[name] + 1.0
    return params


def inputs(jcfg, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(2, 8, 8, 16).astype(np.float32),
            rs.randn(2, 7, jcfg.token_level_text_embed_dim).astype(np.float32),
            rs.randn(2, jcfg.pooled_text_embed_dim).astype(np.float32),
            np.array([600.0, 600.0], np.float32)]


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def float_dtypes(module):
    """The dtypes of a module's parameters: weights, biases, QK-norm scales
    (a packed layer's scales, zeros and wscale are fp32 buffers in any
    block)."""
    return {t.dtype for t in module.parameters() if t.is_floating_point()}


def assert_block_1_upcast(model, model_dtype):
    """Block 1 holds every float leaf in fp32, the others the model dtype."""
    for i, block in enumerate(model.mm_blocks):
        assert float_dtypes(block) == {torch.float32 if i == 1 else model_dtype}, i
        assert all(b.dtype == torch.float32 for b in block.buffers() if b.is_floating_point())
    assert float_dtypes(model.mm_final) == {model_dtype}


# -- the per-version tables -----------------------------------------------------


def test_version_tables_are_the_references():
    assert tcfg.T5_MAX_LENGTH == model_io.T5_MAX_LENGTH
    assert tcfg.DEPTH == model_io.DEPTH
    assert tcfg.MAX_LATENT_RESOLUTION == model_io.MAX_LATENT_RESOLUTION
    assert tcfg.QUANTIZED_CKPT == model_io.QUANTIZED_CKPT
    assert tcfg.MMDIT_CONFIG.keys() == model_io.MMDIT_CONFIG.keys()
    for version, jcfg in model_io.MMDIT_CONFIG.items():
        assert tcfg.MMDIT_CONFIG[version] == dataclasses.replace(
            torch_config(jcfg, tcfg.MMDiTConfig), dtype=torch.bfloat16), version
    assert (tcfg.HEIGHT, tcfg.WIDTH, tcfg.SHIFT) == (cli.HEIGHT, cli.WIDTH, cli.SHIFT)
    assert tcfg.DEPTH[tcfg.SD35_LARGE] == tcfg.SD3_8b.depth_multimodal


def test_pipelines_take_the_references_model_versions():
    from diffusionkit_tpu_torch.pipeline import FluxPipeline

    sd3 = DiffusionPipeline(load=False, low_memory_mode=False, device="cpu")
    assert (sd3.model_version, sd3.use_t5, sd3.t5_max_length) == (tcfg.SD3_MEDIUM, True, 512)
    flux = FluxPipeline(load=False, low_memory_mode=False,
                        device="cpu", use_t5=False)  # FLUX forces T5 on, as the reference
    assert (flux.model_version, flux.use_t5, flux.t5_max_length) == (
        tcfg.FLUX_SCHNELL_VERSION, True, 256)
    assert FluxPipeline(load=False, low_memory_mode=False,
                        device="cpu", model_version=tcfg.FLUX_DEV_VERSION).t5_max_length == 512
    with pytest.raises(ValueError, match="model_version"):
        DiffusionPipeline(load=False, low_memory_mode=False,
                          device="cpu", model_version="argmaxinc/unknown")
    with pytest.raises(ValueError, match="use_t5"):
        sd3.encode_text(PROMPT)  # T5 on, but no T5 assigned


# -- the upcast segments ----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upcast_mmdit_matches_jax(dtype, monkeypatch):
    """The tiny SD3.5 against ``apply_mmdit`` on the same weights in the
    model dtype, block 1 in fp32 on both sides (the reference casts it per
    forward, the port holds it cast). fp32: the model-level baseline of
    tests/test_mmdit_parity.py (atol 2e-4 / rtol 1e-3). bf16: both sides
    round at the same points but XLA's CPU code and torch's kernels round
    some fused chains differently; 1e-2 relative L2 over the three blocks.
    Block 1 alone, fed the same bf16 streams upcast and the bf16 c, runs in
    fp32 on both sides but for its `ada` output, rounded to bf16 as the
    reference's promotion rounds it: 1e-4 relative L2, with the JAX SiLU of
    the bf16 c computed in fp32 and rounded once, as torch computes it (XLA
    rounds each op of a bf16 SiLU, one bf16 ulp off on some elements, which
    the modulation carries to ~4e-3 of the block's update)."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    jcfg = dataclasses.replace(TINY_SD35, dtype=jdt)
    params = in_dtype(with_unit_qk_scales(
        randomize(init_mmdit_params(jax.random.PRNGKey(0), jcfg), seed=40)), jdt)
    model = mmdit_from_jax(params, port_config(jcfg, tdt), device="cpu")
    assert_block_1_upcast(model, tdt)
    args = inputs(jcfg, 41)
    want = np.asarray(apply_mmdit(params, jcfg, *map(jnp.asarray, args)).astype(jnp.float32))
    with torch.no_grad():
        out = model(*map(torch.from_numpy, args))
    assert out.dtype == tdt and out.shape == (2, 8, 8, 16)
    got = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max(), rtol=1e-3)
    else:
        assert rel_l2(got, want) < 1e-2, rel_l2(got, want)

    rs = np.random.RandomState(42)
    img, txt = (rs.randn(2, n, 64).astype(np.float32) for n in (16, 7))
    c = rs.randn(2, 64).astype(np.float32)
    bp = jax.tree.map(lambda a: None if a is None else jnp.asarray(a[1]).astype(jnp.float32),
                      params["mm_blocks"], is_leaf=lambda a: a is None)
    silu = jax.nn.silu
    monkeypatch.setattr(jax.nn, "silu", lambda x: silu(x.astype(jnp.float32)).astype(x.dtype))
    ji, jt = jax_mmdit._mm_block(bp, jnp.asarray(img), jnp.asarray(txt),
                                 jnp.asarray(c).astype(jdt), None, jcfg, None)
    with torch.no_grad():
        ti, tt = model.mm_blocks[1](torch.from_numpy(img), torch.from_numpy(txt),
                                    torch.from_numpy(c).to(tdt))
    assert ti.dtype == tt.dtype == torch.float32
    assert rel_l2(ti.numpy() - img, np.asarray(ji) - img) < 1e-4
    assert rel_l2(tt.numpy() - txt, np.asarray(jt) - txt) < 1e-4


def test_sd3_8b_builds_block_35_in_fp32():
    with torch.device("meta"):
        model = MMDiT(tcfg.SD3_8b)
    assert len(model.mm_blocks) == 37 and model.config.hidden_size == 2432
    for i, block in enumerate(model.mm_blocks):
        assert float_dtypes(block) == {torch.float32 if i == 35 else torch.bfloat16}, i


def test_init_mmdit_draws_the_upcast_block_in_the_model_dtype():
    from diffusionkit_tpu_torch.models import init_mmdit

    cfg = port_config(WIDE_SD35, torch.bfloat16)
    model = init_mmdit(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert_block_1_upcast(model, torch.bfloat16)
    w = model.mm_blocks[1].img.q.weight
    assert w.std() > 0 and torch.equal(w, w.bfloat16().float())


# -- the quantized forms ----------------------------------------------------------


def quantized_params(jcfg, mode, seed):
    """A random tree in ``mode`` as the reference's quantized init draws it
    (int4 / int8 / w8a8 block linears; w4a8: int4 with ``add_wscale_tree``),
    redrawn at scales where every layer moves the output, in the model
    dtype. A "-mixed" mode is a random float tree quantized as the
    reference's pipeline quantizes it (``quantize_tree`` at group 64 with
    ``MIXED_OVERRIDES``: the block linears int4, every ``ada`` int8, the
    embedders and the final layer float; w4a8-mixed with
    ``add_wscale_tree`` after)."""
    if mode.endswith("-mixed"):
        params = randomize(init_mmdit_params(jax.random.PRNGKey(0), jcfg), seed=seed)
        for stream in ("img", "txt"):
            qk = params["mm_blocks"][stream]["qk_norm"]
            params["mm_blocks"][stream]["qk_norm"] = randomize(qk, seed=seed + 2)
        host = jax.tree.map(lambda a: None if a is None else np.asarray(a, np.float32),
                            with_unit_qk_scales(params), is_leaf=lambda a: a is None)
        params = jq.quantize_tree(host, bits=4, group_size=64, overrides=jq.MIXED_OVERRIDES)
        if mode == "w4a8-mixed":
            params = jw.add_wscale_tree(params)
        return in_dtype(params, jcfg.dtype)
    bits = {"int4": 4, "w4a8": 4, "int8": 8, "w8a8": "w8a8"}[mode]
    params = init_mmdit_params(jax.random.PRNGKey(0), jcfg, quantize_bits=bits)
    if bits == 4:
        params = randomize_packed(params, seed=seed)
    floats = {k: v for k, v in params.items() if k != "mm_blocks" and k != "mm_final"}
    params.update(randomize(floats, seed=seed + 1))
    for stream in ("img", "txt"):
        qk = params["mm_blocks"][stream]["qk_norm"]
        params["mm_blocks"][stream]["qk_norm"] = randomize(qk, seed=seed + 2)
    params = with_unit_qk_scales(params)
    if mode == "w4a8":
        params = jw.add_wscale_tree(params)
    return in_dtype(params, jcfg.dtype)


@pytest.mark.parametrize("mode", ["int4", "int8", "w8a8", "w4a8", "w4a8-mixed", "int4-mixed"])
def test_quantized_upcast_mmdit_matches_jax(mode, request, monkeypatch):
    """Each quantize mode of the tiny SD3.5 (hidden 256) in bf16 against the
    JAX package on the same tree: after conversion block 1's packed (or
    w8a8) leaves are the tree's bit for bit and its floats fp32; under
    "-mixed" every ``ada`` int8 and the embedders and final layer float.
    The JAX side runs its TPU dispatch on the CPU where it has one (w4a8
    and w4a8-mixed through ``jax_tpu_dispatch``, w4a8-mixed's int8 ``ada``
    on the reference's #13 kernel in interpret mode; w8a8's fused
    quantizers in interpret mode), else its dequantising dot (int4, int8,
    int4-mixed). bf16 through three blocks, with the int8 activations of
    w8a8 and w4a8 moving by a step where bf16 rounding differs: 3e-2
    relative L2, the phase-5 bound of bf16 against fp32."""
    if mode.startswith("w4a8"):
        request.getfixturevalue("jax_tpu_dispatch")
        if mode == "w4a8-mixed":
            from diffusionkit_tpu.ops import int4_matmul as ji

            int8_matmul = ji.int8_matmul
            monkeypatch.setattr(ji, "int8_matmul",
                                lambda *a, **kw: int8_matmul(*a, **{**kw, "interpret": True}))
    else:
        monkeypatch.setenv("DIFFUSIONKIT_TPU_FUSED_QUANT", "interpret")
    jcfg = dataclasses.replace(WIDE_SD35, dtype=jnp.bfloat16)
    params = quantized_params(jcfg, mode, seed=50)
    model = mmdit_from_jax(params, port_config(jcfg, torch.bfloat16), device="cpu")
    assert_block_1_upcast(model, torch.bfloat16)
    layer, leaf = model.mm_blocks[1].img.fc1, params["mm_blocks"]["img"]["fc1"]
    if mode == "w8a8":
        assert isinstance(layer, W8A8Linear)
        assert np.array_equal(layer.w8.numpy().T, np.asarray(leaf["w8"])[1])
    else:
        assert isinstance(layer, tq.QuantizedLinear) and (layer.wscale is not None) == (
            mode.startswith("w4a8"))
        if mode.endswith("-mixed"):
            ada = model.mm_blocks[1].img.ada
            assert isinstance(ada, tq.QuantizedLinear) and ada.bits == 8
            assert np.array_equal(ada.q8.numpy(), np.asarray(params["mm_blocks"]["img"]["ada"]
                                                             ["q8"])[1])
            assert not isinstance(model.final_layer.ada, tq.QuantizedLinear)
            assert not isinstance(model.context_embedder, tq.QuantizedLinear)
        if mode == "int8":
            assert np.array_equal(layer.q8.numpy(), np.asarray(leaf["q8"])[1])
        else:
            assert np.array_equal(layer.q4.numpy().view(np.uint32), np.asarray(leaf["q4"])[1])
    assert layer.bias.dtype == torch.float32
    args = inputs(jcfg, 51)
    want = np.asarray(apply_mmdit(params, jcfg, *map(jnp.asarray, args)).astype(jnp.float32))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, args)).float().numpy()
    assert got.shape == (2, 8, 8, 16) and np.isfinite(got).all()
    assert rel_l2(got, want) < 3e-2, rel_l2(got, want)


def test_quantize_at_load_upcasts_after_quantizing(monkeypatch):
    """``DiffusionPipeline(quantize_mmdit=...)`` on a bf16 SD3.5: block 1's
    linears are quantized from its bf16 values (the same packed leaves as
    the bf16 block 0 would give them) and keep fp32 biases; w4a8 adds
    fp32 ``wscale``. The data-free grid (``DIFFUSIONKIT_TPU_GPTQ=0``), so
    each linear's leaves are ``quantize_linear``'s."""
    from diffusionkit_tpu_torch.models import init_mmdit

    monkeypatch.setenv("DIFFUSIONKIT_TPU_GPTQ", "0")

    cfg = port_config(WIDE_SD35, torch.bfloat16)
    for mode in ("int4", "w4a8", "w8a8"):
        pipe = DiffusionPipeline(load=False, low_memory_mode=False,
                                 device="cpu", use_t5=False, quantize_mmdit=mode,
                                 quantize_group_size=64)
        model = init_mmdit(cfg, torch.Generator().manual_seed(1), device="cpu")
        w = model.mm_blocks[1].img.fc1.weight.detach().clone()
        pipe.mmdit = model
        assert_block_1_upcast(pipe.mmdit, torch.bfloat16)
        fc1 = pipe.mmdit.mm_blocks[1].img.fc1
        if mode == "w8a8":
            assert isinstance(fc1, W8A8Linear) and fc1.bias.dtype == torch.float32
        else:
            with torch.no_grad():
                lin = torch.nn.Linear(w.shape[1], w.shape[0], dtype=torch.bfloat16)
                lin.weight.copy_(w)
                lin.bias.zero_()
            ref = tq.quantize_linear(lin, 64)
            assert torch.equal(fc1.q4, ref.q4) and torch.equal(fc1.scales, ref.scales)
            assert (fc1.wscale is not None) == (mode == "w4a8")


# -- the 19 x 128 widths ------------------------------------------------------------


@pytest.mark.parametrize("k", [2432, 9728])
@pytest.mark.parametrize("n", [2432, 9728, 14592])
@pytest.mark.parametrize("m", [2, 308, 8192])
def test_sd35_widths_name_a_kernel(m, k, n):
    """SD3.5-large's widths (hidden 2432 = 19 x 128, FFN 9728, `ada`
    14592) take a kernel on every route, none raising: #11's (the M <= 16
    GEMV needs K % 256, so at K = 2432 the mma.sync tile), kernel E's by
    mode (the FFN modes where the shapes are an FFN's), C and #13 in bf16
    and fp32."""
    from diffusionkit_tpu_torch.ops.int4_matmul import dequant_kernel

    route = tw.w8_route(m, k, n)
    assert route == ("gemv" if m <= 16 and k % 256 == 0 else "tile" if m <= 16 else "sm90")
    modes = ["plain"] + (["gelu_quant"] if n % 512 == 0 else []) + (
        ["grouped_xs"] if k % 512 == 0 else [])
    for mode in modes:
        assert tw.w4a8_kernel(m, k, k // 8, n, k // 64, mode).startswith("dk_")
    for dtype in (torch.bfloat16, torch.float32):
        for name in ("int4_matmul", "int8_matmul"):
            assert dequant_kernel(name, m, k, k, n, k // 64, dtype).startswith("dk_")
    assert tw.w4a8_ffn_eligible(tq.QuantizedLinear(2432, 9728, 64, wscale=True),
                                tq.QuantizedLinear(9728, 2432, 64, wscale=True))


# -- SD3 with T5 ----------------------------------------------------------------


@pytest.fixture(scope="module")
def t5_pipelines():
    """tests/test_pipeline.py's tiny SD3 pipeline with T5 (CLIP-L/G, a T5
    of d_model 8, 16-token tokenizers), its weights redrawn, and the port's
    ``DiffusionPipeline(use_t5=True)`` on the same weights and tokenizers."""
    jp = build_sd3_pipeline(use_t5=True)
    jp.activation_dtype = jnp.float32  # the VAE in fp32 on both sides
    jp.clip_l = randomize(jp.clip_l, 1)
    jp.clip_g = randomize(jp.clip_g, 2)
    jp.t5_params = randomize(jp.t5_params, 3)
    jp.mmdit_params = randomize(jp.mmdit_params, 4)
    jp.decoder_params = randomize(jp.decoder_params, 5)
    tp = DiffusionPipeline(load=False, low_memory_mode=False,
                           shift=3.0, use_t5=True, a16=False, device="cpu")
    for name in ("clip_l", "clip_g"):
        setattr(tp, name, clip_from_jax(getattr(jp, name), torch_config(
            getattr(jp, f"{name}_config"), tcfg.CLIPTextModelConfig), device="cpu"))
    tp.t5_tokenizer = TinyT5Tokenizer()
    tp.t5 = t5_from_jax(jp.t5_params, torch_config(jp.t5_config, tcfg.T5Config), device="cpu")
    tp.mmdit = mmdit_from_jax(jp.mmdit_params, torch_config(jp.mmdit_config, tcfg.MMDiTConfig),
                              device="cpu")
    tp.decoder = vae_decoder_from_jax(
        jp.decoder_params, torch_config(jp.decoder_config, tcfg.VAEDecoderConfig), device="cpu")
    for name in ("tokenizer_l", "tokenizer_g"):
        jtok = getattr(jp, name)
        tok = CLIPTokenizer({}, jtok.vocab, pad_with_eos=jtok.pad_with_eos)
        tok.max_length = jtok.max_length
        setattr(tp, name, tok)
    return jp, tp


def test_sd3_t5_conditioning_matches_jax(t5_pipelines):
    """CLIP's 16 rows then T5's 16 (d_model 8, zero-padded to 4096
    features), against the JAX ``encode_text`` (fp32 encoders: 1e-5)."""
    jp, tp = t5_pipelines
    jc, jpool = jp.encode_text(PROMPT, 5.0, NEGATIVE)
    tc, tpool = tp.encode_text(PROMPT, 5.0, NEGATIVE)
    assert tuple(tc.shape) == (2, 32, 4096) and tuple(tpool.shape) == (2, 16)
    assert np.abs(tc[:, 16:, :8].numpy()).max() > 0 and not tc[:, 16:, 8:].any()
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), atol=1e-5, rtol=1e-4)


def test_sd3_t5_txt2img_matches_jax(t5_pipelines):
    """The tiny SD3 with T5 through two CFG-5 Euler steps and the decode,
    as tests/test_torch_pipeline.py holds the pipeline without T5: latents
    within 1e-3, pixels one level apart at most."""
    jp, tp = t5_pipelines
    jc, jpool = jp.encode_text(PROMPT, 5.0, NEGATIVE)
    tc, tpool = tp.encode_text(PROMPT, 5.0, NEGATIVE)
    jlat, _ = jp.denoise_latents(jc, jpool, num_steps=2, cfg_weight=5.0, latent_size=(8, 8),
                                 seed=SEED)
    tlat, _ = tp.denoise_latents(tc, tpool, num_steps=2, cfg_weight=5.0, latent_size=(8, 8),
                                 seed=SEED)
    jlat = np.asarray(jlat)
    assert np.abs(jlat).max() > 1.0
    np.testing.assert_allclose(tlat.numpy(), jlat, atol=1e-3, rtol=1e-3)
    kw = dict(num_steps=2, cfg_weight=5.0, negative_text=NEGATIVE, latent_size=(8, 8), seed=SEED,
              verbose=False)
    a = np.asarray(jp.generate_image(PROMPT, **kw)[0]).astype(int)
    b = np.asarray(tp.generate_image(PROMPT, **kw)[0]).astype(int)
    assert a.shape == b.shape == (64, 64, 3) and b.std() > 5
    assert np.abs(a - b).max() <= 1
