"""The whole tiny SD3 txt2img path of the PyTorch port against the JAX package.

A tiny SD3 pipeline is built the way tests/test_pipeline.py builds one (with
hidden 128, so the MMDiT's AdaLN sites are eligible for the fused kernel),
its weights are redrawn at variance-preserving scales and carried into the
port with ``convert.py``, and both run ``generate_image`` with one prompt,
seed, CFG 5.0 and 2 Euler steps at latent 8x8.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionkit_tpu.config import CLIPTextModelConfig, MMDiTConfig, VAEDecoderConfig
from diffusionkit_tpu.models import init_clip_params, init_mmdit_params, init_vae_decoder_params
from diffusionkit_tpu.pipeline import DiffusionPipeline as JaxPipeline
from diffusionkit_tpu.tokenizer import CLIPTokenizer as JaxCLIPTokenizer
from diffusionkit_tpu.tokenizer import tokenize_batch as jax_tokenize_batch
from diffusionkit_tpu_torch import config as tcfg
from diffusionkit_tpu_torch.convert import clip_from_jax, mmdit_from_jax, vae_decoder_from_jax
from diffusionkit_tpu_torch.pipeline import DiffusionPipeline
from diffusionkit_tpu_torch.tokenizer import BOS, EOS, CLIPTokenizer, synthetic_clip_vocab, tokenize_batch

from test_torch_models import randomize, torch_config

torch.set_num_threads(1)

PROMPT, NEGATIVE, SEED = "a photo of a cat", "blurry", 42


def tiny_vocab():
    vocab = {}
    for c in "abcdefghijklmnopqrstuvwxyz ,.":
        vocab[c] = len(vocab)
        vocab[c + "</w>"] = len(vocab)
    vocab[BOS] = len(vocab)
    vocab[EOS] = len(vocab)
    return vocab


def build_pipelines():
    """The tiny JAX SD3 pipeline and the port's, on the same weights."""
    # a16=False: the VAE decodes in fp32 on both sides, where the point on
    # the CPU is the algorithm (bf16 rounds at different places in XLA's
    # fused CPU code and in torch's per-op kernels).
    jp = JaxPipeline(load=False, low_memory_mode=False, use_t5=False, shift=3.0, a16=False)
    key = jax.random.PRNGKey(0)
    clip_l = CLIPTextModelConfig(num_layers=2, model_dims=8, num_heads=2, max_length=16,
                                 vocab_size=64, projection_dim=None, hidden_act="quick_gelu")
    clip_g = CLIPTextModelConfig(num_layers=2, model_dims=8, num_heads=2, max_length=16,
                                 vocab_size=64, projection_dim=8, hidden_act="gelu")
    mmdit = MMDiTConfig(depth_multimodal=2, num_heads=2, hidden_size_override=128,
                        max_latent_resolution=16, pooled_text_embed_dim=16, dtype=jnp.float32)
    vae = VAEDecoderConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=2, resnet_groups=4)
    jp.clip_l, jp.clip_l_config = randomize(init_clip_params(key, clip_l), 1), clip_l
    jp.clip_g, jp.clip_g_config = randomize(init_clip_params(key, clip_g), 2), clip_g
    jp.mmdit_params, jp.mmdit_config = randomize(init_mmdit_params(key, mmdit), 3), mmdit
    jp.decoder_config = vae
    jp.decoder_params = randomize(init_vae_decoder_params(key, vae), 4)
    for name, pad in (("tokenizer_l", True), ("tokenizer_g", False)):
        tok = JaxCLIPTokenizer({}, tiny_vocab(), pad_with_eos=pad)
        tok.max_length = 16
        setattr(jp, name, tok)

    tp = DiffusionPipeline(load=False, low_memory_mode=False,
                           shift=3.0, use_t5=False, a16=False, device="cpu")
    tp.clip_l = clip_from_jax(
        jp.clip_l, torch_config(clip_l, tcfg.CLIPTextModelConfig), device="cpu")
    tp.clip_g = clip_from_jax(
        jp.clip_g, torch_config(clip_g, tcfg.CLIPTextModelConfig), device="cpu")
    tp.mmdit = mmdit_from_jax(jp.mmdit_params, torch_config(mmdit, tcfg.MMDiTConfig), device="cpu")
    tp.decoder = vae_decoder_from_jax(
        jp.decoder_params, torch_config(vae, tcfg.VAEDecoderConfig), device="cpu")
    for name, pad in (("tokenizer_l", True), ("tokenizer_g", False)):
        tok = CLIPTokenizer({}, tiny_vocab(), pad_with_eos=pad)
        tok.max_length = 16
        setattr(tp, name, tok)
    return jp, tp


@pytest.fixture(scope="module")
def pipelines():
    return build_pipelines()


def test_text_conditioning_matches_jax(pipelines):
    jp, tp = pipelines
    jc, jpool = jp.encode_text(PROMPT, 5.0, NEGATIVE)
    tc, tpool = tp.encode_text(PROMPT, 5.0, NEGATIVE)
    assert tuple(tc.shape) == (2, 32, 4096) and tuple(tpool.shape) == (2, 16)
    # fp32 CLIP-L and CLIP-G, two layers each.
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), atol=1e-5, rtol=1e-4)


def test_generate_image_matches_jax(pipelines, monkeypatch):
    # JAX runs its Pallas mod_ln in interpret mode at the eligible sites.
    monkeypatch.setenv("DIFFUSIONKIT_TPU_FUSED_QUANT", "interpret")
    jp, tp = pipelines
    kw = dict(num_steps=2, cfg_weight=5.0, negative_text=NEGATIVE, latent_size=(8, 8),
              seed=SEED, verbose=False)

    jc, jpool = jp.encode_text(PROMPT, 5.0, NEGATIVE)
    tc, tpool = tp.encode_text(PROMPT, 5.0, NEGATIVE)
    jlat, _ = jp.denoise_latents(jc, jpool, num_steps=2, cfg_weight=5.0,
                                 latent_size=(8, 8), seed=SEED)
    tlat, iters = tp.denoise_latents(tc, tpool, num_steps=2, cfg_weight=5.0,
                                     latent_size=(8, 8), seed=SEED)
    assert len(iters) == 2
    jlat = np.asarray(jlat)
    assert np.abs(jlat).max() > 1.0
    # fp32 MMDiT (the model-level baseline of tests/test_mmdit_parity.py,
    # atol 2e-4 / rtol 1e-3) through two CFG-5 Euler steps, whose guidance
    # scales the difference of two model outputs by 5.
    np.testing.assert_allclose(tlat.numpy(), jlat, atol=1e-3, rtol=1e-3)

    jimg, jlog = jp.generate_image(PROMPT, **kw)
    timg, tlog = tp.generate_image(PROMPT, **kw)
    a, b = np.asarray(jimg).astype(int), np.asarray(timg).astype(int)
    assert a.shape == b.shape == (64, 64, 3)
    assert b.std() > 5  # a structured image, not a flat grey
    # floor(x * 255) sits at a level boundary: fp32 noise may move a pixel
    # by one level, never more.
    assert np.abs(a - b).max() <= 1
    for phase in ("text_encoding", "denoising", "decoding"):
        assert tlog[phase]["time"] is not None
    assert len(tlog["denoising"]["iter_time"]) == 2


def test_generate_image_is_deterministic(pipelines):
    _, tp = pipelines
    kw = dict(num_steps=2, cfg_weight=5.0, latent_size=(8, 8), verbose=False)
    img1, _ = tp.generate_image(PROMPT, seed=7, **kw)
    img2, _ = tp.generate_image(PROMPT, seed=7, **kw)
    img3, _ = tp.generate_image(PROMPT, seed=8, **kw)
    np.testing.assert_array_equal(np.asarray(img1), np.asarray(img2))
    assert not np.array_equal(np.asarray(img1), np.asarray(img3))


def test_cfg_off_runs_the_positive_row_only(pipelines):
    _, tp = pipelines
    img, log = tp.generate_image(PROMPT, num_steps=1, cfg_weight=0.0, latent_size=(8, 8),
                                 seed=1, verbose=False)
    assert img.size == (64, 64) and len(log["denoising"]["iter_time"]) == 1


def test_synthetic_vocab_tokenizes_like_jax():
    vocab = synthetic_clip_vocab()
    # 95 printable characters, each also with "</w>", then BOS and EOS.
    assert len(vocab) == 49408 and (vocab[BOS], vocab[EOS]) == (190, 191)
    tok = CLIPTokenizer({}, vocab, pad_with_eos=True)
    jtok = JaxCLIPTokenizer({}, vocab, pad_with_eos=True)
    want = jax_tokenize_batch(jtok, "A red Fox, 3 times!", "ugly")
    got = tokenize_batch(tok, "A red Fox, 3 times!", "ugly")
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 77) and got.dtype == np.int32


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import diffusionkit_tpu_torch\n"
        "from diffusionkit_tpu_torch import config, convert, flops, graphs, model_io, pipeline, "
        "sampler, tokenizer, utils\n"
        "from diffusionkit_tpu_torch.models import clip, mmdit, t5, vae\n"
        "from diffusionkit_tpu_torch.ops import attention, common, flash_attention, "
        "fused_quant, int4_matmul, kernels, launches, norms, quantized, rope, smoothquant\n"
        "from diffusionkit_tpu_torch import parallel\n"
        "from diffusionkit_tpu_torch.parallel import mesh, ring_attention\n"
        "from diffusionkit_tpu_torch.ops import w4a8_matmul, w8a8\n"
        "from diffusionkit_tpu_torch.tools import bench_flash, bench_gemv, bench_mat, bench_rows, "
        "bench_w4a8_mat, microbench_int8, sass_diff\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'diffusionkit_tpu.')))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
