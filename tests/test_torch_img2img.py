"""img2img in the PyTorch port against the JAX package: the VAE encoder, the
generic Autoencoder, ``read_image``, ``encode_image_to_latents`` and
``generate_image(image_path, denoise)`` for SD3 (CFG 5.0) and FLUX.

The tiny pipelines of tests/test_torch_pipeline.py and
tests/test_torch_scan.py run on shared weights, with a tiny VAE encoder
(channels (8, 16, 16, 16), 4 groups) redrawn with numpy and carried into
the port by ``convert.py``; fp32 on the CPU, where the point is the
algorithm. The source images are seeded numpy noise saved as PNG.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffusionkit_tpu.config import AutoencoderConfig as JaxAutoencoderConfig
from diffusionkit_tpu.config import VAEEncoderConfig as JaxVAEEncoderConfig
from diffusionkit_tpu.models.vae import (
    apply_autoencoder,
    apply_vae_encoder,
    autoencoder_decode,
    autoencoder_encode,
    init_autoencoder_params,
    init_vae_encoder_params,
)
from diffusionkit_tpu_torch import config as tcfg
from diffusionkit_tpu_torch import model_io
from diffusionkit_tpu_torch.convert import autoencoder_from_jax, vae_encoder_from_jax
from diffusionkit_tpu_torch.models import init_autoencoder, init_vae_encoder
from diffusionkit_tpu_torch.pipeline import DiffusionPipeline, FluxLatentFormat, SD3LatentFormat

from test_torch_models import randomize, torch_config
from test_torch_pipeline import NEGATIVE, PROMPT, build_pipelines
from test_torch_scan import flux_pipelines

torch.set_num_threads(1)

TINY_ENCODER = JaxVAEEncoderConfig(block_out_channels=(8, 16, 16, 16), layers_per_block=2,
                                   resnet_groups=4)
TINY_AE = JaxAutoencoderConfig(block_out_channels=(8, 16, 16, 16), layers_per_block=2,
                               norm_num_groups=4, latent_channels_out=32, latent_channels_in=16,
                               scaling_factor=0.13025)
# fp32 on both sides; the two differ in the order of the convolutions' and
# GroupNorms' fp32 sums only (the measured worst is ~1e-7 of outputs ~0.5).
ATOL, RTOL = 1e-5, 1e-4
# The denoised latents: the fp32 model-level baseline of the txt2img tests
# (tests/test_torch_pipeline.py) through two Euler steps.
LATENT_ATOL = LATENT_RTOL = 1e-3


def tiny_encoder(seed: int = 5):
    params = randomize(init_vae_encoder_params(jax.random.PRNGKey(seed), TINY_ENCODER), seed)
    return params, vae_encoder_from_jax(
        params, torch_config(TINY_ENCODER, tcfg.VAEEncoderConfig), device="cpu")


def write_png(path, h: int, w: int, seed: int, channels: int = 3) -> str:
    pixels = np.random.RandomState(seed).randint(0, 256, (h, w, channels)).astype(np.uint8)
    Image.fromarray(pixels).save(path)
    return str(path)


def with_encoder(jp, tp, seed: int = 5):
    jp.encoder_config = TINY_ENCODER
    jp.encoder_params, tp.encoder = tiny_encoder(seed)
    return jp, tp


@pytest.fixture(scope="module")
def sd3():
    return with_encoder(*build_pipelines())


@pytest.fixture(scope="module")
def flux():
    return with_encoder(*flux_pipelines(guidance_embed=False))


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    """A 64 x 64 source image (latent 8 x 8)."""
    return write_png(tmp_path_factory.mktemp("img2img") / "src.png", 64, 64, seed=0)


@pytest.mark.parametrize("size", [(32, 32), (64, 48)])
def test_vae_encoder_matches_jax(size):
    params, model = tiny_encoder()
    x = np.random.RandomState(1).uniform(-1, 1, (1, *size, 3)).astype(np.float32)
    want = np.asarray(apply_vae_encoder(params, jnp.asarray(x), TINY_ENCODER))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, size[0] // 8, size[1] // 8, 32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_encoder_downsample_pads_bottom_and_right():
    """The sgm downsample: one pixel of zeros below and to the right, a
    valid stride-2 convolution. A symmetric padding=1 reads the top row and
    left column of zeros instead and gives other values."""
    model = init_vae_encoder(tcfg.VAEEncoderConfig(block_out_channels=(4, 4), layers_per_block=1,
                                                   resnet_groups=2),
                             torch.Generator().manual_seed(0), device="cpu")
    conv = model.down_blocks[0].downsample
    assert conv.stride == (2, 2) and conv.padding == (0, 0)
    x = torch.randn(1, 4, 8, 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = torch.nn.functional.conv2d(torch.nn.functional.pad(x, (0, 1, 0, 1)), conv.weight,
                                         conv.bias, stride=2)
        block = model.down_blocks[0]
        block.resnets = torch.nn.ModuleList()  # the downsample alone
        torch.testing.assert_close(block(x), got, rtol=0, atol=0)
        sym = torch.nn.functional.conv2d(x, conv.weight, conv.bias, stride=2, padding=1)
    assert got.shape == sym.shape == (1, 4, 4, 4)
    assert not torch.allclose(got, sym)


@pytest.fixture(scope="module")
def autoencoders():
    params = randomize(init_autoencoder_params(jax.random.PRNGKey(2), TINY_AE), 6)
    return params, autoencoder_from_jax(params, torch_config(TINY_AE, tcfg.AutoencoderConfig),
                                        device="cpu")


def test_autoencoder_encode_matches_jax(autoencoders):
    params, model = autoencoders
    x = np.random.RandomState(3).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    jm, jl = autoencoder_encode(params, jnp.asarray(x), TINY_AE)
    with torch.no_grad():
        tm, tl = model.encode(torch.from_numpy(x))
    assert tuple(tm.shape) == tuple(tl.shape) == (1, 4, 4, 16)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=RTOL)


def test_autoencoder_decode_matches_jax(autoencoders):
    params, model = autoencoders
    z = np.random.RandomState(4).randn(1, 4, 4, 16).astype(np.float32)
    want = np.asarray(autoencoder_decode(params, jnp.asarray(z), TINY_AE))
    with torch.no_grad():
        got = model.decode(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_autoencoder_roundtrip_matches_jax_at_the_same_z(autoencoders):
    """The JAX round trip's z decoded by the port gives its x_hat; the
    port's round trip is z = mean + exp(logvar / 2) * the generator's
    noise, and x_hat its decode."""
    params, model = autoencoders
    x = np.random.RandomState(5).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    jout = apply_autoencoder(params, jnp.asarray(x), jax.random.PRNGKey(7), TINY_AE)
    with torch.no_grad():
        np.testing.assert_allclose(model.decode(torch.from_numpy(np.array(jout["z"]))).numpy(),
                                   np.asarray(jout["x_hat"]), atol=ATOL, rtol=RTOL)
        out = model(torch.from_numpy(x), torch.Generator().manual_seed(9))
    noise = torch.randn(out["mean"].shape, generator=torch.Generator().manual_seed(9))
    np.testing.assert_allclose(out["mean"].numpy(), np.asarray(jout["mean"]), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out["logvar"].numpy(), np.asarray(jout["logvar"]), atol=ATOL,
                               rtol=RTOL)
    torch.testing.assert_close(out["z"], noise * torch.exp(0.5 * out["logvar"]) + out["mean"],
                               rtol=0, atol=0)
    with torch.no_grad():
        torch.testing.assert_close(out["x_hat"], model.decode(out["z"]), rtol=0, atol=0)


def test_init_autoencoder_round_trip_shapes():
    cfg = tcfg.AutoencoderConfig(block_out_channels=(8, 8), layers_per_block=1,
                                 norm_num_groups=4)
    model = init_autoencoder(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert len(model.decoder.up_blocks[0].resnets) == 2  # layers_per_block + 1
    with torch.no_grad():
        out = model(torch.rand(1, 16, 16, 3) * 2 - 1, torch.Generator().manual_seed(1))
    assert tuple(out["x_hat"].shape) == (1, 16, 16, 3) and tuple(out["z"].shape) == (1, 8, 8, 4)
    assert all(torch.isfinite(v).all() for v in out.values())


@pytest.mark.parametrize("h, w, channels", [(64, 64, 3), (70, 70, 3), (70, 130, 4)])
def test_read_image_is_the_jax_ones_bit_for_bit(sd3, tmp_path, h, w, channels):
    jp, tp = sd3
    path = write_png(tmp_path / "img.png", h, w, seed=h + w, channels=channels)
    want = np.asarray(jp.read_image(path))
    got = tp.read_image(path)
    assert got.dtype == np.float32 and got.shape == (1, h - h % 64, w - w % 64, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", ["sd3", "flux"])
def test_process_in_matches_jax_and_inverts_process_out(fmt):
    from diffusionkit_tpu.pipeline import FluxLatentFormat as JaxFlux
    from diffusionkit_tpu.pipeline import SD3LatentFormat as JaxSD3

    ours, theirs = (SD3LatentFormat(), JaxSD3()) if fmt == "sd3" else (FluxLatentFormat(),
                                                                        JaxFlux())
    x = np.random.RandomState(0).randn(1, 4, 4, 16).astype(np.float32)
    got = ours.process_in(x)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(theirs.process_in(x)))
    back = ours.process_out(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(back, x, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("which", ["sd3", "flux"])
def test_encode_image_to_latents_matches_jax(sd3, flux, src, which):
    jp, tp = sd3 if which == "sd3" else flux
    want = np.asarray(jp.encode_image_to_latents(src, seed=3))
    got = tp.encode_image_to_latents(src, seed=3)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (1, 8, 8, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_sd3_img2img_matches_jax(sd3, src):
    jp, tp = sd3
    kw = dict(num_steps=4, cfg_weight=5.0, latent_size=(8, 8), seed=3, image_path=src,
              denoise=0.5)
    jc, jpool = jp.encode_text(PROMPT, 5.0, NEGATIVE)
    tc, tpool = tp.encode_text(PROMPT, 5.0, NEGATIVE)
    jlat, _ = jp.denoise_latents(jc, jpool, **kw)
    tlat, iters = tp.denoise_latents(tc, tpool, **kw)
    assert len(iters) == 2
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), atol=LATENT_ATOL, rtol=LATENT_RTOL)

    kw = dict(kw, negative_text=NEGATIVE, verbose=False)
    jimg, jlog = jp.generate_image(PROMPT, **kw)
    timg, tlog = tp.generate_image(PROMPT, **kw)
    a, b = np.asarray(jimg).astype(int), np.asarray(timg).astype(int)
    assert a.shape == b.shape == (64, 64, 3)
    # floor(x * 255) at a level boundary: fp32 noise moves a pixel one level.
    assert np.abs(a - b).max() <= 1
    assert len(tlog["denoising"]["iter_time"]) == len(jlog["denoising"]["iter_time"]) == 2


def test_flux_img2img_matches_jax(flux, src):
    jp, tp = flux
    kw = dict(num_steps=4, cfg_weight=0.0, latent_size=(8, 8), seed=11, image_path=src,
              denoise=0.5)
    jc, jpool = jp.encode_text("a dog", cfg_weight=0.0)
    tc, tpool = tp.encode_text("a dog", cfg_weight=0.0)
    jlat, _ = jp.denoise_latents(jc, jpool, **kw)
    tlat, iters = tp.denoise_latents(tc, tpool, **kw)
    assert len(iters) == 2
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), atol=LATENT_ATOL, rtol=LATENT_RTOL)
    jimg, _ = jp.generate_image("a dog", verbose=False, **kw)
    timg, log = tp.generate_image("a dog", verbose=False, **kw)
    a, b = np.asarray(jimg).astype(int), np.asarray(timg).astype(int)
    assert a.shape == b.shape == (64, 64, 3) and np.abs(a - b).max() <= 1
    assert len(log["denoising"]["iter_time"]) == 2


# (num_steps, denoise, steps run): the reference keeps sigmas from
# int(num_steps * (1 - denoise)), so 5 steps at 0.3 run 2 (not int(1.5)).
@pytest.mark.parametrize("num_steps, denoise, steps", [(4, 0.5, 2), (50, 0.6, 30), (4, 1.0, 4),
                                                        (5, 0.3, 2)])
def test_img2img_runs_the_last_steps_of_the_schedule(sd3, src, num_steps, denoise, steps):
    _, tp = sd3
    cond, pooled = tp.encode_text(PROMPT, 0.0)
    ran = []
    step = tp._denoise_scan

    def record(x, sigmas, *args):
        ran.append(np.array(sigmas))
        return step(x, sigmas, *args)

    tp._denoise_scan = record
    try:
        _, iters = tp.denoise_latents(cond, pooled, num_steps=num_steps, cfg_weight=0.0,
                                      latent_size=(8, 8), seed=1, image_path=src, denoise=denoise)
    finally:
        del tp._denoise_scan
    assert len(iters) == steps
    np.testing.assert_array_equal(ran[0], tp.get_sigmas(num_steps)[num_steps - steps:])


def test_denoise_is_ignored_without_an_image(sd3):
    _, tp = sd3
    cond, pooled = tp.encode_text(PROMPT, 0.0)
    a, it = tp.denoise_latents(cond, pooled, num_steps=2, cfg_weight=0.0, latent_size=(8, 8),
                               seed=1, denoise=0.5)
    b, _ = tp.denoise_latents(cond, pooled, num_steps=2, cfg_weight=0.0, latent_size=(8, 8),
                              seed=1)
    assert len(it) == 2 and torch.equal(a, b)


@pytest.mark.parametrize("cfg_weight", [0.0, 5.0])
def test_img2img_after_txt2img_is_a_fresh_pipelines(sd3, src, cfg_weight):
    """A txt2img request caches a longer schedule (more sigmas) that the
    img2img request then reuses with the old request's sigmas in its tail:
    the img2img latents must be a fresh pipeline's bit for bit, under the
    scan and in the synced loop."""
    _, tp = sd3
    cond, pooled = tp.encode_text(PROMPT, cfg_weight, NEGATIVE)
    kw = dict(num_steps=4, cfg_weight=cfg_weight, latent_size=(8, 8), seed=3)
    img2img = dict(kw, image_path=src, denoise=0.5)

    tp._scans.clear()
    fresh, _ = tp.denoise_latents(cond, pooled, **img2img)
    tp.denoise_latents(cond, pooled, **kw)  # txt2img: 5 sigmas, cached
    (scan,) = tp._scans.values()
    assert scan.n_sigmas == 5
    again, _ = tp.denoise_latents(cond, pooled, **img2img)
    assert tuple(tp._scans.values()) == (scan,)  # reused, 3 sigmas of 5
    tp.use_scan = False
    try:
        loop, it = tp.denoise_latents(cond, pooled, **img2img)
    finally:
        tp.use_scan = True
    assert len(it) == 2
    assert torch.equal(again, fresh) and torch.equal(loop, fresh)


def test_num_images_img2img_tiles_the_encoded_image(sd3, src):
    """With num_images the encoded latents are tiled and image 0's noise is
    the single run's, so image 0 is the single request's."""
    _, tp = sd3
    cond, pooled = tp.encode_text(PROMPT, 5.0, NEGATIVE)
    kw = dict(num_steps=4, cfg_weight=5.0, latent_size=(8, 8), seed=3, image_path=src,
              denoise=0.5)
    single, _ = tp.denoise_latents(cond, pooled, **kw)
    batch, _ = tp.denoise_latents(cond, pooled, num_images=2, **kw)
    assert tuple(batch.shape) == (2, 8, 8, 16)
    torch.testing.assert_close(batch[:1], single, atol=1e-5, rtol=1e-5)
    assert not torch.allclose(batch[0], batch[1])


def test_missing_encoder_with_no_checkpoint_raises(sd3, src, monkeypatch):
    """No encoder assigned, no local_ckpt, no DIFFUSIONKIT_TPU_CKPT_DIR and
    the hub unavailable: the first img2img request raises (no random
    weights, no fallback)."""
    import huggingface_hub

    def offline(repo, filename, *args, **kwargs):
        raise ConnectionError(f"offline: {repo}/{filename}")

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.delenv("DIFFUSIONKIT_TPU_CKPT_DIR", raising=False)
    monkeypatch.setattr(huggingface_hub, "hf_hub_download", offline)
    _, tp = sd3
    pipe = DiffusionPipeline(load=False, low_memory_mode=False,
                             use_t5=False, a16=False, device="cpu")
    for name in ("clip_l", "clip_g", "mmdit", "decoder", "tokenizer_l", "tokenizer_g"):
        setattr(pipe, name, getattr(tp, name))
    assert pipe.encoder is None and pipe.local_ckpt is None
    with pytest.raises(RuntimeError, match="DIFFUSIONKIT_TPU_CKPT_DIR"):
        pipe.generate_image(PROMPT, num_steps=2, latent_size=(8, 8), seed=1, verbose=False,
                            image_path=src, denoise=0.5)
    assert pipe.encoder is None


def test_encoder_loads_from_local_ckpt_at_the_first_request(sd3, src, tmp_path, monkeypatch):
    """The encoder is loaded lazily through model_io.load_vae_encoder with
    the pipeline's model_version, fp32, local_ckpt and device, once."""
    _, tp = sd3
    calls = []

    def load(model_version, dtype, local_ckpt, device="cuda"):
        calls.append((model_version, dtype, local_ckpt, device))
        return tp.encoder

    monkeypatch.setattr(model_io, "load_vae_encoder", load)
    ckpt = str(tmp_path / "sd3_medium.safetensors")
    pipe = DiffusionPipeline(load=False, low_memory_mode=False,
                             use_t5=False, a16=True, device="cpu", local_ckpt=ckpt)
    got = pipe.encode_image_to_latents(src, seed=3)
    pipe.encode_image_to_latents(src, seed=3)
    assert calls == [(pipe.model_version, torch.float32, ckpt, torch.device("cpu"))]
    torch.testing.assert_close(got, tp.encode_image_to_latents(src, seed=3), rtol=0, atol=0)
