"""MMDiT, CLIP and VAE decoder of the PyTorch port against the JAX package.

Both sides run on identical weights: the JAX initialisers build the tree,
its leaves are redrawn with numpy from a fixed seed at variance-preserving
scales (so every layer moves the output), and ``convert.py`` carries the
tree into the port's modules. fp32 on the CPU, where the point is the
algorithm.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionkit_tpu.config import CLIPTextModelConfig as JaxCLIPConfig
from diffusionkit_tpu.config import MMDiTConfig as JaxMMDiTConfig
from diffusionkit_tpu.config import VAEDecoderConfig as JaxVAEDecoderConfig
from diffusionkit_tpu.models import (
    apply_clip,
    apply_mmdit,
    apply_vae_decoder,
    init_clip_params,
    init_mmdit_params,
    init_vae_decoder_params,
)
from diffusionkit_tpu_torch import config as tcfg
from diffusionkit_tpu_torch.convert import clip_from_jax, mmdit_from_jax, vae_decoder_from_jax
from diffusionkit_tpu_torch.models import init_clip, init_mmdit, init_vae_decoder

torch.set_num_threads(1)


def randomize(tree, seed: int):
    """Redraw every leaf with numpy: weight matrices ~ N(0, 1/fan_in),
    conv kernels ~ N(0, 1/(kh*kw*cin)), vectors and tables ~ N(0, 0.1^2)."""
    rs = np.random.RandomState(seed)

    def draw(a):
        a = np.asarray(a)
        if a.ndim == 2 and a.shape[0] > 1:
            return (rs.randn(*a.shape) / np.sqrt(a.shape[0])).astype(np.float32)
        if a.ndim == 4:
            return (rs.randn(*a.shape) / np.sqrt(np.prod(a.shape[:3]))).astype(np.float32)
        if a.ndim == 3:  # stacked per-block matrices (n, in, out)
            return (rs.randn(*a.shape) / np.sqrt(a.shape[1])).astype(np.float32)
        return (rs.randn(*a.shape) * 0.1).astype(np.float32)

    return jax.tree.map(draw, tree)


def torch_config(jcfg, cls):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    if "dtype" in fields:
        fields["dtype"] = torch.float32
    if "pos_embed_type" in fields:
        fields["pos_embed_type"] = tcfg.PositionalEncoding[fields["pos_embed_type"].name]
    return cls(**fields)


TINY_MMDIT = JaxMMDiTConfig(
    depth_multimodal=2, num_heads=2, hidden_size_override=128,
    max_latent_resolution=16, pooled_text_embed_dim=32, dtype=jnp.float32,
)


def test_mmdit_matches_jax_with_pallas_mod_ln(monkeypatch):
    # The JAX side runs its fused Pallas mod_ln (hidden 128 is eligible) in
    # interpret mode; on the CPU the port takes modulated_layer_norm.
    monkeypatch.setenv("DIFFUSIONKIT_TPU_FUSED_QUANT", "interpret")
    jcfg = TINY_MMDIT
    params = randomize(init_mmdit_params(jax.random.PRNGKey(0), jcfg), seed=1)
    model = mmdit_from_jax(params, torch_config(jcfg, tcfg.MMDiTConfig), device="cpu")
    assert len(model.mm_blocks) == 1

    rs = np.random.RandomState(2)
    latent = rs.randn(2, 8, 8, 16).astype(np.float32)
    ctx = rs.randn(2, 7, 4096).astype(np.float32)
    pooled = rs.randn(2, 32).astype(np.float32)
    t = np.array([500.0, 250.0], np.float32)

    want = np.asarray(apply_mmdit(params, jcfg, *map(jnp.asarray, (latent, ctx, pooled, t))))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (latent, ctx, pooled, t))).numpy()
    assert got.shape == (2, 8, 8, 16)
    assert np.abs(want).max() > 0.5  # the weights move the output
    # The baseline of tests/test_mmdit_parity.py: fp32 through two blocks.
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("act,proj", [("quick_gelu", None), ("gelu", 16)])
def test_clip_matches_jax(act, proj):
    jcfg = JaxCLIPConfig(num_layers=3, model_dims=32, num_heads=2, max_length=16,
                         vocab_size=64, projection_dim=proj, hidden_act=act)
    params = randomize(init_clip_params(jax.random.PRNGKey(3), jcfg), seed=4)
    model = clip_from_jax(params, torch_config(jcfg, tcfg.CLIPTextModelConfig), device="cpu")

    rs = np.random.RandomState(5)
    tokens = rs.randint(1, 62, size=(2, 16)).astype(np.int32)
    tokens[0, 9] = tokens[1, 15] = 63  # EOS = the largest id, pooled there
    want = apply_clip(params, jnp.asarray(tokens), jcfg)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long())
    assert len(got.hidden_states) == 3
    # fp32 through three pre-LN layers.
    for g, w in [(got.hidden_states[-2], want.hidden_states[-2]),
                 (got.last_hidden_state, want.last_hidden_state),
                 (got.pooled_output, want.pooled_output)]:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-4)


def test_vae_decoder_matches_jax():
    # (8, 8, 16, 16) reaches a 16 -> 8 channel change (a shortcut
    # projection); the 8x8 latent keeps the mid-block attention at 64
    # positions, where both sides take the materialised-score path.
    jcfg = JaxVAEDecoderConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=2,
                               resnet_groups=4)
    params = randomize(init_vae_decoder_params(jax.random.PRNGKey(6), jcfg), seed=7)
    model = vae_decoder_from_jax(params, torch_config(jcfg, tcfg.VAEDecoderConfig), device="cpu")
    assert model.up_blocks[1].resnets[0].conv_shortcut is not None

    latent = np.random.RandomState(8).randn(1, 8, 8, 16).astype(np.float32)
    want = np.asarray(apply_vae_decoder(params, jnp.asarray(latent), jcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(latent)).numpy()
    assert got.shape == (1, 64, 64, 3)
    assert want.std() > 0.1
    # fp32 through ~20 convolutions and GroupNorms.
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_convert_is_strict():
    params = init_clip_params(jax.random.PRNGKey(0), JaxCLIPConfig(
        num_layers=1, model_dims=8, num_heads=2, max_length=4, vocab_size=8))
    params = dict(params)
    del params["final_layer_norm"]
    with pytest.raises(RuntimeError, match="final_layer_norm"):
        clip_from_jax(params, tcfg.CLIPTextModelConfig(
            num_layers=1, model_dims=8, num_heads=2, max_length=4, vocab_size=8), device="cpu")


def test_random_initialisers_are_seeded():
    cfg = torch_config(TINY_MMDIT, tcfg.MMDiTConfig)
    a = init_mmdit(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = init_mmdit(cfg, torch.Generator().manual_seed(0), device="cpu")
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
    assert a.mm_blocks[0].img.q.bias.abs().sum() == 0
    clip = init_clip(tcfg.CLIPTextModelConfig(num_layers=1, model_dims=8, num_heads=2,
                                              max_length=4, vocab_size=8),
                     torch.Generator().manual_seed(0), dtype=torch.bfloat16, device="cpu")
    assert clip.final_layer_norm.weight.dtype == torch.bfloat16
    assert torch.all(clip.final_layer_norm.weight == 1)
    vae = init_vae_decoder(tcfg.VAEDecoderConfig(block_out_channels=(8, 8), layers_per_block=1,
                                                 resnet_groups=4),
                           torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        img = vae(torch.randn(1, 4, 4, 16, generator=torch.Generator().manual_seed(1)))
    assert img.shape == (1, 8, 8, 3) and torch.isfinite(img).all() and img.std() > 0.05
