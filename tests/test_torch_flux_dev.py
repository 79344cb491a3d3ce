"""FLUX.1-dev quantized at load, the whole tiny pipeline, against the JAX
package's ``FluxPipeline`` on the CPU.

The pipelines are tests/test_pipeline.py's tiny FLUX.1-dev (its CLIP-L, T5
and VAE decoder, every weight redrawn) with a wider MMDiT (hidden 256, two
heads of 128, the guidance embedder): wide enough that GPTQ packs the block
linears, the ``ada`` projections and the t / guidance embedders (both dims
at least ``MIN_DIM``), and that kernel E takes every packed shape. Both
sides start from the same float weights; the JAX side quantizes them as
its ``FluxPipeline.load_mmdit`` does (``gptq_quantize_mmdit`` with the
mode's ``with_wscale`` and overrides, then ``add_wscale_tree`` for w4a8),
the port's through its ``mmdit`` setter (``quantize_mmdit=mode``). Each
runs its whole pipeline: the T5 at FLUX.1-dev's 512 tokens, guidance 3.5
into the guidance embedder, two steps, the decoder. The JAX w4a8 modes run
under its TPU dispatch in interpret mode (tests/test_torch_w4a8.py's
``jax_tpu_dispatch``), so E's modes run on both sides.

Tolerances: the two GPTQs are not bit for bit (fp32 Cholesky and solves in
another order), so the port's quantized latents are held to the JAX
pipeline's by error, as tests/test_torch_gptq.py holds the trees: the
port's distance from its float pipeline's latents at most 1.1x the JAX
pipeline's from its own. On the JAX GPTQ tree itself (carried over by
``convert.mmdit_from_jax``) the port's pipeline gives the JAX latents:
int4 as tests/test_torch_flux.py holds the float pipeline (1e-3), w4a8 up
to int8 flips (``assert_close_up_to_flips`` at the whole model's
``q90=3e-3``); and the images within one level for int4.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionkit_tpu.config import MMDiTConfig as JaxMMDiTConfig
from diffusionkit_tpu.config import PositionalEncoding as JaxPE
from diffusionkit_tpu.models import init_mmdit_params
from diffusionkit_tpu.ops import gptq as jg
from diffusionkit_tpu.ops import quantized as jq
from diffusionkit_tpu.ops import w4a8_matmul as jw
from diffusionkit_tpu_torch import config as tcfg
from diffusionkit_tpu_torch.convert import clip_from_jax, mmdit_from_jax, t5_from_jax
from diffusionkit_tpu_torch.convert import vae_decoder_from_jax
from diffusionkit_tpu_torch.pipeline import FluxPipeline
from diffusionkit_tpu_torch.tokenizer import CLIPTokenizer

from test_pipeline import TinyT5Tokenizer, build_flux_pipeline, make_tiny_clip_tokenizer
from test_torch_flux import with_unit_qk_scales
from test_torch_gptq import kinds
from test_torch_models import randomize, torch_config
from test_torch_w4a8 import assert_close_up_to_flips
from test_torch_w4a8 import jax_tpu_dispatch  # noqa: F401 (a fixture)

torch.set_num_threads(2)

WIDE_DEV = JaxMMDiTConfig(depth_multimodal=1, depth_unified=2, num_heads=2,
                          hidden_size_override=256, patchify_via_reshape=True,
                          pos_embed_type=JaxPE.PreSDPARope, rope_axes_dim=(16, 56, 56),
                          pooled_text_embed_dim=8, token_level_text_embed_dim=8,
                          use_qk_norm=True, guidance_embed=True, dtype=jnp.float32)
MODES = ["w4a8", "int4", "w4a8-mixed"]
REQUEST = dict(num_steps=2, cfg_weight=0.0, latent_size=(8, 8), seed=11)
PROMPT = "a dog"


@pytest.fixture(scope="module")
def dev_pipelines():
    """The JAX tiny FLUX.1-dev pipeline (wide MMDiT, float) and the port's
    small models on its weights: (jax pipeline, float params, port models)."""
    jp = build_flux_pipeline(guidance_embed=True)
    jp.activation_dtype = jnp.float32
    jp.clip_l = randomize(jp.clip_l, 1)
    jp.t5_params = randomize(jp.t5_params, 2)
    jp.decoder_params = randomize(jp.decoder_params, 4)
    params = with_unit_qk_scales(randomize(init_mmdit_params(jax.random.PRNGKey(0), WIDE_DEV),
                                           seed=3))
    jp.mmdit_params, jp.mmdit_config = params, WIDE_DEV
    jtok = make_tiny_clip_tokenizer()
    tokenizer_l = CLIPTokenizer({}, jtok.vocab, pad_with_eos=jtok.pad_with_eos)
    tokenizer_l.max_length = jtok.max_length
    small = {
        "clip_l": clip_from_jax(jp.clip_l, torch_config(jp.clip_l_config,
                                                        tcfg.CLIPTextModelConfig), device="cpu"),
        "t5": t5_from_jax(jp.t5_params, torch_config(jp.t5_config, tcfg.T5Config),
                          device="cpu"),
        "decoder": vae_decoder_from_jax(jp.decoder_params, torch_config(
            jp.decoder_config, tcfg.VAEDecoderConfig), device="cpu"),
        "tokenizer_l": tokenizer_l, "t5_tokenizer": TinyT5Tokenizer()}
    return jp, params, small


def port_pipeline(small, mode=False):
    pipe = FluxPipeline(load=False, low_memory_mode=False, a16=False, device="cpu",
                        model_version=tcfg.FLUX_DEV_VERSION, quantize_mmdit=mode,
                        quantize_group_size=32)
    for name, value in small.items():
        setattr(pipe, name, value)
    return pipe


def port_run(pipe):
    """The whole pipeline's request: latents (encode, denoise) and the image."""
    cond, pooled = pipe.encode_text(PROMPT, REQUEST["cfg_weight"])
    assert tuple(cond.shape) == (1, 512, 8)  # FLUX.1-dev's T5 length
    latents, _ = pipe.denoise_latents(cond, pooled, **REQUEST)
    image = pipe.decode_latents_to_u8(latents).numpy()[0]
    return latents.numpy(), image.astype(np.float32)


def jax_run(jp, params):
    jp = copy.copy(jp)
    jp.mmdit_params = params
    cond, pooled = jp.encode_text(PROMPT, REQUEST["cfg_weight"])
    assert cond.shape == (1, 512, 8)
    latents, _ = jp.denoise_latents(cond, pooled, **REQUEST)
    image, _ = jp.generate_image(PROMPT, verbose=False, **REQUEST)
    return np.asarray(latents), np.asarray(image, np.float32)


def jax_quantized(params, mode):
    """The JAX ``FluxPipeline.load_mmdit``'s quantize-at-load of a float
    tree for ``mode`` (GPTQ at group 32, the -mixed overrides, w4a8's
    wscale)."""
    host = jax.tree.map(lambda a: None if a is None else np.asarray(a), params,
                        is_leaf=lambda a: a is None)
    base, mixed = mode.split("-")[0], mode.endswith("-mixed")
    tree = jg.gptq_quantize_mmdit(host, WIDE_DEV, bits=4, group_size=32,
                                  overrides=jq.MIXED_OVERRIDES if mixed else None,
                                  with_wscale=base == "w4a8")
    return jw.add_wscale_tree(tree) if base == "w4a8" else tree


@pytest.mark.parametrize("mode", MODES)
def test_flux_dev_quantized_pipeline_matches_jax(dev_pipelines, mode, request, monkeypatch):
    jp, params, small = dev_pipelines
    float_pipe = port_pipeline(small)
    float_pipe.mmdit = mmdit_from_jax(params, torch_config(WIDE_DEV, tcfg.MMDiTConfig),
                                      device="cpu")
    float_lat, _ = port_run(float_pipe)
    jax_float_lat, _ = jax_run(jp, params)
    np.testing.assert_allclose(float_lat, jax_float_lat, atol=1e-3, rtol=1e-3)

    pipe = port_pipeline(small, mode)
    pipe.mmdit = mmdit_from_jax(params, torch_config(WIDE_DEV, tcfg.MMDiTConfig), device="cpu")
    assert pipe.quantizer["name"] == "gptq"
    jax_tree = jax_quantized(params, mode)
    carried = mmdit_from_jax(jax_tree, torch_config(WIDE_DEV, tcfg.MMDiTConfig), device="cpu")
    form = kinds(pipe.mmdit)
    assert form == kinds(carried)
    bulk = "w4a8" if mode.startswith("w4a8") else 4
    assert form["mm_blocks.0.img.q"] == form["uni_blocks.0.fc1"] == bulk
    if mode.endswith("-mixed"):
        # The guidance embedder stays float beside the t / y embedders.
        assert form["guidance_embedder.fc1"] is form["guidance_embedder.fc2"] is None
        assert form["t_embedder.fc1"] is None and form["mm_blocks.0.img.ada"] == 8
    else:
        assert form["guidance_embedder.fc1"] == form["guidance_embedder.fc2"] == bulk

    got_lat, got_img = port_run(pipe)
    same_tree = port_pipeline(small)
    same_tree.mmdit = carried
    tree_lat, tree_img = port_run(same_tree)
    if mode.startswith("w4a8"):
        dispatch = request.getfixturevalue("jax_tpu_dispatch")
        if mode.endswith("-mixed"):  # the int8 ada under the TPU dispatch
            from diffusionkit_tpu.ops import int4_matmul as ji

            int8_matmul = ji.int8_matmul
            monkeypatch.setattr(ji, "int8_matmul",
                                lambda *a, **kw: int8_matmul(*a, **{**kw, "interpret": True}))
    jax_lat, jax_img = jax_run(jp, jax_tree)
    if mode.startswith("w4a8"):
        assert {"gelu_quant", "grouped_xs", "norm_rope"} <= set(dispatch)
        assert_close_up_to_flips(tree_lat, jax_lat, q90=3e-3)
    else:
        np.testing.assert_allclose(tree_lat, jax_lat, atol=1e-3, rtol=1e-3)
        assert np.abs(tree_img - jax_img).max() <= 1
    err_port = float(np.linalg.norm(got_lat - float_lat))
    err_jax = float(np.linalg.norm(jax_lat - jax_float_lat))
    assert 0 < err_port <= 1.1 * err_jax, (err_port, err_jax)
    assert got_img.shape == (64, 64, 3) and got_img.std() > 0


def test_flux_dev_pipeline_passes_guidance_to_the_embedder(dev_pipelines, monkeypatch):
    """FLUX.1-dev's guidance (3.5 unless given) reaches the guidance
    embedder on the port's quantized path, as the float one: another value
    moves the latents."""
    _, params, small = dev_pipelines
    pipe = port_pipeline(small, "w4a8")
    pipe.mmdit = mmdit_from_jax(params, torch_config(WIDE_DEV, tcfg.MMDiTConfig), device="cpu")
    seen = []
    embedder = pipe.mmdit.guidance_embedder
    monkeypatch.setattr(embedder, "forward", lambda x, f=embedder.forward: (seen.append(x),
                                                                            f(x))[1])
    cond, pooled = pipe.encode_text(PROMPT, 0.0)
    a, _ = pipe.denoise_latents(cond, pooled, **REQUEST)
    b, _ = pipe.denoise_latents(cond, pooled, guidance=5.0, **REQUEST)
    assert len(seen) == 2 * REQUEST["num_steps"]
    assert not torch.equal(a, b)


@pytest.mark.parametrize("name", ["guidance_embedder", "t_embedder"])
def test_flux_dev_config_keeps_the_embedders_float_under_mixed(name):
    """The port's ``MIXED_OVERRIDES`` is the reference's, the guidance
    embedder among its float entries."""
    from diffusionkit_tpu_torch.ops.quantized import MIXED_OVERRIDES

    assert MIXED_OVERRIDES == jq.MIXED_OVERRIDES
    assert MIXED_OVERRIDES[name] is None
