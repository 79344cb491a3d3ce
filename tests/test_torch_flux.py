"""The FLUX path of the PyTorch port against the JAX package: RoPE, the norms,
the attention dispatch, T5, the FLUX MMDiT (float and int4) and the whole
tiny FluxPipeline.

Both sides run on identical weights: JAX initialisers build the trees,
their leaves are redrawn with numpy from fixed seeds, and ``convert.py``
carries them into the port. fp32 on the CPU, where the point is the
algorithm; Pallas kernels run in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionkit_tpu.config import FLUX_DEV as JAX_FLUX_DEV
from diffusionkit_tpu.config import FLUX_SCHNELL as JAX_FLUX
from diffusionkit_tpu.config import T5Config as JaxT5Config
from diffusionkit_tpu.models import apply_mmdit, init_mmdit_params
from diffusionkit_tpu.models.t5 import apply_t5_encoder, init_t5_params
from diffusionkit_tpu.ops import attention as jax_attention
from diffusionkit_tpu.ops import common as jax_common
from diffusionkit_tpu.ops import norms as jax_norms
from diffusionkit_tpu.ops import rope as jax_rope
from diffusionkit_tpu_torch import config as tcfg
from diffusionkit_tpu_torch.convert import clip_from_jax, mmdit_from_jax, t5_from_jax
from diffusionkit_tpu_torch.convert import vae_decoder_from_jax
from diffusionkit_tpu_torch.models.mmdit import MMDiT
from diffusionkit_tpu_torch.ops import rope
from diffusionkit_tpu_torch.ops.attention import flash_eligible
from diffusionkit_tpu_torch.ops.common import unpack_flux
from diffusionkit_tpu_torch.ops.norms import rms_norm
from diffusionkit_tpu_torch.ops.quantized import QuantizedLinear
from diffusionkit_tpu_torch.pipeline import FluxPipeline
from diffusionkit_tpu_torch.tokenizer import CLIPTokenizer, SyntheticT5Tokenizer, tokenize_batch

from test_pipeline import TinyT5Tokenizer, build_flux_pipeline, make_tiny_clip_tokenizer
from test_torch_models import randomize, torch_config

torch.set_num_threads(1)

AXES = (8, 28, 28)  # head dim 64


def test_rope_tables_are_bit_identical():
    jc, js = jax_rope.rope_frequencies((6, 5), 7, AXES)
    tc, ts = rope.rope_frequencies((6, 5), 7, AXES)
    assert tc.dtype == torch.float32 and tuple(tc.shape) == (37, 32)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # Text rows (the first 7) carry the identity rotation.
    assert torch.all(tc[:7] == 1) and torch.all(ts[:7] == 0)
    np.testing.assert_array_equal(rope.rope_head_permutation(64),
                                  jax_rope.rope_head_permutation(64))


@pytest.mark.parametrize("op", ["apply_rope", "rms_norm_rope", "rms_norm"])
def test_rope_and_norms_match_jax(op):
    rs = np.random.RandomState(0)
    x = (rs.randn(2, 37, 3, 64) * 3).astype(np.float32)
    w = (1 + 0.1 * rs.randn(64)).astype(np.float32)
    jc, js = jax_rope.rope_frequencies((6, 5), 7, AXES)
    tc, ts = rope.rope_frequencies((6, 5), 7, AXES)
    if op == "apply_rope":
        want = jax_rope.apply_rope(jnp.asarray(x), jc[:, None], js[:, None])
        got = rope.apply_rope(torch.from_numpy(x), tc[:, None], ts[:, None])
    elif op == "rms_norm_rope":
        want = jax_rope.rms_norm_rope(jnp.asarray(x), jnp.asarray(w), jc[:, None], js[:, None])
        got = rope.rms_norm_rope(torch.from_numpy(x), torch.from_numpy(w), tc[:, None], ts[:, None])
    else:
        want = jax_norms.rms_norm(jnp.asarray(x), jnp.asarray(w))
        got = rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    # fp32 elementwise chains; only the rsqrt and the mean's order differ.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_unpack_flux_matches_jax():
    x = np.random.RandomState(1).randn(2, 12, 64).astype(np.float32)
    want = jax_common.unpack_flux(jnp.asarray(x), (6, 8), 2)
    np.testing.assert_array_equal(unpack_flux(torch.from_numpy(x), (6, 8), 2).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("head_dim", [32, 64, 96, 128, 256, 384, 512])
def test_flash_predicate_is_the_references(head_dim, monkeypatch):
    """The port's auto dispatch sends a head dim to kernel B exactly when the
    reference's sdpa (on its accelerator, above the threshold) sends it to
    its flash kernel (``flash_ok``, diffusionkit_tpu/ops/attention.py)."""
    calls = []

    def record(name):
        def fn(q, *args, **kw):
            calls.append(name)
            return q
        return fn

    monkeypatch.setattr(jax_attention, "_on_tpu", lambda: True)
    monkeypatch.setattr(jax_attention, "flash_attention_bshd", record("flash"))
    monkeypatch.setattr(jax_attention, "flash_attention", record("flash"))
    monkeypatch.setattr(jax_attention, "xla_sdpa", record("xla"))
    q = jnp.zeros((1, jax_attention.FLASH_ATTN_THRESHOLD + 1, 1, head_dim), jnp.bfloat16)
    jax_attention.sdpa(q, q, q, scale=0.1, layout="bshd")
    assert calls == ["flash" if flash_eligible(head_dim) else "xla"]


def tiny_t5_config():
    return JaxT5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=4)


def test_t5_encoder_matches_jax():
    jcfg = tiny_t5_config()
    params = randomize(init_t5_params(jax.random.PRNGKey(0), jcfg), seed=1)
    for ln in (params["layers"]["ln1"], params["layers"]["ln2"], params["final_ln"]):
        ln["weight"] = ln["weight"] + 1.0  # RMSNorm weights around one
    model = t5_from_jax(params, torch_config(jcfg, tcfg.T5Config), device="cpu")
    # 70 tokens: offsets up to 69 reach the logarithmic buckets.
    tokens = np.random.RandomState(2).randint(0, 64, size=(2, 70)).astype(np.int32)
    want = np.asarray(apply_t5_encoder(params, jnp.asarray(tokens), jcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long())
    assert got.shape == (2, 70, 32) and got.dtype == torch.float32
    assert np.abs(want).std() > 0.5
    # fp32 through two layers with a 64-way softmax.
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)


def tiny_flux(dev=False, **kw):
    base = JAX_FLUX_DEV if dev else JAX_FLUX
    return dataclasses.replace(
        base, depth_multimodal=2, depth_unified=2, num_heads=2, hidden_size_override=128,
        rope_axes_dim=AXES, token_level_text_embed_dim=64, pooled_text_embed_dim=32,
        dtype=jnp.float32, **kw)


def flux_inputs(seed=3, guidance=False):
    rs = np.random.RandomState(seed)
    args = [rs.randn(1, 8, 10, 16).astype(np.float32), rs.randn(1, 9, 64).astype(np.float32),
            rs.randn(1, 32).astype(np.float32), np.array([700.0], np.float32)]
    if guidance:
        args.append(np.array([4.0], np.float32))
    return args


def randomize_packed(tree, seed):
    """Redraw packed int4 leaves: random words, and scales/zeros giving
    weights uniform on about +-1/sqrt(K) (so every layer moves the output)."""
    rs = np.random.RandomState(seed)

    def walk(t):
        if isinstance(t, dict) and "q4" in t:
            k = t["q4"].shape[-2] * 8
            shape = np.shape(t["scales"])
            out = dict(t)
            out["q4"] = rs.randint(0, 2**32, size=np.shape(t["q4"]), dtype=np.uint64).astype(np.uint32)
            out["scales"] = (2 / 15 / np.sqrt(k) * rs.uniform(0.5, 1.5, shape)).astype(np.float32)
            out["zeros"] = (-1 / np.sqrt(k) * rs.uniform(0.5, 1.5, shape)).astype(np.float32)
            if t.get("bias") is not None:
                out["bias"] = (0.1 * rs.randn(*np.shape(t["bias"]))).astype(np.float32)
            return out
        if isinstance(t, dict):
            return {key: walk(v) for key, v in t.items()}
        return t

    return walk(tree)


def with_unit_qk_scales(params):
    for blocks in (params["mm_blocks"]["img"], params["mm_blocks"]["txt"], params["uni_blocks"]):
        for name in ("q_scale", "k_scale"):
            blocks["qk_norm"][name] = blocks["qk_norm"][name] + 1.0
    return params


@pytest.mark.parametrize("variant", ["schnell", "dev", "int4", "sd3-rope"])
def test_flux_mmdit_matches_jax(variant, monkeypatch):
    # hidden 128: the JAX side runs its fused Pallas mod_ln in interpret
    # mode (the port takes modulated_layer_norm on the CPU), and g=64
    # divides K for the int4 blocks, which JAX runs through its plain
    # dequant path and the port through int4_matmul_plain.
    monkeypatch.setenv("DIFFUSIONKIT_TPU_FUSED_QUANT", "interpret")
    jcfg = tiny_flux(dev=variant == "dev")
    if variant == "sd3-rope":  # SD3 block order and final block, RoPE, no QK-norm
        jcfg = dataclasses.replace(jcfg, depth_unified=0, use_qk_norm=False,
                                   patchify_via_reshape=False)
    if variant == "int4":
        params = init_mmdit_params(jax.random.PRNGKey(0), jcfg, quantize_bits=4)
        params = randomize_packed(params, seed=4)
        floats = {k: v for k, v in params.items() if k not in ("mm_blocks", "uni_blocks")}
        params.update(randomize(floats, seed=5))
        for blocks in (params["mm_blocks"]["img"], params["mm_blocks"]["txt"], params["uni_blocks"]):
            blocks["qk_norm"] = randomize(blocks["qk_norm"], seed=6)
    else:
        params = randomize(init_mmdit_params(jax.random.PRNGKey(0), jcfg), seed=4)
    if variant != "sd3-rope":
        params = with_unit_qk_scales(params)
    model = mmdit_from_jax(params, torch_config(jcfg, tcfg.MMDiTConfig), device="cpu")
    if variant == "sd3-rope":
        assert len(model.mm_blocks) == 1 and model.mm_final is not None and not model.uni_blocks
    else:
        assert len(model.mm_blocks) == 2 and len(model.uni_blocks) == 2 and model.mm_final is None
        assert isinstance(model.uni_blocks[1].fc2, QuantizedLinear) == (variant == "int4")

    args = flux_inputs(guidance=variant == "dev")
    jargs = list(map(jnp.asarray, args))
    want = np.asarray(apply_mmdit(params, jcfg, *jargs[:4],
                                  guidance=jargs[4] if len(jargs) > 4 else None))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, args)).numpy()
    assert got.shape == (1, 8, 10, 16)
    assert np.abs(want).max() > 0.5  # the weights move the output
    # The fp32 model-level baseline of tests/test_mmdit_parity.py, through
    # two dual-stream and two single-stream blocks.
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_mmdit_guard_names_what_is_missing():
    """Nothing is missing any more: SD3.5-large builds, its block 35 (the
    reference's fp32-upcast block) with every float leaf in fp32, the other
    blocks and the embedders in bf16."""
    with torch.device("meta"):
        model = MMDiT(tcfg.SD3_8b)
    assert len(model.mm_blocks) == 37 and model.mm_final is not None
    for i, block in enumerate(model.mm_blocks):
        want = torch.float32 if i == 35 else torch.bfloat16
        assert {p.dtype for p in block.parameters()} == {want}, i
    assert {p.dtype for p in model.mm_final.parameters()} == {torch.bfloat16}
    assert model.x_embedder.weight.dtype == torch.bfloat16


@pytest.fixture(scope="module")
def flux_pipelines():
    """tests/test_pipeline.py's tiny FLUX pipeline, its weights redrawn, and
    the port's FluxPipeline on the same weights and tokenizers."""
    jp = build_flux_pipeline()
    jp.activation_dtype = jnp.float32  # the VAE in fp32 on both sides
    jp.clip_l = randomize(jp.clip_l, 1)
    jp.t5_params = randomize(jp.t5_params, 2)
    jp.mmdit_params = with_unit_qk_scales(randomize(jp.mmdit_params, 3))
    jp.decoder_params = randomize(jp.decoder_params, 4)
    tp = FluxPipeline(load=False, low_memory_mode=False, a16=False, device="cpu")
    tp.clip_l = clip_from_jax(
        jp.clip_l, torch_config(jp.clip_l_config, tcfg.CLIPTextModelConfig), device="cpu")
    tp.t5 = t5_from_jax(jp.t5_params, torch_config(jp.t5_config, tcfg.T5Config), device="cpu")
    tp.mmdit = mmdit_from_jax(
        jp.mmdit_params, torch_config(jp.mmdit_config, tcfg.MMDiTConfig), device="cpu")
    tp.decoder = vae_decoder_from_jax(
        jp.decoder_params, torch_config(jp.decoder_config, tcfg.VAEDecoderConfig), device="cpu")
    jtok = make_tiny_clip_tokenizer()
    tp.tokenizer_l = CLIPTokenizer({}, jtok.vocab, pad_with_eos=jtok.pad_with_eos)
    tp.tokenizer_l.max_length = jtok.max_length
    tp.t5_tokenizer = TinyT5Tokenizer()  # framework-free host code
    return jp, tp


def test_flux_pipeline_matches_jax(flux_pipelines):
    jp, tp = flux_pipelines
    jc, jpool = jp.encode_text("a dog", cfg_weight=0.0)
    tc, tpool = tp.encode_text("a dog", cfg_weight=0.0)
    assert tuple(tc.shape) == (1, 256, 8) and tuple(tpool.shape) == (1, 8)
    # fp32 two-layer CLIP-L and T5.
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), atol=1e-5, rtol=1e-4)

    kw = dict(num_steps=2, cfg_weight=0.0, latent_size=(8, 8), seed=11)
    jlat, _ = jp.denoise_latents(jc, jpool, **kw)
    tlat, iters = tp.denoise_latents(tc, tpool, **kw)
    jlat = np.asarray(jlat)
    assert len(iters) == 2 and np.abs(jlat).max() > 1.0
    # The fp32 model-level baseline through two Euler steps of the FLUX
    # schedule (sigma 1 -> 0.5 -> 0).
    np.testing.assert_allclose(tlat.numpy(), jlat, atol=1e-3, rtol=1e-3)

    jimg, _ = jp.generate_image("a dog", verbose=False, **kw)
    timg, log = tp.generate_image("a dog", verbose=False, **kw)
    a, b = np.asarray(jimg).astype(int), np.asarray(timg).astype(int)
    assert a.shape == b.shape == (64, 64, 3) and b.std() > 5
    # floor(x * 255) at a level boundary: fp32 noise moves a pixel one level.
    assert np.abs(a - b).max() <= 1
    assert len(log["denoising"]["iter_time"]) == 2


def test_flux_pipeline_is_deterministic(flux_pipelines):
    _, tp = flux_pipelines
    kw = dict(num_steps=1, cfg_weight=0.0, latent_size=(8, 8), verbose=False)
    a, _ = tp.generate_image("a dog", seed=3, **kw)
    b, _ = tp.generate_image("a dog", seed=3, **kw)
    c, _ = tp.generate_image("a cat", seed=3, **kw)
    assert np.array_equal(np.asarray(a), np.asarray(b))
    assert not np.array_equal(np.asarray(a), np.asarray(c))


def test_flux_dev_guidance_moves_the_latents():
    jp = build_flux_pipeline(guidance_embed=True)
    tp = FluxPipeline(load=False, low_memory_mode=False, a16=False, device="cpu")
    tp.mmdit = mmdit_from_jax(randomize(jp.mmdit_params, 5),
                              torch_config(jp.mmdit_config, tcfg.MMDiTConfig), device="cpu")
    cond = torch.from_numpy(np.random.RandomState(6).randn(1, 256, 8).astype(np.float32))
    pooled = torch.from_numpy(np.random.RandomState(7).randn(1, 8).astype(np.float32))
    kw = dict(num_steps=2, cfg_weight=0.0, latent_size=(8, 8), seed=5)
    lat1, _ = tp.denoise_latents(cond, pooled, guidance=1.0, **kw)
    lat2, _ = tp.denoise_latents(cond, pooled, guidance=4.0, **kw)
    lat3, _ = tp.denoise_latents(cond, pooled, **kw)  # 3.5 by default
    assert not torch.allclose(lat1, lat2)
    assert not torch.allclose(lat3, lat2) and not torch.allclose(lat3, lat1)


def test_t5_tokenizer_wrapper_imports_transformers_only_when_built(monkeypatch):
    """The wrapper reads the sentencepiece tokenizer through transformers,
    imported in __init__: a stand-in AutoTokenizer shows the calls."""
    import sys
    import types

    from diffusionkit_tpu_torch.tokenizer import T5TokenizerWrapper

    seen = {}

    class FakeTokenizer:
        eos_token_id = 1

        def __call__(self, text, return_attention_mask, max_length, truncation):
            seen["call"] = (text, return_attention_mask, max_length, truncation)
            return {"input_ids": [5, 6, 1]}

    class AutoTokenizer:
        @staticmethod
        def from_pretrained(path, legacy, model_max_length):
            seen["load"] = (path, legacy, model_max_length)
            return FakeTokenizer()

    monkeypatch.setitem(sys.modules, "transformers", types.SimpleNamespace(AutoTokenizer=AutoTokenizer))
    tok = T5TokenizerWrapper("/models/t5", max_length=256)
    assert seen["load"] == ("/models/t5", False, 256)
    assert tok.tokenize("a dog") == [5, 6, 1] and seen["call"] == ("a dog", False, 256, True)
    assert (tok.eos_token, tok.pad_token, tok.pad_with_eos) == (1, 0, False)


def test_synthetic_t5_tokenizer():
    tok = SyntheticT5Tokenizer()
    ids = tok.tokenize("a red fox")
    assert ids[-1] == tok.eos_token == 1 and len(ids) == 10
    assert all(3 <= i < 32128 for i in ids[:-1]) and ids == tok.tokenize("a red fox")
    long = tok.tokenize("x" * 1000)
    assert len(long) == 256 and long[-1] == 1
    batch = tokenize_batch(tok, "a red fox")
    assert batch.shape == (1, 256) and batch[0, 10:].max() == 0  # padded with 0
