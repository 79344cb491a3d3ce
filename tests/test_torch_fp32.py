"""fp32 weights (the reference's ``w16=False``, with ``a16=False``) and the
public names the port shares with the JAX package.

Kernels C and #13 on fp32 x route M <= 16 to the fp32 split-K GEMV
(``csrc/gemv_sm90.cu``) and M > 16 to the 3xTF32 loop: the symbol, the
split and the counters are held here through a stand-in library on
``meta`` tensors (no card). The tiny SD3 int8 and FLUX.1-schnell int4
pipelines in fp32 (the configurations of chip_smoke.py's paths y and z)
run against the JAX pipelines on the same weights; ``max_denoise``,
``T5TokenizerWrapper.decode``, ``utils.memory_snapshot_gb`` and
``utils.tree_num_params`` against the JAX package's.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionkit_tpu import utils as jax_utils
from diffusionkit_tpu.config import MMDiTConfig as JaxMMDiTConfig
from diffusionkit_tpu.config import VAEDecoderConfig as JaxVAEDecoderConfig
from diffusionkit_tpu.config import CLIPTextModelConfig as JaxCLIPConfig
from diffusionkit_tpu.models import init_clip_params, init_mmdit_params, init_vae_decoder_params
from diffusionkit_tpu.ops import quantized as jq
from diffusionkit_tpu.pipeline import DiffusionPipeline as JaxPipeline
from diffusionkit_tpu.tokenizer import CLIPTokenizer as JaxCLIPTokenizer
from diffusionkit_tpu_torch import config as tcfg
from diffusionkit_tpu_torch import utils
from diffusionkit_tpu_torch.convert import (
    clip_from_jax,
    mmdit_from_jax,
    t5_from_jax,
    vae_decoder_from_jax,
)
from diffusionkit_tpu_torch.ops import int4_matmul as im
from diffusionkit_tpu_torch.ops import kernels
from diffusionkit_tpu_torch.ops.quantized import QuantizedLinear
from diffusionkit_tpu_torch.pipeline import DiffusionPipeline, FluxPipeline
from diffusionkit_tpu_torch.tokenizer import CLIPTokenizer

from test_pipeline import TinyT5Tokenizer, build_flux_pipeline, make_tiny_clip_tokenizer
from test_torch_flux import randomize_packed, with_unit_qk_scales
from test_torch_models import randomize, torch_config
from test_torch_pipeline import tiny_vocab

PROMPT, NEGATIVE, SEED = "a photo of a cat", "blurry", 42
FP32 = dict(w16=False, a16=False)


# -- C and #13 on fp32 x: the route -------------------------------------------


class StandIn:
    """A kernel library that records each call and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


COUNTERS = ("launches", "gemv_launches", "f32_launches", "f32_gemv_launches", "f32out_launches")


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m", list(range(1, 18)))
def test_fp32_small_m_launches_the_gemv(bits, m, monkeypatch):
    """fp32 x at M = 1..16 launches C's or #13's fp32 GEMV entry with
    ``gemv_splits``' split and a workspace, counted in ``gemv_launches``,
    ``f32_launches`` and ``f32_gemv_launches``; at 17 rows the 3xTF32 loop,
    with no split, counted in ``f32_launches`` only. Every call's arguments
    match the entry's ctypes signature."""
    library = StandIn()
    monkeypatch.setattr(kernels, "library", lambda: library)
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(im, "CARD", "meta")
    k, n, group = 3072, 9216, 64
    meta = torch.device("meta")
    if bits == 4:
        fn, qw = im.int4_matmul, torch.empty(k // 8, n, dtype=torch.int32, device=meta)
    else:
        fn, qw = im.int8_matmul, torch.empty(k, n, dtype=torch.uint8, device=meta)
    scales = torch.empty(k // group, n, device=meta)
    zeros = torch.empty(k // group, n, device=meta)
    before = [getattr(fn, c) for c in COUNTERS]
    y = fn(torch.empty(m, k, device=meta), qw, scales, zeros)
    grew = [getattr(fn, c) - b for c, b in zip(COUNTERS, before)]
    gemv = m <= 16
    assert y.dtype == torch.float32 and tuple(y.shape) == (m, n)
    assert grew == [1, int(gemv), 1, int(gemv), 0]
    [(symbol, args)] = library.calls
    name = fn.__name__
    assert symbol == (f"dk_{name}_f32" if gemv else f"dk_{name}_sm90_f32")
    assert len(args) == len(kernels._SIGNATURES[symbol])
    assert args[5:10] == (m, n, k, group, k)
    if gemv:
        assert args[10] == im.gemv_splits(k, n, group) == 3


# -- paths y and z at a tiny size against the JAX pipelines -------------------


def sd3_fp32_int8_pipelines():
    """A tiny SD3 (hidden 256, so the block linears pack) in both packages
    under ``w16=False, a16=False``: the port's DiffusionPipeline(
    quantize_mmdit="int8") converts the float fp32 MMDiT at group 32 on
    assignment; the JAX pipeline gets quantize_tree's int8 tree of the same
    weights."""
    jp = JaxPipeline(load=False, low_memory_mode=False, use_t5=False, shift=3.0, **FP32)
    key = jax.random.PRNGKey(0)
    clip_l = JaxCLIPConfig(num_layers=2, model_dims=8, num_heads=2, max_length=16,
                           vocab_size=64, projection_dim=None, hidden_act="quick_gelu")
    clip_g = JaxCLIPConfig(num_layers=2, model_dims=8, num_heads=2, max_length=16,
                           vocab_size=64, projection_dim=8, hidden_act="gelu")
    mmdit = JaxMMDiTConfig(depth_multimodal=2, num_heads=4, hidden_size_override=256,
                           max_latent_resolution=16, pooled_text_embed_dim=16,
                           dtype=jnp.float32)
    vae = JaxVAEDecoderConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=2,
                              resnet_groups=4)
    floats = randomize(init_mmdit_params(key, mmdit), 3)
    jp.clip_l, jp.clip_l_config = randomize(init_clip_params(key, clip_l), 1), clip_l
    jp.clip_g, jp.clip_g_config = randomize(init_clip_params(key, clip_g), 2), clip_g
    jp.mmdit_params = jq.quantize_tree(floats, bits=8, group_size=32)
    jp.mmdit_config = mmdit
    jp.decoder_config = vae
    jp.decoder_params = randomize(init_vae_decoder_params(key, vae), 4)
    tp = DiffusionPipeline(load=False, low_memory_mode=False, shift=3.0, use_t5=False,
                           device="cpu", quantize_mmdit="int8", quantize_group_size=32, **FP32)
    tp.clip_l = clip_from_jax(jp.clip_l, torch_config(clip_l, tcfg.CLIPTextModelConfig),
                              device="cpu")
    tp.clip_g = clip_from_jax(jp.clip_g, torch_config(clip_g, tcfg.CLIPTextModelConfig),
                              device="cpu")
    tp.mmdit = mmdit_from_jax(floats, torch_config(mmdit, tcfg.MMDiTConfig), device="cpu")
    tp.decoder = vae_decoder_from_jax(jp.decoder_params,
                                      torch_config(vae, tcfg.VAEDecoderConfig), device="cpu")
    for pipe, cls in ((jp, JaxCLIPTokenizer), (tp, CLIPTokenizer)):
        for name, pad in (("tokenizer_l", True), ("tokenizer_g", False)):
            tok = cls({}, tiny_vocab(), pad_with_eos=pad)
            tok.max_length = 16
            setattr(pipe, name, tok)
    want = mmdit_from_jax(jp.mmdit_params, torch_config(mmdit, tcfg.MMDiTConfig), device="cpu")
    return jp, tp, want


def flux_fp32_int4_pipelines():
    """tests/test_pipeline.py's tiny FLUX.1-schnell pipeline with its MMDiT
    drawn packed (int4 block linears at group 64, hidden 128) and every
    float leaf in fp32, in both packages; the port's FluxPipeline under
    ``w16=False, a16=False`` on the same weights and tokenizers."""
    jp = build_flux_pipeline()
    jp.activation_dtype = jnp.float32  # a16=False: the VAE in fp32
    cfg = dataclasses.replace(jp.mmdit_config, hidden_size_override=128, rope_axes_dim=(8, 28, 28))
    params = randomize_packed(init_mmdit_params(jax.random.PRNGKey(0), cfg, quantize_bits=4), 4)
    floats = {k: v for k, v in params.items() if k not in ("mm_blocks", "uni_blocks")}
    params.update(randomize(floats, 5))
    for blocks in (params["mm_blocks"]["img"], params["mm_blocks"]["txt"], params["uni_blocks"]):
        blocks["qk_norm"] = randomize(blocks["qk_norm"], 6)
    jp.mmdit_params, jp.mmdit_config = with_unit_qk_scales(params), cfg
    jp.clip_l = randomize(jp.clip_l, 1)
    jp.t5_params = randomize(jp.t5_params, 2)
    jp.decoder_params = randomize(jp.decoder_params, 3)
    tp = FluxPipeline(load=False, low_memory_mode=False, device="cpu", **FP32)
    tp.clip_l = clip_from_jax(
        jp.clip_l, torch_config(jp.clip_l_config, tcfg.CLIPTextModelConfig), device="cpu")
    tp.t5 = t5_from_jax(jp.t5_params, torch_config(jp.t5_config, tcfg.T5Config), device="cpu")
    tp.mmdit = mmdit_from_jax(jp.mmdit_params, torch_config(cfg, tcfg.MMDiTConfig), device="cpu")
    tp.decoder = vae_decoder_from_jax(
        jp.decoder_params, torch_config(jp.decoder_config, tcfg.VAEDecoderConfig), device="cpu")
    jtok = make_tiny_clip_tokenizer()
    tp.tokenizer_l = CLIPTokenizer({}, jtok.vocab, pad_with_eos=jtok.pad_with_eos)
    tp.tokenizer_l.max_length = jtok.max_length
    tp.t5_tokenizer = TinyT5Tokenizer()
    return jp, tp


@pytest.mark.parametrize("path", ["sd3-int8", "flux-int4"])
def test_fp32_quantized_pipeline_matches_jax(path, monkeypatch):
    """Paths y and z's configurations at a tiny size: every float leaf in
    fp32, the packed block linears (int8 converted at group 32 on SD3,
    int4 drawn packed at group 64 on FLUX), the VAE in fp32. The latents of
    two Euler steps within atol 1e-3, rtol 1e-3 of the JAX pipeline's (the
    fp32 model-level baseline of tests/test_mmdit_parity.py through two
    steps; SD3's CFG 5 scales the difference of two outputs by 5), the
    images at most one level apart (floor(x * 255) at a level boundary)."""
    monkeypatch.setenv("DIFFUSIONKIT_TPU_FUSED_QUANT", "interpret")
    torch.manual_seed(0)
    if path == "sd3-int8":
        jp, tp, want = sd3_fp32_int8_pipelines()
        got = tp.mmdit.state_dict()
        assert set(got) == set(want.state_dict())
        assert all(torch.equal(v, want.state_dict()[k]) for k, v in got.items())
        cfg, neg = 5.0, dict(negative_text=NEGATIVE)
        packed = tp.mmdit.mm_blocks[0].img.fc1
        assert isinstance(packed, QuantizedLinear) and packed.bits == 8
    else:
        jp, tp = flux_fp32_int4_pipelines()
        cfg, neg = 0.0, {}
        packed = tp.mmdit.uni_blocks[0].fc2
        assert isinstance(packed, QuantizedLinear) and packed.bits == 4
    assert packed.scales.dtype == torch.float32
    floats = {t.dtype for t in tp.mmdit.state_dict().values() if t.is_floating_point()}
    assert floats == {torch.float32}
    assert tp.dtype == tp.activation_dtype == torch.float32

    jc, jpool = jp.encode_text(PROMPT, cfg, *neg.values())
    tc, tpool = tp.encode_text(PROMPT, cfg, *neg.values())
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=1e-4)
    kw = dict(num_steps=2, cfg_weight=cfg, latent_size=(8, 8), seed=SEED)
    jlat, _ = jp.denoise_latents(jc, jpool, **kw)
    tlat, _ = tp.denoise_latents(tc, tpool, **kw)
    jlat = np.asarray(jlat)
    assert tlat.dtype == torch.float32 and np.abs(jlat).max() > 1.0
    np.testing.assert_allclose(tlat.numpy(), jlat, atol=1e-3, rtol=1e-3)

    jimg, _ = jp.generate_image(PROMPT, verbose=False, **neg, **kw)
    timg, _ = tp.generate_image(PROMPT, verbose=False, **neg, **kw)
    a, b = np.asarray(jimg).astype(int), np.asarray(timg).astype(int)
    assert a.shape == b.shape == (64, 64, 3) and b.std() > 5
    assert np.abs(a - b).max() <= 1


# -- the public names ---------------------------------------------------------


@pytest.mark.parametrize("steps,start", [(50, 0), (4, 0), (50, 20), (4, 2), (1, 0)])
def test_max_denoise_matches_the_sampler_and_jax(steps, start):
    """``DiffusionPipeline.max_denoise(sigmas)`` is its sampler's, as the
    JAX pipeline's is, on a full schedule and an img2img tail of one."""
    tp = DiffusionPipeline(load=False, low_memory_mode=False, device="cpu", use_t5=False)
    jp = JaxPipeline(load=False, low_memory_mode=False, use_t5=False)
    sigmas = tp.get_sigmas(steps)[start:]
    np.testing.assert_array_equal(sigmas, np.asarray(jp.get_sigmas(steps))[start:])
    got = tp.max_denoise(sigmas)
    assert got == tp.sampler.max_denoise(sigmas) == jp.max_denoise(sigmas)
    assert got == (start == 0)


@pytest.fixture
def t5_tokenizer_dir(tmp_path):
    """A local word-level sentencepiece-style tokenizer (no hub), as
    tests/test_tokenizer_parity.py builds one."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    words = ["<pad>", "</s>", "<unk>", "▁the", "▁cat", "▁in", "▁a", "▁hat"]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.post_processor = processors.TemplateProcessing(single="$A </s>",
                                                       special_tokens=[("</s>", 1)])
    tok.save(str(tmp_path / "tokenizer.json"))
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "unk_token": "<unk>",
        "eos_token": "</s>", "pad_token": "<pad>", "model_max_length": 32}))
    return tmp_path


@pytest.mark.parametrize("with_sep", [True, False])
def test_t5_decode_matches_jax(t5_tokenizer_dir, with_sep):
    from diffusionkit_tpu.tokenizer import T5TokenizerWrapper as JaxT5Tokenizer
    from diffusionkit_tpu_torch.tokenizer import T5TokenizerWrapper

    port = T5TokenizerWrapper(str(t5_tokenizer_dir), max_length=32)
    ref = JaxT5Tokenizer(str(t5_tokenizer_dir), max_length=32)
    for text in ("the cat in a hat", "a hat", "the dog"):
        ids = port.tokenize(text)
        assert ids == list(ref.tokenize(text)) and ids[-1] == 1
        assert port.decode(ids, with_sep=with_sep) == ref.decode(ids, with_sep=with_sep)
    want = " the cat in a hat</s>" if with_sep else "thecatinahat</s>"
    assert port.decode(port.tokenize("the cat in a hat"), with_sep) == want


def test_memory_snapshot_gb_has_jaxs_keys_and_none_on_the_cpu():
    got = utils.memory_snapshot_gb("cpu")
    assert got == {"peak_memory": None, "active_memory": None}
    assert set(got) == set(jax_utils.memory_snapshot_gb())


def test_memory_snapshot_gb_rounds_to_three_decimals(monkeypatch):
    monkeypatch.setattr(utils, "device_memory_stats",
                        lambda device=None: {"peak_memory": 3 * 2**30 + 2**21,
                                             "active_memory": None})
    assert utils.memory_snapshot_gb("cuda") == {"peak_memory": 3.002, "active_memory": None}


@pytest.mark.parametrize("bits", [None, 4])
def test_tree_num_params_matches_jax(bits):
    """The port's count of a tiny FLUX MMDiT (float, or its block linears
    packed at int4, a ``q4`` word counted as its 8 weights) equals the JAX
    package's ``tree_num_params`` on the same tree, for the module and for
    its state dict."""
    cfg = dataclasses.replace(build_flux_pipeline().mmdit_config, hidden_size_override=128,
                              rope_axes_dim=(8, 28, 28))
    params = init_mmdit_params(jax.random.PRNGKey(0), cfg, quantize_bits=bits)
    model = mmdit_from_jax(params, torch_config(cfg, tcfg.MMDiTConfig), device="cpu")
    want = jax_utils.tree_num_params(params)
    assert utils.tree_num_params(model) == utils.tree_num_params(model.state_dict()) == want
    words = sum(t.numel() for k, t in model.state_dict().items() if k.endswith(".q4"))
    assert (words > 0) == (bits == 4)
    assert want == sum(t.numel() for t in model.state_dict().values()) + 7 * words
