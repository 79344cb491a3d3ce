"""The port's checkpoint loading against the JAX package's: the MMDiT mappers
(SD3 and SD3.5 in the sgm namespace, FLUX in BFL's, the MLX 4-bit releases),
the MLX repack and dequantisation, the namespace detection, the CLIP and T5
mappers and loaders, the tokenizer loaders, strict loading, the routing of
packed linears that no kernel takes, and both pipelines' ``load``,
``low_memory_mode`` and ``w16``.

The raw state dicts are the ones tests/test_model_io.py and
tests/test_mlx_quantized.py build, from numpy seeds. Each mapper's module is
held against the JAX mapper's tree carried into the port by ``convert.py``
(every leaf bit for bit: packed words, and every float cast from an F16 or
F32 file) and forward for forward in fp32 (within 1e-5 relative L2). Where
the JAX package reads a fixed config (``MMDIT_CONFIG``, ``T5_XXL``, the VAE
decoder's, ``load_t5_tokenizer``), both packages are monkeypatched alike.
Files go to a pytest tmp dir; the hub is replaced so nothing reaches the
network.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

import diffusionkit_tpu.pipeline as jax_pipeline
from diffusionkit_tpu import model_io as jax_io
from diffusionkit_tpu.config import CLIPTextModelConfig as JaxCLIPConfig
from diffusionkit_tpu.config import T5Config as JaxT5Config
from diffusionkit_tpu.config import VAEDecoderConfig as JaxVAEDecoderConfig
from diffusionkit_tpu.models import apply_clip, apply_mmdit, apply_t5_encoder
from diffusionkit_tpu.ops.quantized import mlx_quantize_host, quantized_linear
from diffusionkit_tpu_torch import config as tcfg
from diffusionkit_tpu_torch import model_io
from diffusionkit_tpu_torch import pipeline as port_pipeline
from diffusionkit_tpu_torch.convert import clip_from_jax, mmdit_from_jax, t5_from_jax
from diffusionkit_tpu_torch.ops import common as port_common
from diffusionkit_tpu_torch.ops import int4_matmul as port_int4
from diffusionkit_tpu_torch.ops.quantized import QuantizedLinear
from diffusionkit_tpu_torch.ops.quantized import mlx_q4_to_exec as port_mlx_q4_to_exec
from diffusionkit_tpu_torch.tokenizer import BOS, EOS

import test_mlx_quantized as jq
import test_model_io as jt
from test_torch_models import torch_config

torch.set_num_threads(1)

RTOL = 1e-5  # fp32 on both sides: relative L2


def rel_l2(got, want) -> float:
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def drawn(seed: int, build, *args):
    """A state-dict function of tests/test_model_io.py run on its own seed (its
    module's RandomState put back after)."""
    saved = jt._rs
    jt._rs = np.random.RandomState(seed)
    try:
        return build(*args)
    finally:
        jt._rs = saved


def to_torch(sd):
    """numpy state dict -> torch (uint32 words as torch.uint32, as the
    reader gives them)."""
    out = {}
    for k, v in sd.items():
        v = np.ascontiguousarray(v)
        if v.dtype == np.uint32:
            out[k] = torch.from_numpy(v.view(np.int32)).view(torch.uint32)
        elif v.dtype == ml_dtypes.bfloat16:
            out[k] = torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
        else:
            out[k] = torch.from_numpy(v)
    return out


@pytest.fixture(autouse=True)
def no_hub(monkeypatch, tmp_path):
    """The hub answers nothing. The quantized-model cache goes to the test's tmp dir."""
    import huggingface_hub

    def offline(repo, filename, *args, **kwargs):
        raise ConnectionError(f"offline: {repo}/{filename}")

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("DIFFUSIONKIT_TPU_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.delenv("DIFFUSIONKIT_TPU_CKPT_DIR", raising=False)
    monkeypatch.setattr(huggingface_hub, "hf_hub_download", offline)


def assert_same_leaves(got: torch.nn.Module, want: torch.nn.Module):
    """Every leaf of ``got`` is ``want``'s bit for bit: packed and integer
    leaves as they are, float leaves by value (``want``'s were carried
    exactly by ``convert.py``, through fp32)."""
    g, w = got.state_dict(), want.state_dict()
    assert sorted(g) == sorted(w)
    for k in g:
        a, b = g[k], w[k]
        assert a.shape == b.shape, k
        if not a.is_floating_point():
            assert a.dtype == b.dtype and torch.equal(a, b), k
            continue
        assert torch.equal(a.float(), b.float()), k


def with_zero_uni_fc2_bias(tree, config):
    """The JAX tree with the unified blocks' (absent) fc2 bias as zeros,
    the port module's form of the same sum."""
    if "uni_blocks" not in tree or tree["uni_blocks"]["fc2"].get("bias") is not None:
        return tree
    tree = dict(tree)
    uni = dict(tree["uni_blocks"])
    uni["fc2"] = dict(uni["fc2"], bias=np.zeros((config.depth_unified, config.hidden_size),
                                                np.float32))
    tree["uni_blocks"] = uni
    return tree


def mmdit_inputs(jcfg, seed, latent=(8, 8)):
    rs = np.random.RandomState(seed)
    return (rs.randn(1, *latent, 16).astype(np.float32),
            rs.randn(1, 7, jcfg.token_level_text_embed_dim).astype(np.float32),
            rs.randn(1, jcfg.pooled_text_embed_dim).astype(np.float32),
            np.array([500.0], np.float32))


def check_mmdit(jcfg, tree, model, seed=5):
    """``model`` (fp32) against the JAX tree: leaves, then one forward."""
    want = mmdit_from_jax(with_zero_uni_fc2_bias(tree, jcfg), torch_config(jcfg, tcfg.MMDiTConfig),
                          device="cpu")
    assert_same_leaves(model, want)
    args = mmdit_inputs(jcfg, seed)
    ref = np.asarray(apply_mmdit(tree, jcfg, *map(jnp.asarray, args), sdpa_impl="xla"))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, args)).numpy()
    assert np.abs(ref).max() > 1e-3
    assert rel_l2(got, ref) < RTOL, rel_l2(got, ref)


# -- the MMDiT mappers ---------------------------------------------------------


SD35_TINY = dataclasses.replace(jt.TINY_SD3, use_qk_norm=True, upcast_multimodal_blocks=(0,))
FLUX_DEV_TINY = dataclasses.replace(jt.TINY_FLUX, guidance_embed=True)


def sd35_raw(seed):
    """tests/test_model_io.py's SD3 file with SD3.5's QK-norm scales."""
    sd = drawn(seed, jt._sd3_raw_ckpt, SD35_TINY)
    rs = np.random.RandomState(seed + 100)
    hd = SD35_TINY.hidden_size // SD35_TINY.num_heads
    for i in range(SD35_TINY.depth_multimodal):
        for blk in ("x_block", "context_block"):
            for n in ("ln_q", "ln_k"):
                sd[f"model.diffusion_model.joint_blocks.{i}.{blk}.attn.{n}.weight"] = (
                    1 + 0.1 * rs.randn(hd)).astype(np.float32)
    return sd


def flux_dev_raw(seed):
    """tests/test_model_io.py's FLUX file with FLUX.1-dev's guidance_in."""
    sd = drawn(seed, jt._flux_raw_ckpt, FLUX_DEV_TINY)
    rs = np.random.RandomState(seed + 100)
    H = FLUX_DEV_TINY.hidden_size
    for n, din in (("in_layer", 256), ("out_layer", H)):
        sd[f"guidance_in.{n}.weight"] = (rs.randn(H, din) * 0.02).astype(np.float32)
        sd[f"guidance_in.{n}.bias"] = (rs.randn(H) * 0.02).astype(np.float32)
    return sd


@pytest.mark.parametrize("file_dtype", ["F32", "F16"])
def test_sd3_mapper_matches_jax(file_dtype):
    """SD3 raw (fused qkv, the folded patch convolution, the K/V-only last
    text block): an F32 file loads in fp32; an F16 one casts to bf16 bit
    for bit as the JAX host cast does, and loads in fp32 exactly."""
    sd = drawn(11, jt._sd3_raw_ckpt, jt.TINY_SD3)
    if file_dtype == "F16":
        sd = {k: v.astype(np.float16) for k, v in sd.items()}
        tree16 = jax_io.mmdit_params_from_sd3_ckpt(sd, jt.TINY_SD3, jnp.bfloat16)
        model16 = model_io.mmdit_from_sd3_ckpt(to_torch(sd), torch_config(jt.TINY_SD3,
                                                                        tcfg.MMDiTConfig),
                                               torch.bfloat16, device="cpu")
        want = mmdit_from_jax(tree16, torch_config(jt.TINY_SD3, tcfg.MMDiTConfig), device="cpu")
        assert model16.x_embedder.weight.dtype == torch.bfloat16
        assert_same_leaves(model16, want)
    tree = jax_io.mmdit_params_from_sd3_ckpt(sd, jt.TINY_SD3, jnp.float32)
    model = model_io.mmdit_from_sd3_ckpt(to_torch(sd), torch_config(jt.TINY_SD3, tcfg.MMDiTConfig),
                                         device="cpu")
    assert model.mm_final.final and not hasattr(model.mm_final.txt, "o")
    check_mmdit(jt.TINY_SD3, tree, model)


def test_sd35_mapper_qk_norm_and_upcast_block():
    """SD3.5 raw: QK-norm from ln_q / ln_k, and block 0 as the fp32-upcast
    block: loaded at bf16 its leaves are fp32 holding the bf16 values the
    JAX tree holds (the reference upcasts them at run time)."""
    sd = sd35_raw(12)
    pcfg = torch_config(SD35_TINY, tcfg.MMDiTConfig)
    tree = jax_io.mmdit_params_from_sd3_ckpt(sd, SD35_TINY, jnp.float32)
    check_mmdit(SD35_TINY, tree, model_io.mmdit_from_sd3_ckpt(to_torch(sd), pcfg, device="cpu"))

    bf16_cfg = dataclasses.replace(pcfg, dtype=torch.bfloat16)
    model = model_io.mmdit_from_sd3_ckpt(to_torch(sd), bf16_cfg, device="cpu")
    tree16 = jax_io.mmdit_params_from_sd3_ckpt(sd, SD35_TINY, jnp.bfloat16)
    assert {p.dtype for p in model.mm_blocks[0].parameters()} == {torch.float32}
    assert model.mm_final.img.q.weight.dtype == torch.bfloat16
    want = mmdit_from_jax(tree16, pcfg, device="cpu")
    assert_same_leaves(model, want)


@pytest.mark.parametrize("guidance", [False, True])
def test_flux_mapper_matches_jax(guidance):
    """FLUX raw: linear1 split at (H, 2H, 3H), linear2 into (o | fc2) with
    the shared bias on o, guidance_in for FLUX.1-dev, and the q/k columns
    permuted for RoPE (weights, the q bias, the QK-norm scales)."""
    jcfg = FLUX_DEV_TINY if guidance else jt.TINY_FLUX
    sd = flux_dev_raw(13) if guidance else drawn(13, jt._flux_raw_ckpt, jcfg)
    tree = jax_io.mmdit_params_from_flux_ckpt(sd, jcfg, jnp.float32)
    model = model_io.mmdit_from_flux_ckpt(to_torch(sd), torch_config(jcfg, tcfg.MMDiTConfig),
                                          device="cpu")
    assert (model.guidance_embedder is not None) == guidance
    assert not model.uni_blocks[0].fc2.bias.any()
    check_mmdit(jcfg, tree, model)


@pytest.mark.parametrize("family", ["flux", "sd35"])
def test_mlx_mapper_matches_jax(family):
    """Both 4-bit releases (tests/test_mlx_quantized.py's fabricated files:
    every linear packed, the final layer and the embedders too): the packed
    leaves bit for bit, FLUX's shared fc2 bias dropped and its q/k columns
    permuted, SD3.5's mm_final; the forward on the dequantise path."""
    if family == "flux":
        jcfg = jq._tiny_flux_config()
        sd = jq._fabricate_flux_4bit(jcfg)
    else:
        jcfg = jq._tiny_sd35_config()
        sd = jq._fabricate_sd35_4bit(jcfg)
    assert model_io.detect_mmdit_namespace(to_torch(sd)) == jax_io.detect_mmdit_namespace(sd)
    tree = jax_io.mmdit_params_from_mlx_ckpt(sd, jcfg, jnp.float32)
    model = model_io.mmdit_from_mlx_ckpt(to_torch(sd), torch_config(jcfg, tcfg.MMDiTConfig),
                                         device="cpu")
    assert isinstance(model.final_layer.linear, QuantizedLinear)
    assert isinstance(model.context_embedder, QuantizedLinear)
    assert model.final_layer.linear.out_features == 64
    check_mmdit(jcfg, tree, model)


def test_mlx_repack_is_the_word_transpose():
    """The repack of a packed linear is a transpose of its (out, in/8) word
    matrix, the port's ``mlx_q4_to_exec`` and the JAX package's bit for
    bit; scales and biases fp32, transposed."""
    rs = np.random.RandomState(14)
    q = mlx_quantize_host(rs.randn(96, 256).astype(np.float32), group_size=64)
    m = model_io._Mapped("cpu")
    m.mlx(to_torch({f"l.{k}": v for k, v in q.items()}), "l", "dst", bias=False)
    want = port_mlx_q4_to_exec(q["weight"], q["scales"], q["biases"], None)
    jwant = jax_io.mlx_q4_to_exec(q["weight"], q["scales"], q["biases"], None, jnp.float32)
    got = m.sd["dst.q4"].numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want["q4"])
    np.testing.assert_array_equal(got, jwant["q4"])
    np.testing.assert_array_equal(got, q["weight"].T)
    for k in ("scales", "zeros"):
        assert m.sd[f"dst.{k}"].dtype == torch.float32
        np.testing.assert_array_equal(m.sd[f"dst.{k}"].numpy(), jwant[k])
    assert m.packed["dst"] == (256, 96, 64, False)


def test_mlx_dequantize_matches_jax():
    """``dequantize_mlx_4bit`` and ``_maybe_dequantize`` (a raw file that
    carries MLX triples) bit for bit against the JAX package's."""
    rs = np.random.RandomState(15)
    sd = {"a.bias": rs.randn(48).astype(np.float32)}
    for name, g in (("a", 32), ("b", 64)):
        for k, v in mlx_quantize_host(rs.randn(48, 256).astype(np.float32), group_size=g).items():
            sd[f"{name}.{k}"] = v
    got = model_io._maybe_dequantize(to_torch(sd))
    want = jax_io._maybe_dequantize(sd)
    assert sorted(got) == sorted(want) == ["a.bias", "a.weight", "b.weight"]
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k], np.float32))
    one = model_io.dequantize_mlx_4bit(*(torch.from_numpy(sd[f"b.{k}"].view(np.int32)
                                                           if k == "weight" else sd[f"b.{k}"])
                                         for k in ("weight", "scales", "biases")))
    np.testing.assert_array_equal(one.numpy(), jax_io.dequantize_mlx_4bit(
        sd["b.weight"], sd["b.scales"], sd["b.biases"]))


def test_sd3_mapper_dequantizes_mlx_triples():
    """A raw SD3 file whose linears carry MLX triples loads as the float
    model of their dequantised values, as in the JAX package."""
    sd = drawn(16, jt._sd3_raw_ckpt, jt.TINY_SD3)
    key = "model.diffusion_model.joint_blocks.0.x_block.mlp.fc1"
    for k, v in mlx_quantize_host(sd.pop(key + ".weight"), group_size=32).items():
        sd[f"{key}.{k}"] = v
    tree = jax_io.mmdit_params_from_sd3_ckpt(sd, jt.TINY_SD3, jnp.float32)
    model = model_io.mmdit_from_sd3_ckpt(to_torch(sd), torch_config(jt.TINY_SD3, tcfg.MMDiTConfig),
                                         device="cpu")
    assert isinstance(model.mm_blocks[0].img.fc1, torch.nn.Linear)
    check_mmdit(jt.TINY_SD3, tree, model)


@pytest.mark.parametrize("keys,want", [
    (["double_blocks.0.img_attn.qkv.weight"], "flux_raw"),
    (["model.diffusion_model.joint_blocks.0.x_block.attn.qkv.weight"], "sd3_raw"),
    (["unified_transformer_blocks.0.transformer_block.attn.q_proj.weight"], "mlx"),
    (["model.diffusion_model.multimodal_transformer_blocks.0.image_transformer_block.x"], "mlx"),
])
def test_detect_mmdit_namespace_is_the_references(keys, want):
    sd = {k: 0 for k in keys}
    assert model_io.detect_mmdit_namespace(sd) == jax_io.detect_mmdit_namespace(sd) == want


def test_load_mmdit_from_the_ckpt_dir(tmp_path, monkeypatch):
    """``load_mmdit`` resolves the version's file under
    DIFFUSIONKIT_TPU_CKPT_DIR and picks its namespace, as the JAX loader
    does (``MMDIT_CONFIG`` patched to a tiny config in both packages)."""
    version = tcfg.FLUX_SCHNELL_4BIT
    jcfg = jq._tiny_flux_config()
    pcfg = torch_config(jcfg, tcfg.MMDiTConfig)
    monkeypatch.setitem(jax_io.MMDIT_CONFIG, version, jcfg)
    monkeypatch.setitem(model_io.MMDIT_CONFIG, version, pcfg)
    d = tmp_path / version
    d.mkdir(parents=True)
    sd = jq._fabricate_flux_4bit(jcfg)
    save_file(sd, str(d / model_io.MMDIT_CKPT[version]))
    monkeypatch.setenv("DIFFUSIONKIT_TPU_CKPT_DIR", str(tmp_path))
    tree, _ = jax_io.load_mmdit(version, jnp.float32)
    model, config = model_io.load_mmdit(version, torch.float32, device="cpu")
    assert config is pcfg
    check_mmdit(jcfg, jax.tree.map(np.asarray, tree), model)


def test_strict_loading_raises_on_a_missing_and_an_extra_leaf():
    """``strict=True``: a state dict one leaf short, or one leaf over,
    raises; a file missing a tensor raises in the mapper."""
    sd = to_torch(drawn(17, jt._sd3_raw_ckpt, jt.TINY_SD3))
    pcfg = torch_config(jt.TINY_SD3, tcfg.MMDiTConfig)
    model = model_io.mmdit_from_sd3_ckpt(sd, pcfg, device="cpu")
    full = dict(model.state_dict())
    for broken in ({k: v for k, v in full.items() if k != "final_layer.linear.bias"},
                   dict(full, **{"final_layer.linear.extra": full["final_layer.linear.bias"]})):
        with torch.device("meta"):
            fresh = type(model)(pcfg)
        with pytest.raises(RuntimeError, match="Missing key|Unexpected key"):
            model_io._build(fresh, broken, "cpu")
    short = {k: v for k, v in sd.items() if not k.endswith("final_layer.linear.bias")}
    with pytest.raises(RuntimeError, match="Missing key"):
        model_io.mmdit_from_sd3_ckpt(short, pcfg, device="cpu")
    with pytest.raises(KeyError):
        model_io.mmdit_from_sd3_ckpt({k: v for k, v in sd.items() if "pos_embed" not in k}, pcfg,
                                     device="cpu")


# -- the repaired routing of packed linears --------------------------------------


def packed_layer(k, n, seed, wscale=False):
    """A packed int4 linear at group 64 with a bias, in the JAX package's
    exec format and as the port's QuantizedLinear (the same bits)."""
    from diffusionkit_tpu.ops.quantized import quantize_kernel_host as jax_quantize
    from diffusionkit_tpu.ops.w4a8_matmul import add_wscale_tree

    rs = np.random.RandomState(seed)
    p = jax_quantize(rs.randn(k, n).astype(np.float32) * 0.05, bits=4, group_size=64,
                     refine=False)
    p["bias"] = (rs.randn(n) * 0.1).astype(np.float32)
    if wscale:
        p = add_wscale_tree({"l": p})["l"]
    host = {key: np.asarray(v) for key, v in p.items()}
    layer = QuantizedLinear.from_host(host, torch.bfloat16, device="cpu")
    jp = dict(host, bias=host["bias"].astype(ml_dtypes.bfloat16))
    return jp, layer


@pytest.mark.parametrize("k,wscale", [(3072, False), (3072, True), (2432, False), (2432, True)])
def test_packed_final_layer_takes_the_dequantise_path(k, wscale, monkeypatch):
    """The 4-bit releases' final layer (K -> 64, group 64), int4 and with a
    w4a8 wscale: no kernel takes N = 64 (``kernel_takes``, the kernels'
    own rule), so the port computes it as the JAX package's
    ``quantized_linear`` does off its kernel (the weight rounded to x's
    dtype, fp32 product, bias and GELU, one rounding), decided before any
    launch: the kernels' wrappers are never called."""
    jp, layer = packed_layer(k, 64, seed=k + wscale, wscale=wscale)
    assert not port_int4.kernel_takes(k, 64, layer.scales.shape[0], wscale)

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel was asked for a layer no kernel takes")

    for name in ("int4_linear", "int8_linear", "w4a8_linear"):
        monkeypatch.setattr(port_common, name, refuse)
    rs = np.random.RandomState(18)
    x = rs.randn(2, 9, k).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    for act in (None, "gelu"):
        want = np.asarray(quantized_linear(jp, xb, act=act).astype(jnp.float32))
        got = port_common.linear(layer, torch.from_numpy(x).bfloat16(), act).float().numpy()
        err = np.abs(got - want)
        if act is None:
            # bf16 out of fp32 sums of exact products: the order of the
            # sums only (one bf16 ulp where a sum sits on a rounding edge).
            assert (err <= np.abs(want) * 2.0**-7).all() and (got == want).mean() > 0.99
        else:
            # The two packages' fp32 erf differ in GELU's negative tail,
            # where 1 + erf cancels: one bf16 ulp plus 2^-20.
            assert (err <= np.abs(want) * 2.0**-7 + 2.0**-20).all()


# The block linears of the releases and of quantize-at-load that the
# kernels take, FLUX fc2 (K = 12288) at group 256 and SD3.5-large fc2 (K =
# 9728) at group 128 among them, int4 and with a w4a8 wscale.
KERNEL_SHAPES = [(3072, 128, 64), (12288, 3072, 256), (9728, 2432, 128), (3072, 9216, 32),
                 (2432, 9728, 64)]


@pytest.mark.parametrize("wscale", [False, True])
@pytest.mark.parametrize("k,n,group", KERNEL_SHAPES)
def test_packed_kernel_shapes_still_take_the_kernels(k, n, group, wscale, monkeypatch):
    """A packed linear whose shape the kernels take still goes to its
    wrapper (int4_linear, or w4a8_linear with a wscale), whatever K block
    the reference's TPU tiling would find for it."""
    layer = QuantizedLinear(k, n, group, dtype=torch.bfloat16, device="cpu", wscale=wscale)
    called = []
    for name in ("int4_linear", "w4a8_linear"):
        monkeypatch.setattr(port_common, name, lambda layer, x, act=None, name=name:
                            called.append((name, x.shape)) or x[..., :n])
    monkeypatch.setattr(port_common, "dequant_linear", lambda *a, **kw: called.append("dequant"))
    assert port_int4.kernel_takes(k, n, k // group, wscale)
    port_common.linear(layer, torch.zeros(1, k, dtype=torch.bfloat16))
    assert called == [("w4a8_linear" if wscale else "int4_linear", (1, k))]


@pytest.mark.parametrize("k,n,group,wscale", [
    *((k, n, g, w) for k, n, g in KERNEL_SHAPES for w in (False, True)),
    (3072, 64, 64, False), (2432, 64, 64, True), (3072, 200, 64, False), (96, 128, 32, False),
    (96, 128, 32, True), (512, 256, 16, False), (512, 256, 96, True), (192, 128, 64, True),
])
def test_kernel_takes_is_the_wrappers_rule(k, n, group, wscale):
    """``kernel_takes`` holds exactly where the kernels' wrappers take the
    shape: ``dequant_kernel`` (C, #13) or, with a wscale, ``w4a8_kernel``
    in mode plain (E, or #10 then #11) picks an entry instead of raising."""
    from diffusionkit_tpu_torch.ops.w4a8_matmul import w4a8_kernel

    try:
        if wscale:
            w4a8_kernel(256, k, k // 8, n, k // group, "plain")
        else:
            port_int4.dequant_kernel("int4_matmul", 256, k, k, n, k // group)
        taken = True
    except ValueError:
        taken = False
    assert port_int4.kernel_takes(k, n, k // group, wscale) == taken


# -- the text encoders ---------------------------------------------------------------


def clip_hf(jcfg: JaxCLIPConfig, seed: int, prefix: str = "text_model."):
    """An HF CLIPTextModel state dict and config.json for ``jcfg``."""
    rs = np.random.RandomState(seed)
    d = jcfg.model_dims

    def w(*shape, s=None):
        return (rs.randn(*shape) * (s or 1 / np.sqrt(shape[-1]))).astype(np.float32)

    sd = {f"{prefix}embeddings.token_embedding.weight": w(jcfg.vocab_size, d, s=0.5),
          f"{prefix}embeddings.position_embedding.weight": w(jcfg.max_length, d, s=0.5),
          f"{prefix}final_layer_norm.weight": 1 + w(d, s=0.1),
          f"{prefix}final_layer_norm.bias": w(d, s=0.1)}
    for i in range(jcfg.num_layers):
        pre = f"{prefix}encoder.layers.{i}"
        for ln in ("layer_norm1", "layer_norm2"):
            sd[f"{pre}.{ln}.weight"] = 1 + w(d, s=0.1)
            sd[f"{pre}.{ln}.bias"] = w(d, s=0.1)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{pre}.self_attn.{proj}.weight"] = w(d, d)
            sd[f"{pre}.self_attn.{proj}.bias"] = w(d, s=0.1)
        sd[f"{pre}.mlp.fc1.weight"], sd[f"{pre}.mlp.fc1.bias"] = w(4 * d, d), w(4 * d, s=0.1)
        sd[f"{pre}.mlp.fc2.weight"], sd[f"{pre}.mlp.fc2.bias"] = w(d, 4 * d), w(d, s=0.1)
    if jcfg.projection_dim is not None:
        sd["text_projection.weight"] = w(jcfg.projection_dim, d)
    cfg = {"num_hidden_layers": jcfg.num_layers, "hidden_size": d,
           "num_attention_heads": jcfg.num_heads, "max_position_embeddings": jcfg.max_length,
           "vocab_size": jcfg.vocab_size, "hidden_act": jcfg.hidden_act}
    if jcfg.projection_dim is not None:
        cfg["projection_dim"] = jcfg.projection_dim
    return sd, cfg


CLIP_L_TINY = JaxCLIPConfig(num_layers=2, model_dims=8, num_heads=2, max_length=77,
                            vocab_size=64, projection_dim=None, hidden_act="quick_gelu")
CLIP_G_TINY = JaxCLIPConfig(num_layers=2, model_dims=8, num_heads=2, max_length=77,
                            vocab_size=64, projection_dim=8, hidden_act="gelu")
T5_TINY = JaxT5Config(vocab_size=64, d_model=8, d_kv=4, d_ff=12, num_layers=2, num_heads=2)


def write_aux(root, name: str, sd, cfg=None, dtype=np.float16) -> None:
    """The auxiliary repo's files for ``name`` ("clip_l", "clip_g", "t5")
    under ``root`` (F16 weights, as the release's ``model.fp16`` files)."""
    path = root / model_io.AUX_REPO / model_io.AUX_FILES[name]
    path.parent.mkdir(parents=True, exist_ok=True)
    save_file({k: v.astype(dtype) for k, v in sd.items()}, str(path))
    if cfg is not None:
        with open(root / model_io.AUX_REPO / model_io.AUX_FILES[name + "_config"], "w") as f:
            json.dump(cfg, f)


@pytest.mark.parametrize("which,jcfg", [("clip_l", CLIP_L_TINY), ("clip_g", CLIP_G_TINY)])
def test_clip_loader_matches_jax(which, jcfg, tmp_path, monkeypatch):
    """CLIP-L (quick_gelu, no projection) and CLIP-G (gelu, projection) from
    an HF directory through ``load_text_encoder``: the config, every leaf
    (F16 file, fp32 module), the hidden states and the pooled output."""
    sd, cfg = clip_hf(jcfg, seed=20 + (which == "clip_g"))
    write_aux(tmp_path, which, sd, cfg)
    monkeypatch.setenv("DIFFUSIONKIT_TPU_CKPT_DIR", str(tmp_path))
    jparams, jconfig = jax_io.load_text_encoder(which, jnp.float32)
    model, config = model_io.load_text_encoder(which, torch.float32, device="cpu")
    assert config == torch_config(jconfig, tcfg.CLIPTextModelConfig)
    assert (model.text_projection is not None) == (jcfg.projection_dim is not None)
    want = clip_from_jax(jax.tree.map(np.asarray, jparams), config, device="cpu")
    assert_same_leaves(model, want)
    tokens = np.array([[62, 3, 5, 9, 63, 0, 0]], np.int32)
    ref = apply_clip(jparams, jnp.asarray(tokens), jconfig)
    with torch.no_grad():
        out = model(torch.from_numpy(tokens).long())
    assert rel_l2(out.pooled_output.numpy(), ref.pooled_output) < RTOL
    assert rel_l2(out.hidden_states[-2].numpy(), ref.hidden_states[-2]) < RTOL


def test_clip_mapper_reads_unprefixed_keys():
    """The ``text_model.`` prefix is optional, as in the reference."""
    sd, _ = clip_hf(CLIP_L_TINY, seed=22, prefix="")
    cfg = torch_config(CLIP_L_TINY, tcfg.CLIPTextModelConfig)
    a = model_io.clip_from_hf_ckpt(to_torch(sd), cfg, device="cpu")
    sd2, _ = clip_hf(CLIP_L_TINY, seed=22)
    assert_same_leaves(a, model_io.clip_from_hf_ckpt(to_torch(sd2), cfg, device="cpu"))


def t5_hf(jcfg: JaxT5Config, seed: int, embed_key: str):
    rs = np.random.RandomState(seed)

    def w(*shape, s=None):
        return (rs.randn(*shape) * (s or 1 / np.sqrt(shape[-1]))).astype(np.float32)

    inner = jcfg.d_kv * jcfg.num_heads
    sd = {embed_key: w(jcfg.vocab_size, jcfg.d_model, s=1.0),
          "encoder.final_layer_norm.weight": 1 + w(jcfg.d_model, s=0.1),
          "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
              w(jcfg.relative_attention_num_buckets, jcfg.num_heads, s=0.5)}
    for i in range(jcfg.num_layers):
        pre = f"encoder.block.{i}.layer"
        sd[f"{pre}.0.layer_norm.weight"] = 1 + w(jcfg.d_model, s=0.1)
        sd[f"{pre}.1.layer_norm.weight"] = 1 + w(jcfg.d_model, s=0.1)
        for n in "qkv":
            sd[f"{pre}.0.SelfAttention.{n}.weight"] = w(inner, jcfg.d_model)
        sd[f"{pre}.0.SelfAttention.o.weight"] = w(jcfg.d_model, inner)
        for n in ("wi_0", "wi_1"):
            sd[f"{pre}.1.DenseReluDense.{n}.weight"] = w(jcfg.d_ff, jcfg.d_model)
        sd[f"{pre}.1.DenseReluDense.wo.weight"] = w(jcfg.d_model, jcfg.d_ff)
    return sd


@pytest.mark.parametrize("embed_key", ["encoder.embed_tokens.weight", "shared.weight"])
def test_t5_loader_matches_jax(embed_key, tmp_path, monkeypatch):
    """T5 under either embedding key through ``load_t5_encoder`` (``T5_XXL``
    patched to a tiny config in both packages), fp32: leaves and output."""
    sd = t5_hf(T5_TINY, 23, embed_key)
    write_aux(tmp_path, "t5", sd, dtype=np.float32)
    monkeypatch.setenv("DIFFUSIONKIT_TPU_CKPT_DIR", str(tmp_path))
    pcfg = torch_config(T5_TINY, tcfg.T5Config)
    monkeypatch.setattr(jax_io, "T5_XXL", T5_TINY)
    monkeypatch.setattr(model_io, "T5_XXL", pcfg)
    jparams = jax_io.load_t5_encoder(jnp.float32)
    model = model_io.load_t5_encoder(torch.float32, device="cpu")
    assert_same_leaves(model, t5_from_jax(jax.tree.map(np.asarray, jparams), pcfg, device="cpu"))
    tokens = np.array([[5, 9, 2, 33, 1, 0]], np.int32)
    ref = np.asarray(apply_t5_encoder(jparams, jnp.asarray(tokens), T5_TINY))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long()).numpy()
    assert rel_l2(got, ref) < RTOL


def tiny_vocab():
    vocab = {}
    for c in "abcdefghijklmnopqrstuvwxyz ,.":
        vocab[c] = len(vocab)
        vocab[c + "</w>"] = len(vocab)
    vocab["ca"] = len(vocab)
    vocab["cat</w>"] = len(vocab)
    vocab[BOS] = len(vocab)
    vocab[EOS] = len(vocab)
    return vocab


def write_tokenizers(root) -> None:
    for which in ("l", "g"):
        vocab = root / model_io.AUX_REPO / model_io.AUX_FILES[f"tokenizer_{which}_vocab"]
        vocab.parent.mkdir(parents=True, exist_ok=True)
        vocab.write_text(json.dumps(tiny_vocab()))
        merges = root / model_io.AUX_REPO / model_io.AUX_FILES[f"tokenizer_{which}_merges"]
        merges.write_text("#version: 0.2\nc a\nca t</w>\n")


def test_load_tokenizer_matches_jax(tmp_path, monkeypatch):
    write_tokenizers(tmp_path)
    monkeypatch.setenv("DIFFUSIONKIT_TPU_CKPT_DIR", str(tmp_path))
    for which, pad in (("l", True), ("g", False)):
        jtok = jax_io.load_tokenizer(which, pad_with_eos=pad)
        tok = model_io.load_tokenizer(which, pad_with_eos=pad)
        assert tok.bpe_ranks == jtok.bpe_ranks and tok.pad_token == jtok.pad_token
        assert tok.tokenize("a cat, a dog.") == jtok.tokenize("a cat, a dog.")


@pytest.mark.parametrize("local", [False, True])
def test_load_t5_tokenizer_resolves_as_the_reference(local, tmp_path, monkeypatch):
    """``load_t5_tokenizer``: the sentencepiece model under
    DIFFUSIONKIT_TPU_CKPT_DIR/google/t5-v1_1-xxl when it is there, else the
    hub id, through ``transformers.AutoTokenizer`` (replaced here: the
    sentencepiece model is not on the machine), as in the JAX package."""
    import transformers

    seen = []

    class Fake:
        eos_token_id = 1

        def __call__(self, text, return_attention_mask=False, max_length=None, truncation=None):
            return {"input_ids": [3 + ord(c) % 50 for c in text][: max_length - 1] + [1]}

    def from_pretrained(path, **kwargs):
        seen.append((str(path), kwargs.get("model_max_length")))
        return Fake()

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", from_pretrained)
    if local:
        (tmp_path / "google" / "t5-v1_1-xxl").mkdir(parents=True)
        monkeypatch.setenv("DIFFUSIONKIT_TPU_CKPT_DIR", str(tmp_path))
    jtok = jax_io.load_t5_tokenizer(256)
    tok = model_io.load_t5_tokenizer(256)
    assert seen[0] == seen[1] and seen[0][1] == 256
    assert seen[0][0] == (str(tmp_path / "google" / "t5-v1_1-xxl") if local
                          else "google/t5-v1_1-xxl")
    assert tok.tokenize("a fox") == jtok.tokenize("a fox") and tok.max_length == 256


# -- the pipelines: load, low_memory_mode, w16 ----------------------------------------


TINY_VAE = JaxVAEDecoderConfig(block_out_channels=(8, 16, 16, 16), layers_per_block=3,
                               resnet_groups=4)
SD3_PIPE = dataclasses.replace(jt.TINY_SD3, pooled_text_embed_dim=16)
FLUX_PIPE = dataclasses.replace(jt.TINY_FLUX, pooled_text_embed_dim=8,
                                token_level_text_embed_dim=8)


class TinyT5Tokenizer:
    """16 token ids a prompt, one per character, EOS last; padded by FLUX
    to the version's T5 length."""

    pad_with_eos = False
    pad_token = 0
    eos_token = 1

    def __init__(self, max_length):
        self.max_length = max_length

    def tokenize(self, text):
        return [(ord(c) % 50) + 2 for c in text[:15]] + [1]


@pytest.fixture(scope="module")
def mirror(tmp_path_factory):
    """A checkpoint mirror (DIFFUSIONKIT_TPU_CKPT_DIR layout) of tiny models:
    SD3-medium's file (the sgm MMDiT and ``first_stage_model.decoder``),
    FLUX.1-schnell's (BFL) with its ``ae.safetensors``, CLIP-L/G, T5 and the
    CLIP tokenizers."""
    root = tmp_path_factory.mktemp("mirror")
    sd3 = drawn(30, jt._sd3_raw_ckpt, SD3_PIPE)
    sd3.update(drawn(31, jt._vae_raw, "first_stage_model.decoder.", 3, TINY_VAE.block_out_channels,
                     16, 3, False))
    flux = drawn(32, jt._flux_raw_ckpt, FLUX_PIPE)
    # The T5 rows go straight to txt_in: its input is the tiny T5's width.
    flux["txt_in.weight"] = (np.random.RandomState(38).randn(FLUX_PIPE.hidden_size, 8)
                             / np.sqrt(8)).astype(np.float32)
    ae = drawn(33, jt._vae_raw, "decoder.", 3, TINY_VAE.block_out_channels, 16, 3, False)
    for version, files in ((tcfg.SD3_MEDIUM, {model_io.MMDIT_CKPT[tcfg.SD3_MEDIUM]: sd3}),
                           (tcfg.FLUX_SCHNELL_VERSION,
                            {model_io.MMDIT_CKPT[tcfg.FLUX_SCHNELL_VERSION]: flux,
                             model_io.VAE_CKPT[tcfg.FLUX_SCHNELL_VERSION]: ae})):
        (root / version).mkdir(parents=True)
        for name, sd in files.items():
            save_file(sd, str(root / version / name))
    for which, jcfg, seed in (("clip_l", CLIP_L_TINY, 34), ("clip_g", CLIP_G_TINY, 35)):
        write_aux(root, which, *clip_hf(jcfg, seed))
    write_aux(root, "t5", t5_hf(T5_TINY, 36, "shared.weight"))
    write_tokenizers(root)
    return root


@pytest.fixture
def tiny_world(mirror, monkeypatch):
    """Both packages read the mirror with the tiny configs."""
    monkeypatch.setenv("DIFFUSIONKIT_TPU_CKPT_DIR", str(mirror))
    monkeypatch.setenv("DIFFUSIONKIT_TPU_GPTQ", "0")
    monkeypatch.setenv("DIFFUSIONKIT_TPU_QUANT_REFINE", "0")
    monkeypatch.setenv("DIFFUSIONKIT_TPU_QUANT_CACHE", "0")
    for version, jcfg in ((tcfg.SD3_MEDIUM, SD3_PIPE), (tcfg.FLUX_SCHNELL_VERSION, FLUX_PIPE)):
        monkeypatch.setitem(jax_io.MMDIT_CONFIG, version, jcfg)
        monkeypatch.setitem(model_io.MMDIT_CONFIG, version, torch_config(jcfg, tcfg.MMDiTConfig))
    monkeypatch.setattr(jax_io, "T5_XXL", T5_TINY)
    monkeypatch.setattr(jax_pipeline, "T5_XXL", T5_TINY)
    monkeypatch.setattr(model_io, "T5_XXL", torch_config(T5_TINY, tcfg.T5Config))
    monkeypatch.setattr(jax_pipeline, "VAEDecoderConfig", lambda: TINY_VAE)
    monkeypatch.setattr(model_io, "VAEDecoderConfig",
                        lambda: torch_config(TINY_VAE, tcfg.VAEDecoderConfig))
    monkeypatch.setattr(jax_io, "load_t5_tokenizer", TinyT5Tokenizer)
    monkeypatch.setattr(model_io, "load_t5_tokenizer", TinyT5Tokenizer)


PROMPT, NEGATIVE, SEED = "a photo of a cat", "blurry", 7
_JAX_IMAGES = {}


def psnr(a, b) -> float:
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float(10 * np.log10(255.0**2 / max(mse, 1e-12)))


def generate(flux: bool, port: bool, **kw):
    """One image through ``generate_image`` of a pipeline built with
    ``load=True`` (and ``kw``), a16=False so the VAE decodes in fp32."""
    cls = ((port_pipeline.FluxPipeline if flux else port_pipeline.DiffusionPipeline) if port
           else (jax_pipeline.FluxPipeline if flux else jax_pipeline.DiffusionPipeline))
    extra = {} if flux else {"use_t5": False}
    if port:
        extra["device"] = "cpu"
    pipe = cls(load=True, a16=False, **extra, **kw)
    cfg = 0.0 if flux else 5.0
    image, log = pipe.generate_image(PROMPT, num_steps=2, cfg_weight=cfg, negative_text=NEGATIVE,
                                     latent_size=(8, 8), seed=SEED, verbose=False)
    return pipe, np.asarray(image).astype(int), log


@pytest.mark.parametrize("flux", [False, True], ids=["sd3", "flux"])
@pytest.mark.parametrize("w16", [True, False], ids=["w16", "w32"])
@pytest.mark.parametrize("low_memory_mode", [True, False], ids=["lowmem", "resident"])
def test_pipeline_loads_every_model(flux, w16, low_memory_mode, tiny_world):
    """``DiffusionPipeline`` (SD3, T5 off) and ``FluxPipeline`` (FLUX.1-
    schnell, T5) built with ``load=True`` from the mirror: every model
    loaded in ``w16``'s dtype; under ``low_memory_mode`` the text encoders
    at construction and each model dropped after its phase, otherwise all
    of them at construction and kept. The image against the JAX pipeline's
    on the same files: pixels at most one level apart in fp32 (w16=False),
    and within the JAX package's 35 dB PSNR convention against torch
    (tests/test_hf_parity.py) in bf16."""
    key = (flux, w16)
    if key not in _JAX_IMAGES:
        _JAX_IMAGES[key] = generate(flux, False, w16=w16, low_memory_mode=True)[1]
    want = _JAX_IMAGES[key]
    dtype = torch.bfloat16 if w16 else torch.float32
    encoders = ("clip_l", "t5") if flux else ("clip_l", "clip_g")
    cls = port_pipeline.FluxPipeline if flux else port_pipeline.DiffusionPipeline
    extra = {} if flux else {"use_t5": False}
    built = cls(load=True, a16=False, device="cpu", w16=w16, low_memory_mode=low_memory_mode,
                **extra)
    loaded = [n for n in ("mmdit", "decoder", "clip_l", "clip_g", "t5")
              if getattr(built, n) is not None]
    assert loaded == (list(encoders) if low_memory_mode
                      else ["mmdit", "decoder", *encoders]), loaded
    assert built.clip_l.token_embedding.weight.dtype == dtype
    if not low_memory_mode:
        assert built.mmdit.x_embedder.weight.dtype == dtype
        assert built.decoder.conv_in.weight.dtype == dtype
    del built

    pipe, got, log = generate(flux, True, w16=w16, low_memory_mode=low_memory_mode)
    gone = [n for n in ("mmdit", "decoder", *encoders) if getattr(pipe, n) is None]
    assert gone == (["mmdit", "decoder", *encoders] if low_memory_mode else [])
    assert (log["denoising"]["load_time"] > 0) == low_memory_mode
    assert got.shape == want.shape == (64, 64, 3) and got.std() > 5
    if w16:
        assert psnr(got, want) >= 35.0, psnr(got, want)
    else:
        assert np.abs(got - want).max() <= 1


def test_pipeline_quantizes_the_loaded_mmdit(tiny_world, mirror, tmp_path, monkeypatch):
    """``quantize_mmdit="int4"`` on a loaded float MMDiT, reloaded and
    quantized on its device at each request under ``low_memory_mode``
    (the min/max grid: DIFFUSIONKIT_TPU_GPTQ=0, DIFFUSIONKIT_TPU_QUANT_REFINE
    =0 in both packages), and ``generate_images_batched`` loading and
    dropping its models the same way: the images against the JAX
    pipeline's, fp32 (hidden 256, so the block linears pack)."""
    import shutil

    wide = dataclasses.replace(SD3_PIPE, hidden_size_override=256, num_heads=4)
    shutil.copytree(mirror / model_io.AUX_REPO, tmp_path / model_io.AUX_REPO)
    (tmp_path / tcfg.SD3_MEDIUM).mkdir(parents=True)
    sd = drawn(37, jt._sd3_raw_ckpt, wide)
    sd.update(drawn(31, jt._vae_raw, "first_stage_model.decoder.", 3, TINY_VAE.block_out_channels,
                    16, 3, False))
    save_file(sd, str(tmp_path / tcfg.SD3_MEDIUM / model_io.MMDIT_CKPT[tcfg.SD3_MEDIUM]))
    monkeypatch.setenv("DIFFUSIONKIT_TPU_CKPT_DIR", str(tmp_path))
    monkeypatch.setitem(jax_io.MMDIT_CONFIG, tcfg.SD3_MEDIUM, wide)
    monkeypatch.setitem(model_io.MMDIT_CONFIG, tcfg.SD3_MEDIUM,
                        torch_config(wide, tcfg.MMDiTConfig))
    kw = dict(w16=False, quantize_mmdit="int4", quantize_group_size=64)
    _, want, _ = generate(False, False, low_memory_mode=True, **kw)
    pipe, got, _ = generate(False, True, low_memory_mode=True, **kw)
    assert pipe.mmdit is None
    assert np.abs(got - want).max() <= 1
    batched = pipe.generate_images_batched([PROMPT], num_steps=2, cfg_weight=5.0,
                                           negative_texts=[NEGATIVE], latent_size=(8, 8),
                                           seeds=[SEED])
    assert pipe.mmdit is None and pipe.decoder is None and pipe.clip_l is None
    assert np.array_equal(np.asarray(batched[0]).astype(int), got)
    loaded = port_pipeline.DiffusionPipeline(load=True, low_memory_mode=False, device="cpu",
                                             use_t5=False, a16=False, **kw)
    q = loaded.mmdit.mm_blocks[0].img.fc1
    assert isinstance(q, QuantizedLinear) and q.group_size == 64


def test_pipeline_loads_only_what_is_missing(tiny_world):
    """A model or tokenizer assigned by the caller is kept: the loaders
    fetch the rest (here the T5 tokenizer is the caller's), and
    ``unload_t5`` drops the T5 and turns it off."""
    mine = TinyT5Tokenizer(256)
    pipe = port_pipeline.FluxPipeline(load=False, low_memory_mode=False, device="cpu")
    pipe.t5_tokenizer = mine
    pipe.check_and_load_models()
    pipe.ensure_models_are_loaded()
    assert pipe.t5_tokenizer is mine
    assert all(getattr(pipe, n) is not None for n in ("mmdit", "decoder", "clip_l", "t5",
                                                       "tokenizer_l"))
    assert pipe.clip_g is None and pipe.tokenizer_g is None
    clip = pipe.clip_l
    pipe.load_text_encoders()
    assert pipe.clip_l is clip
    pipe.unload_t5()
    assert pipe.t5 is None and pipe.t5_tokenizer is None and not pipe.use_t5
