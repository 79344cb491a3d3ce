"""The w8a8 mode of the PyTorch port against the JAX package.

Kernels #4 (``gelu_quantize``), #11 (``w8_matmul``) and the widened kernel D
through their plain versions, against the reference's Pallas kernels run
with ``interpret=True``; ``w8a8_linear``, the host and device conversions,
``convert.py``, a tiny SD3 w8a8 MMDiT and ``DiffusionPipeline(
quantize_mmdit="w8a8")``; the SmoothQuant fold, the w8a8 T5 and
``FluxPipeline(quantize_t5=True)``. Inputs come from numpy seeds.

The JAX package's w8a8 dispatch needs no backend gate (its ``w8a8_linear``
runs anywhere); its fused quantizers run on a TPU only, so the model tests
set its own ``DIFFUSIONKIT_TPU_FUSED_QUANT=interpret`` switch, under which
the AdaLN sites, the FFN GELU and the float-input quantizations take the
Pallas kernels in interpret mode, as on a TPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionkit_tpu.config import SD3_2b as JAX_SD3
from diffusionkit_tpu.config import T5Config as JaxT5Config
from diffusionkit_tpu.models import apply_mmdit, init_mmdit_params, init_t5_params
from diffusionkit_tpu.models.t5 import apply_t5_encoder
from diffusionkit_tpu.ops import fused_quant as jfq
from diffusionkit_tpu.ops import quantized as jq
from diffusionkit_tpu.ops import smoothquant as jsq
from diffusionkit_tpu.ops import w4a8_matmul as jw
from diffusionkit_tpu.ops import w8a8 as jw8
from diffusionkit_tpu_torch import config as tcfg
from diffusionkit_tpu_torch.convert import mmdit_from_jax, t5_from_jax
from diffusionkit_tpu_torch.ops import fused_quant as tfq
from diffusionkit_tpu_torch.ops import quantized as tq
from diffusionkit_tpu_torch.ops import smoothquant as tsq
from diffusionkit_tpu_torch.ops import w4a8_matmul as tw
from diffusionkit_tpu_torch.ops import w8a8 as tw8
from diffusionkit_tpu_torch.ops.common import linear
from diffusionkit_tpu_torch.pipeline import DiffusionPipeline

from test_torch_models import randomize, torch_config
from test_torch_w4a8 import assert_close_up_to_flips, relative, t

torch.set_num_threads(1)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126))) - 7)


def int8_flips(got, want):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    return d.max(), (d > 0).mean()


# -- kernel #4 and the widened kernel D ----------------------------------------


@pytest.mark.parametrize("form", ["erf", "tanh"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_quantize_matches_jax(form, dtype, monkeypatch):
    """``gelu_quantize_plain`` against the Pallas ``gelu_quantize``
    (interpret, ragged rows), in both GELU forms: y8 one step apart on at
    most 0.1 % of the elements (exp's and tanh's last bits, XLA's FMA
    contractions), scales within 1e-6."""
    monkeypatch.setenv("DIFFUSIONKIT_TPU_GELU_FORM", form)
    y = (np.random.RandomState(0).randn(3, 37, 512) * 2).astype(np.float32)
    want = jfq.gelu_quantize(jnp.asarray(y, dtype), interpret=True)
    launches = tfq.gelu_quantize.launches
    got = tfq.gelu_quantize(t(y).to(getattr(torch, dtype)), form=form)
    assert tfq.gelu_quantize.launches == launches  # the CPU takes the plain version
    assert got.x8.shape == (3, 37, 512) and got.xscale.shape == (3, 37, 1)
    assert got.orig is None and got.dtype == getattr(torch, dtype)
    worst, share = int8_flips(got.x8.numpy(), want.x8)
    assert worst <= 1 and share <= 1e-3, (worst, share)
    np.testing.assert_allclose(got.xscale.numpy(), np.asarray(want.xscale), rtol=1e-6)
    with pytest.raises(ValueError, match="form"):
        tfq.gelu_quantize(t(y), form="sigmoid")


@pytest.mark.parametrize("shape", [(5, 10240), (3, 12288), (2, 16384)])
def test_quantize_takes_wide_rows(shape):
    """Kernel D's plain version on rows wider than 8192 (T5-XXL's wo input,
    a FLUX w8a8 FFN hidden) against the reference's grid (XLA: exact) and
    its Pallas ``quantize`` (interpret: ``amax / 127`` as a reciprocal
    product there, one fp32 rounding; x8 one step apart on <= 1 %)."""
    y = (np.random.RandomState(1).randn(*shape) * 3).astype(np.float32)
    got = tfq.quantize(t(y).bfloat16())
    x8, xs = jw8.quantize_activations(jnp.asarray(y, jnp.bfloat16))
    np.testing.assert_array_equal(got.x8.numpy(), np.asarray(x8))
    np.testing.assert_array_equal(got.xscale.numpy(), np.asarray(xs))
    want = jfq.quantize(jnp.asarray(y, jnp.bfloat16), interpret=True)
    worst, share = int8_flips(got.x8.numpy(), want.x8)
    assert worst <= 1 and share <= 1e-2
    np.testing.assert_allclose(got.xscale.numpy(), np.asarray(want.xscale), rtol=2.5e-7)


# -- kernel #11 and the w8a8 linear ---------------------------------------------


def w8a8_weights(k, n, seed, bias=True):
    rs = np.random.RandomState(seed)
    p = jw8.w8a8_from_kernel_host((rs.randn(k, n) / np.sqrt(k)).astype(np.float32))
    p = {key: np.asarray(v) for key, v in p.items()}
    p["bias"] = (0.1 * rs.randn(n)).astype(np.float32) if bias else None
    return p


@pytest.mark.parametrize("m,k,n", [(2, 256, 384), (77, 256, 256), (33, 64, 128)])
def test_w8_matmul_plain_matches_jax(m, k, n):
    """``w8_matmul_plain`` against the Pallas ``w8_matmul`` (interpret), at
    the M = 2 GEMV, a ragged M and K = 64 (the SD3 x_embedder). fp32 out:
    XLA may contract ``* ws + b`` into an FMA, one fp32 rounding apart
    (1e-6 of the largest output); bf16 out: one bf16 rounding apart."""
    rs = np.random.RandomState(2)
    p = w8a8_weights(k, n, seed=3)
    x8, xs = (np.asarray(a) for a in jw8.quantize_activations(jnp.asarray(rs.randn(m, k),
                                                                          jnp.float32)))
    tw8_ = t(np.ascontiguousarray(p["w8"].T))
    for out, jout in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        bias = t(p["bias"]).to(out)  # the bias in the model dtype, on both sides
        want = np.asarray(jw.w8_matmul(
            jnp.asarray(x8), jnp.asarray(p["w8"]), jnp.asarray(p["wscale"]), jnp.asarray(xs),
            jnp.asarray(bias.float().numpy()), bm=8, bk=64, bn=128, out_dtype=jout,
            interpret=True), np.float32)
        got = tw.w8_matmul(t(x8), tw8_, t(p["wscale"]), t(xs), bias, out)
        assert got.dtype == out and got.shape == (m, n)
        if out == torch.float32:
            assert relative(got, want) < 1e-6
        else:
            exact = tw.w8_matmul_plain(t(x8), tw8_, t(p["wscale"]), t(xs), bias.float(),
                                       torch.float32).numpy()
            assert np.all(np.abs(got.float().numpy() - want) <= bf16_ulp(exact))


def test_w8_epilogue_order_is_exact():
    """The plain version against a numpy emulation of the kernel's order
    (exact int32 product, then separately rounded fp32 products and sum):
    bit for bit, which is what the card's check asks of kernel #11."""
    rs = np.random.RandomState(4)
    p = w8a8_weights(512, 256, seed=5)
    x8 = rs.randint(-127, 128, size=(40, 512)).astype(np.int8)
    xs = (rs.rand(40, 1) * 0.02 + 1e-3).astype(np.float32)
    acc = (x8.astype(np.int64) @ p["w8"].astype(np.int64)).astype(np.float32)
    want = acc * xs * p["wscale"] + p["bias"]
    got = tw.w8_matmul_plain(t(x8), t(np.ascontiguousarray(p["w8"].T)), t(p["wscale"]), t(xs),
                             t(p["bias"]), torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,k", [(2, 256), (7, 64), (19, 384)])
def test_w8a8_linear_matches_jax(m, k):
    """``w8a8_linear`` (a float input quantized by kernel D's plain
    version, or a shared ``ActQuant``) against the JAX ``w8a8_linear``:
    the same grid, the same exact product; one fp32 rounding apart (1e-6),
    and with ``act="gelu"`` the GELU in fp32 before the rounding."""
    p = w8a8_weights(k, 256, seed=6)
    layer = tw8.W8A8Linear.from_host(p, torch.float32, device="cpu")
    x = np.random.RandomState(7).randn(m, k).astype(np.float32)
    jp = {key: jnp.asarray(v) for key, v in p.items()}
    want = jw8.w8a8_linear(jp, jnp.asarray(x))
    assert relative(linear(layer, t(x)), want) < 1e-6
    assert relative(linear(layer, tw8.quantize_shared(t(x))), want) < 1e-6
    want = jw8.w8a8_linear(jp, jnp.asarray(x), act="gelu")
    assert relative(linear(layer, t(x), act="gelu"), want) < 1e-6
    assert tw8.needs_act_quant(layer) and tw8.is_w8a8(layer)


@pytest.mark.parametrize("m,k,n", [(1, 1536, 384), (2, 256, 1536), (16, 2048, 128),
                                   (3, 128, 256)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_w8_matmul_plain_is_quantize_then_w8_matmul(m, k, n, dtype):
    """The plain version of #11's quantizing GEMV is kernel D's plain
    version then #11's, bit for bit, with and without a bias; on the CPU the
    wrapper runs it and launches nothing."""
    rs = np.random.RandomState(8)
    x = t((rs.randn(m, k) * 3).astype(np.float32)).to(dtype)
    p = w8a8_weights(k, n, seed=9)
    w8, ws = t(np.ascontiguousarray(p["w8"].T)), t(p["wscale"])
    launches = tw.w8_matmul.launches
    for bias in (t(p["bias"]).to(dtype), None):
        aq = tfq.quantize_plain(x)
        want = tw.w8_matmul_plain(aq.x8, w8, ws, aq.xscale, bias, dtype)
        for got in (tw.quantize_w8_matmul_plain(x, w8, ws, bias, dtype),
                    tw.quantize_w8_matmul(x, w8, ws, bias, dtype)):
            assert got.dtype == dtype and torch.equal(got, want)
    assert tw.w8_matmul.launches == launches


@pytest.mark.parametrize("m", [1, 2, 16])
def test_w8a8_linear_at_gemv_rows_matches_jax(m):
    """``w8a8_linear`` at the rows of the `ada` and embedder projections
    (M = 1 without CFG, 2 with it, 16 the most the GEMV takes), where a
    float input goes to #11's quantizing GEMV, against the JAX
    ``w8a8_linear`` on the same numpy-seeded weights: one fp32 rounding
    apart (1e-6), and in bf16 one bf16 rounding of the exact fp32 value."""
    k, n = 1536, 384
    assert tw.w8_quantizes_in_gemv(m, k, n)
    p = w8a8_weights(k, n, seed=10)
    x = (np.random.RandomState(11).randn(m, k) * 2).astype(np.float32)
    jp = {key: jnp.asarray(v) for key, v in p.items()}
    layer = tw8.W8A8Linear.from_host(p, torch.float32, device="cpu")
    assert relative(linear(layer, t(x)), jw8.w8a8_linear(jp, jnp.asarray(x))) < 1e-6
    assert relative(linear(layer, t(x), act="gelu"),
                    jw8.w8a8_linear(jp, jnp.asarray(x), act="gelu")) < 1e-6
    layer16 = tw8.W8A8Linear.from_host(p, torch.bfloat16, device="cpu")
    xb = t(x).bfloat16()
    got = linear(layer16, xb)
    jp["bias"] = jnp.asarray(layer16.bias.float().numpy())  # the bias in the model dtype
    want = np.asarray(jw8.w8a8_linear(jp, jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)),
                      np.float32)
    aq = tfq.quantize_plain(xb)
    exact = tw.w8_matmul_plain(aq.x8, layer16.w8, layer16.wscale, aq.xscale,
                               layer16.bias.float(), torch.float32).numpy()
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert np.all(np.abs(got.float().numpy() - want) <= bf16_ulp(exact))


# -- host and device conversions ------------------------------------------------


def test_w8a8_host_conversions_are_bit_identical():
    rs = np.random.RandomState(8)
    w = rs.randn(256, 192).astype(np.float32)
    want = jw8.w8a8_from_kernel_host(w)
    got = tw8.w8a8_from_kernel_host(w)
    for key in ("w8", "wscale"):
        assert got[key].dtype == np.asarray(want[key]).dtype
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    for bits in (4, 8):
        packed = {key: np.asarray(v) for key, v in
                  jq.quantize_kernel_host(w, bits, 32, refine=False).items()}
        packed["bias"] = rs.randn(192).astype(np.float32)
        want = jw8.w8a8_from_quantized_host(packed)
        got = tw8.w8a8_from_quantized_host(packed)
        for key in ("w8", "wscale", "bias"):
            np.testing.assert_array_equal(got[key], np.asarray(want[key]))


def test_w8a8_module_matches_w8a8_tree():
    """``w8a8_module_`` (on the layer's device) against the reference's host
    ``w8a8_tree`` on the same float tree, leaf for leaf: the w8a8 grid of a
    float linear, and of a packed int4 one, bit for bit; a linear below
    ``min_size`` stays float. Then the random w8a8 init."""
    jcfg = dataclasses.replace(JAX_SD3, depth_multimodal=2, num_heads=2, hidden_size_override=256,
                               max_latent_resolution=16, pooled_text_embed_dim=32,
                               dtype=jnp.float32)
    params = randomize(init_mmdit_params(jax.random.PRNGKey(0), jcfg), seed=9)
    cfg = torch_config(jcfg, tcfg.MMDiTConfig)
    model = tw8.w8a8_module_(mmdit_from_jax(params, cfg, device="cpu"))
    want = mmdit_from_jax(jw8.w8a8_tree(params), cfg, device="cpu").state_dict()
    got = model.state_dict()
    assert set(got) == set(want)
    for key in got:
        assert torch.equal(got[key], want[key]), key
    assert isinstance(model.context_embedder, tw8.W8A8Linear)
    assert not isinstance(model.x_embedder, tw8.W8A8Linear)  # 64 x 256 < min_size

    packed = {key: np.asarray(v) for key, v in jq.quantize_kernel_host(
        np.random.RandomState(10).randn(256, 256).astype(np.float32), 4, 64, refine=False).items()}
    layer = tw8.w8a8_layer(tq.QuantizedLinear.from_host(packed, torch.float32, device="cpu"))
    want = jw8.w8a8_from_quantized_host(packed)
    np.testing.assert_array_equal(layer.w8.numpy().T, want["w8"])
    np.testing.assert_array_equal(layer.wscale.numpy(), want["wscale"])

    a, b = (tw8.random_w8a8_linear_(tw8.W8A8Linear(256, 128, dtype=torch.float32),
                                    torch.Generator().manual_seed(0)) for _ in range(2))
    assert torch.equal(a.w8, b.w8) and a.w8.min() == -127 and a.w8.max() == 127
    assert torch.all(a.wscale == np.float32(0.02 / 127)) and torch.all(a.bias == 0)


def test_convert_carries_integer_leaves_bit_for_bit():
    """``w8`` (int8, transposed) and ``q8`` (uint8, every value above 127
    included) leaves through ``convert.py``, never through a float."""
    jcfg = JaxT5Config(vocab_size=64, d_model=256, d_kv=64, d_ff=512, num_layers=2, num_heads=4)
    tree = jw8.w8a8_tree(randomize(init_t5_params(jax.random.PRNGKey(0), jcfg), seed=11))
    model = t5_from_jax(tree, torch_config(jcfg, tcfg.T5Config), device="cpu")
    for i in range(2):
        for name in ("query_proj", "wi_0", "wo"):
            layer = getattr(model.layers[i], name)
            assert isinstance(layer, tw8.W8A8Linear) and layer.w8.dtype == torch.int8
            np.testing.assert_array_equal(layer.w8.numpy().T, tree["layers"][name]["w8"][i])
    q8 = {key: np.asarray(v) for key, v in jq.quantize_kernel_host(
        np.random.RandomState(12).randn(256, 256).astype(np.float32), 8, 32, refine=False).items()}
    assert q8["q8"].max() == 255 and q8["q8"].dtype == np.uint8
    layer = tq.QuantizedLinear.from_host(q8, torch.float32, device="cpu")
    assert layer.bits == 8 and layer.q8.dtype == torch.uint8
    np.testing.assert_array_equal(layer.q8.numpy(), q8["q8"])


# -- the tiny SD3 w8a8 model and pipeline ----------------------------------------


def tiny_sd3(pooled_text_embed_dim=32):
    return dataclasses.replace(JAX_SD3, depth_multimodal=2, num_heads=2,
                               hidden_size_override=256, max_latent_resolution=16,
                               pooled_text_embed_dim=pooled_text_embed_dim, dtype=jnp.float32)


@pytest.fixture
def jax_fused(monkeypatch):
    """The JAX package's fused quantizers in interpret mode (its TPU
    dispatch); yields the names of the quantizing calls of both sides."""
    monkeypatch.setenv("DIFFUSIONKIT_TPU_FUSED_QUANT", "interpret")
    jax.clear_caches()
    calls = {"jax": [], "port": []}

    def record(module, name, side, label):
        orig = getattr(module, name)

        def recorded(*a, **kw):
            calls[side].append(label)
            return orig(*a, **kw)

        monkeypatch.setattr(module, name, recorded)

    for name, label in (("w8a8_linear", "w8"), ("quantize_activations", "quantize")):
        record(jw8, name, "jax", label)
    for name, label in (("gelu_quantize", "gelu_quantize"), ("mod_ln_quantize", "mod_ln_quantize")):
        record(jfq, name, "jax", label)
    for name, label in (("w8_matmul_plain", "w8"), ):
        record(tw, name, "port", label)
    for name, label in (("quantize_plain", "quantize"), ("gelu_quantize_plain", "gelu_quantize"),
                        ("mod_ln_quantize_plain", "mod_ln_quantize")):
        record(tfq, name, "port", label)
    yield calls
    jax.clear_caches()


def sd3_counts(calls):
    return {k: calls.count(k) for k in ("w8", "quantize", "gelu_quantize", "mod_ln_quantize")}


def test_sd3_w8a8_mmdit_matches_jax(jax_fused):
    """A tiny SD3 MMDiT converted to w8a8 (``w8a8_module_``) against the JAX
    ``apply_mmdit`` on the ``w8a8_tree`` of the same float weights, under
    its TPU dispatch: the same number of w8a8 products, activation
    quantizations, GELU quantizations and quantizing AdaLN sites; outputs
    as the w4a8 model test bounds them (fp32 both sides; XLA's FMA
    contractions move an int8 activation by one step now and then)."""
    jcfg = tiny_sd3()
    params = randomize(init_mmdit_params(jax.random.PRNGKey(0), jcfg), seed=13)
    model = tw8.w8a8_module_(mmdit_from_jax(params, torch_config(jcfg, tcfg.MMDiTConfig),
                                            device="cpu"))
    rs = np.random.RandomState(14)
    args = [rs.randn(2, 8, 8, 16).astype(np.float32), rs.randn(2, 7, 4096).astype(np.float32),
            rs.randn(2, 32).astype(np.float32), np.array([700.0, 700.0], np.float32)]
    want = np.asarray(apply_mmdit(jw8.w8a8_tree(params), jcfg, *map(jnp.asarray, args)))
    with torch.no_grad():
        got = model(*map(t, args)).numpy()
    port, ref = sd3_counts(jax_fused["port"]), sd3_counts(jax_fused["jax"])
    # Per forward: 5 w8a8 embedder and final-layer linears (the x_embedder,
    # y_embedder.fc1 and final linear are below min_size), 14 in the
    # uniform block and 11 in the final block; a float input quantized
    # before 5 + 4 + 3 of them; quantizing AdaLN sites 4 + 3 (the final
    # layer's linear stays float).
    assert port == ref == {"w8": 30, "quantize": 12, "gelu_quantize": 3, "mod_ln_quantize": 7}
    assert got.shape == (2, 8, 8, 16)
    assert_close_up_to_flips(got, want, q90=3e-3)


def test_sd3_w8a8_pipeline_matches_jax(jax_fused):
    """``DiffusionPipeline(quantize_mmdit="w8a8")`` converts an assigned
    float MMDiT as the reference's quantize-at-load does (``w8a8_tree``),
    and two CFG Euler steps agree with the JAX pipeline on those weights as
    the model test bounds its outputs."""
    from test_torch_pipeline import NEGATIVE, PROMPT, SEED, build_pipelines

    jp, tp = build_pipelines()
    jcfg = tiny_sd3(pooled_text_embed_dim=16)
    float_params = randomize(init_mmdit_params(jax.random.PRNGKey(0), jcfg), seed=15)
    jp.mmdit_params, jp.mmdit_config = jw8.w8a8_tree(float_params), jcfg
    qp = DiffusionPipeline(load=False, low_memory_mode=False,
                           shift=3.0, use_t5=False, a16=False, device="cpu",
                           quantize_mmdit="w8a8")
    for name in ("clip_l", "clip_g", "decoder", "tokenizer_l", "tokenizer_g"):
        setattr(qp, name, getattr(tp, name))
    qp.mmdit = mmdit_from_jax(float_params, torch_config(jcfg, tcfg.MMDiTConfig), device="cpu")
    assert isinstance(qp.mmdit.mm_blocks[0].img.fc1, tw8.W8A8Linear)
    kw = dict(num_steps=2, cfg_weight=5.0, latent_size=(8, 8), seed=SEED)
    jc, jpool = jp.encode_text(PROMPT, 5.0, NEGATIVE)
    tc, tpool = qp.encode_text(PROMPT, 5.0, NEGATIVE)
    jlat, _ = jp.denoise_latents(jc, jpool, **kw)
    tlat, _ = qp.denoise_latents(tc, tpool, **kw)
    assert np.abs(np.asarray(jlat)).max() > 0.5
    assert_close_up_to_flips(tlat.numpy(), np.asarray(jlat), q90=3e-3)
    assert sd3_counts(jax_fused["port"])["gelu_quantize"] == 2 * 3


# -- SmoothQuant and the w8a8 T5 -------------------------------------------------


T5_TINY = JaxT5Config(vocab_size=64, d_model=256, d_kv=64, d_ff=512, num_layers=2, num_heads=4)


def outlier_t5(seed):
    """A tiny T5 whose residual stream has outlier channels (as T5-XXL's):
    a few embedding columns 30x the rest, so the fold has work to do."""
    params = randomize(init_t5_params(jax.random.PRNGKey(0), T5_TINY), seed=seed)
    wte = np.array(params["wte"])
    wte[:, [3, 77, 200]] *= 30.0
    params["wte"] = wte
    return params


class Tok:
    def tokenize(self, text):
        return [(ord(c) % 60) + 1 for c in text[:40]] + [1]


@pytest.mark.parametrize("tokenizer", [None, Tok()])
def test_smooth_t5_matches_jax(tokenizer):
    """The port's fold (per layer, fp32, in place) against the JAX
    ``smooth_t5`` (host numpy, stacked) on the same tiny T5 with outlier
    channels, with a tokenizer and with the deterministic token fallback:
    every folded weight within fp32 rounding of the calibration sums
    (rtol 1e-5)."""
    params = outlier_t5(16)
    want = jsq.smooth_t5(params, T5_TINY, tokenizer)
    model = t5_from_jax(params, torch_config(T5_TINY, tcfg.T5Config), device="cpu")
    tsq.smooth_t5(model, tokenizer)
    for i, layer in enumerate(model.layers):
        for name in ("ln1", "ln2"):
            np.testing.assert_allclose(getattr(layer, name).weight.detach().numpy(),
                                       np.asarray(want["layers"][name]["weight"][i]), rtol=1e-5)
        for name in ("query_proj", "key_proj", "value_proj", "out_proj", "wi_0", "wi_1", "wo"):
            np.testing.assert_allclose(getattr(layer, name).weight.detach().numpy().T,
                                       np.asarray(want["layers"][name]["kernel"][i]),
                                       rtol=1e-5, atol=1e-9)
    # The fold is exact in float: the smoothed fp32 encoder is the original.
    tokens = np.random.RandomState(17).randint(1, 64, size=(2, 12))
    ref = np.asarray(apply_t5_encoder(params, jnp.asarray(tokens), T5_TINY))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_w8a8_t5_matches_jax(jax_fused):
    """The smoothed tiny T5 in w8a8 (``w8a8_module_``) against the JAX
    encoder on ``w8a8_tree(smooth_t5(params))``, under the reference's
    fused quantizers: 7 w8a8 products and 4 activation quantizations a
    layer on both sides; outputs up to int8 flips. The fold shrinks the
    w8a8 error against the float encoder."""
    params = outlier_t5(18)
    cfg = torch_config(T5_TINY, tcfg.T5Config)
    smoothed = jsq.smooth_t5(params, T5_TINY)
    tokens = np.random.RandomState(19).randint(1, 64, size=(2, 12))
    want = np.asarray(apply_t5_encoder(jw8.w8a8_tree(smoothed), jnp.asarray(tokens), T5_TINY))
    model = tw8.w8a8_module_(tsq.smooth_t5(t5_from_jax(params, cfg, device="cpu")))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    # The JAX encoder scans its layers: one traced layer's calls.
    port, ref = sd3_counts(jax_fused["port"]), sd3_counts(jax_fused["jax"])
    assert port["w8"] == 2 * ref["w8"] == 14 and port["quantize"] == 2 * ref["quantize"] == 8
    assert_close_up_to_flips(got, want, q90=3e-3)

    plain = tw8.w8a8_module_(t5_from_jax(params, cfg, device="cpu"))
    float_out = np.asarray(apply_t5_encoder(params, jnp.asarray(tokens), T5_TINY))
    with torch.no_grad():
        unsmoothed = plain(torch.from_numpy(tokens)).numpy()
    err = lambda a: np.linalg.norm(a - float_out) / np.linalg.norm(float_out)  # noqa: E731
    assert err(got) < err(unsmoothed)


def test_flux_pipeline_quantize_t5_matches_jax(jax_fused):
    """``FluxPipeline(quantize_t5=True)``: assigning the T5 smooths it with
    the pipeline's tokenizer and converts it to w8a8, as the reference's
    loader does; the text conditioning against the JAX pipeline's on the
    same quantized tree, up to int8 flips; a whole ``generate_image``."""
    from test_pipeline import TinyT5Tokenizer, build_flux_pipeline, make_tiny_clip_tokenizer

    from diffusionkit_tpu_torch.convert import clip_from_jax, vae_decoder_from_jax
    from diffusionkit_tpu_torch.pipeline import FluxPipeline
    from diffusionkit_tpu_torch.tokenizer import CLIPTokenizer
    from test_torch_w4a8 import tiny_w4a8_flux

    jp = build_flux_pipeline()
    jp.activation_dtype = jnp.float32
    jcfg = tiny_w4a8_flux(token_level_text_embed_dim=256, pooled_text_embed_dim=8)
    jp.mmdit_config = jcfg
    jp.mmdit_params = randomize(init_mmdit_params(jax.random.PRNGKey(0), jcfg), 20)
    jp.clip_l = randomize(jp.clip_l, 21)
    jp.decoder_params = randomize(jp.decoder_params, 22)
    t5_float = outlier_t5(23)
    jp.t5_config = T5_TINY
    jp.t5_params = jw8.w8a8_tree(jsq.smooth_t5(t5_float, T5_TINY, TinyT5Tokenizer()))

    tp = FluxPipeline(load=False, low_memory_mode=False, a16=False, device="cpu", quantize_t5=True)
    tp.t5_tokenizer = TinyT5Tokenizer()
    tp.t5 = t5_from_jax(t5_float, torch_config(T5_TINY, tcfg.T5Config), device="cpu")
    assert isinstance(tp.t5.layers[1].wo, tw8.W8A8Linear)
    tp.clip_l = clip_from_jax(jp.clip_l, torch_config(jp.clip_l_config, tcfg.CLIPTextModelConfig),
                              device="cpu")
    tp.mmdit = mmdit_from_jax(jp.mmdit_params, torch_config(jcfg, tcfg.MMDiTConfig), device="cpu")
    tp.decoder = vae_decoder_from_jax(
        jp.decoder_params, torch_config(jp.decoder_config, tcfg.VAEDecoderConfig), device="cpu")
    jtok = make_tiny_clip_tokenizer()
    tp.tokenizer_l = CLIPTokenizer({}, jtok.vocab, pad_with_eos=jtok.pad_with_eos)
    tp.tokenizer_l.max_length = jtok.max_length

    jc, _ = jp.encode_text("a dog", cfg_weight=0.0)
    tc, _ = tp.encode_text("a dog", cfg_weight=0.0)
    assert tuple(tc.shape) == (1, 256, 256)
    assert_close_up_to_flips(tc.numpy(), np.asarray(jc), q90=3e-3)
    timg, log = tp.generate_image("a dog", num_steps=2, cfg_weight=0.0, latent_size=(8, 8),
                                  seed=11, verbose=False)
    assert np.asarray(timg).shape == (64, 64, 3) and len(log["denoising"]["iter_time"]) == 2
