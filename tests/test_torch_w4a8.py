"""The w4a8 path of the PyTorch port against the JAX package.

Kernels A' (``mod_ln_quantize``), D (``quantize``) and E (``w4a8_matmul`` in
its four modes) through their plain versions, the w4a8 linears, the host
``wscale`` helpers, ``convert.py`` and a tiny FLUX w4a8 MMDiT and
``FluxPipeline(quantize_mmdit="w4a8")``. Inputs come from numpy seeds; the
JAX Pallas kernels run with ``interpret=True``.

The JAX package computes a w4a8 model as int4 weight-only on a CPU backend
(its dispatch gates on ``jax.default_backend()``). The model-level tests
force its TPU dispatch with ``monkeypatch`` alone (fixture
``jax_tpu_dispatch``): the fused quantizers in interpret mode, the backend
reported as "tpu", and every ``w4a8_matmul`` call given ``interpret=True``.
The FFN scale tile is pinned to the port's 512 with the reference's own
``DIFFUSIONKIT_TPU_FFN_BN1`` knob (its CPU pick is 1024 at these widths).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionkit_tpu.config import FLUX_SCHNELL as JAX_FLUX
from diffusionkit_tpu.models import init_mmdit_params
from diffusionkit_tpu.models import mmdit as jax_mmdit
from diffusionkit_tpu.ops import common as jax_common
from diffusionkit_tpu.ops import fused_quant as jfq
from diffusionkit_tpu.ops import w4a8_matmul as jw
from diffusionkit_tpu.ops.quantized import quantize_kernel_host as jax_quantize_kernel_host
from diffusionkit_tpu.ops.rope import rope_frequencies as jax_rope_frequencies
from diffusionkit_tpu.ops.w8a8 import quantize_activations as jax_quantize_activations
from diffusionkit_tpu_torch import config as tcfg
from diffusionkit_tpu_torch.convert import mmdit_from_jax
from diffusionkit_tpu_torch.ops import fused_quant as tfq
from diffusionkit_tpu_torch.ops import quantized as tq
from diffusionkit_tpu_torch.ops import w4a8_matmul as tw
from diffusionkit_tpu_torch.ops.common import ffn_gelu, linear
from diffusionkit_tpu_torch.ops.rope import rope_frequencies
from diffusionkit_tpu_torch.ops.w8a8 import quantize_activations, quantize_shared
from diffusionkit_tpu_torch.pipeline import FluxPipeline

from test_torch_flux import randomize_packed, with_unit_qk_scales
from test_torch_models import randomize, torch_config

torch.set_num_threads(1)


def packed(k, n, group=64, seed=0, bias=True):
    """Reference-quantized (min/max grid) weights with exact ``wscale`` and a
    bias, as host arrays."""
    rs = np.random.RandomState(seed)
    p = {key: np.asarray(v) for key, v in jax_quantize_kernel_host(
        (rs.randn(k, n) / np.sqrt(k)).astype(np.float32), 4, group, refine=False).items()}
    p["wscale"] = np.asarray(jw.wscale_from_q4_host(p))
    p["bias"] = (0.1 * rs.randn(n)).astype(np.float32) if bias else None
    return p


def layer_of(p):
    return tq.QuantizedLinear.from_host(p, torch.float32, device="cpu")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def relative(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


def assert_close_up_to_flips(got, want, worst=1e-2, q90=1e-5):
    """Model-level agreement of two fp32 w4a8 computations that round some
    activation to int8 at a different step: XLA contracts some epilogue
    products into FMAs, so a value at a rounding boundary moves by one int8
    step, which moves the outputs it feeds by up to ~1/127 of their row's
    range. Nine in ten elements must agree to ``q90`` of the largest
    |want| (a wrong epilogue or layout moves most elements), and the worst
    to ``worst``, a quarter of the w4a8 quantization error itself (1.2e-2
    relative against the float path at the block test's shapes). Through
    several blocks, attention spreads each flip over every token: the
    whole model is held with ``q90=3e-3``, still under the quantization
    error."""
    diff = np.abs(np.asarray(got) - np.asarray(want)) / np.abs(np.asarray(want)).max()
    assert diff.max() < worst and np.quantile(diff, 0.9) < q90, (diff.max(),
                                                                  np.quantile(diff, 0.9))


# -- kernels A' and D --------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_jax(dtype):
    """Kernel D's plain version against the reference's grid
    (``quantize_activations``, XLA): max, IEEE division and round-half-even
    are exact in any order, so x8 and the scales are equal. Against the
    Pallas ``quantize`` (interpret, ragged rows), whose ``amax / 127``
    lowers to a product with the reciprocal there: scales one fp32 rounding
    apart, x8 one step apart on at most 1 % of the elements."""
    y = (np.random.RandomState(0).randn(3, 37, 256) * 3).astype(np.float32)
    got = tfq.quantize(t(y).to(getattr(torch, dtype)))
    assert got.x8.dtype == torch.int8 and got.xscale.shape == (3, 37, 1)
    assert got.orig is None and got.dtype == getattr(torch, dtype)
    x8, xs = jax_quantize_activations(jnp.asarray(y, dtype))
    np.testing.assert_array_equal(got.x8.numpy(), np.asarray(x8))
    np.testing.assert_array_equal(got.xscale.numpy(), np.asarray(xs))
    want = jfq.quantize(jnp.asarray(y, dtype), interpret=True)
    diff = np.abs(got.x8.numpy().astype(int) - np.asarray(want.x8).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-2
    np.testing.assert_allclose(got.xscale.numpy(), np.asarray(want.xscale), rtol=2.5e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mod_ln_quantize_matches_jax(dtype):
    """Kernel A''s plain version against the Pallas ``mod_ln_quantize``
    (ragged rows). The LayerNorm's sums run in another order, so x8 may
    differ by one step where the fp32 value sits at a rounding boundary:
    at most 1, on at most 1 % of the elements; scales within 1e-6."""
    rs = np.random.RandomState(1)
    x = (rs.randn(2, 45, 256) * 2 + 0.5).astype(np.float32)
    sh, sc = (rs.randn(2, 1, 256).astype(np.float32) for _ in range(2))
    jd = jnp.dtype(dtype)
    want = jfq.mod_ln_quantize(*(jnp.asarray(a, jd) for a in (x, sh, sc)), interpret=True)
    td = getattr(torch, dtype)
    got = tfq.mod_ln_quantize(*(t(a).to(td) for a in (x, sh, sc)))
    assert got.x8.shape == (2, 45, 256) and got.xscale.shape == (2, 45, 1) and got.orig is None
    diff = np.abs(got.x8.numpy().astype(int) - np.asarray(want.x8).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-2, (diff.max(), (diff > 0).mean())
    np.testing.assert_allclose(got.xscale.numpy(), np.asarray(want.xscale), rtol=1e-6)


def test_actquant_float_view_and_sharing():
    y = t(np.random.RandomState(2).randn(4, 256).astype(np.float32))
    aq = quantize_shared(y)
    assert aq.orig is y and quantize_shared(aq) is aq and aq.to_float() is y
    fused = tfq.quantize(y)
    torch.testing.assert_close(fused.to_float(), fused.x8.float() * fused.xscale)
    x8, xs = quantize_activations(y)
    assert torch.equal(x8, aq.x8) and torch.equal(xs, aq.xscale)


# -- kernel E ------------------------------------------------------------------


def test_requant_w8_matches_dequant_w8():
    """The int8 grid against the reference's ``dequant_w8``. Scales stored as
    f16 make dyadic products, so exact .5 ties are systematic: XLA may
    contract ``q * s8 + z8`` into one FMA, which rounds ties apart from the
    port's product-then-sum. The port must equal the two-rounding numpy
    emulation bit for bit, and JAX one of the two emulations."""
    p = packed(256, 128, group=32, seed=3)
    p["scales"] = p["scales"].astype(np.float16).astype(np.float32)
    p["zeros"] = p["zeros"].astype(np.float16).astype(np.float32)
    p["wscale"] = np.asarray(jw.wscale_from_q4_host(p))
    s8, z8 = tw.scaled_affine(t(p["scales"]), t(p["zeros"]), t(p["wscale"]))
    js8, jz8, _, _ = jw._scaled_affine({k: jnp.asarray(v) for k, v in p.items()
                                        if v is not None})
    np.testing.assert_array_equal(s8.numpy(), np.asarray(js8))
    np.testing.assert_array_equal(z8.numpy(), np.asarray(jz8))
    got = tw.requant_w8_plain(t(p["q4"].view(np.int32)), s8, z8).numpy()
    q = np.stack([(p["q4"] >> np.uint32(4 * j)) & np.uint32(0xF) for j in range(8)], 1)
    q = q.reshape(-1, 128).astype(np.float32)
    s, z = np.repeat(s8.numpy(), 32, 0), np.repeat(z8.numpy(), 32, 0)
    two = np.clip(np.round(q * s + z), -127, 127)
    fma = np.clip(np.round((q.astype(np.float64) * s + z).astype(np.float32)), -127, 127)
    np.testing.assert_array_equal(got, two)
    want = np.asarray(jw.dequant_w8(jnp.asarray(p["q4"]), js8, jz8))
    assert np.array_equal(want, two) or np.array_equal(want, fma)


def mode_inputs(mode, m, k=1024, n=1024, group=64, seed=4):
    rs = np.random.RandomState(seed)
    p = packed(k, n, group, seed)
    x8, xs = jax_quantize_activations(jnp.asarray(rs.randn(m, k).astype(np.float32)))
    x8, xs = np.asarray(x8), np.asarray(xs)
    extra, textra = {}, {}
    if mode == "grouped_xs":
        xs = (rs.rand(m, k // 512) * 0.02 + 0.001).astype(np.float32)
    if mode == "norm_rope":
        nw = (rs.rand(128) + 0.5).astype(np.float32)
        ang = (rs.rand(m, 64) * 6.28).astype(np.float32)
        c, s = np.cos(ang), np.sin(ang)
        extra = dict(norm_w=jnp.tile(jnp.asarray(nw), n // 128),
                     rope_cs=jnp.asarray(np.concatenate([c, c, -s, s], -1)))
        textra = dict(norm_w=t(nw), cos=t(c), sin=t(s))
    return p, x8, xs, extra, textra


@pytest.mark.parametrize("m", [1, 77])
@pytest.mark.parametrize("mode", ["plain", "norm_rope", "gelu_quant", "grouped_xs"])
def test_w4a8_matmul_plain_matches_jax(mode, m):
    """``w4a8_matmul_plain`` against the Pallas kernel (interpret) at
    bk = bn = 512, the scale tile the port fixes. XLA may contract the
    epilogue's ``* ws + b`` into an FMA: one fp32 rounding apart, 1e-6 of
    the largest output; norm_rope adds the order of its 128-term mean and
    rsqrt's rounding, still under 1e-6 relative. gelu_quant's int8 output
    may move one step on at most 0.1 % of the elements (exp's last bit and
    the scale); its scales within 1e-6."""
    p, x8, xs, extra, textra = mode_inputs(mode, m)
    s8, z8, ws, bias = jw._scaled_affine({k: jnp.asarray(v) for k, v in p.items()})
    xs_j = jnp.repeat(jnp.asarray(xs), 128, axis=1) if mode == "grouped_xs" else jnp.asarray(xs)
    want = jw.w4a8_matmul(jnp.asarray(x8), jnp.asarray(p["q4"]), s8, z8, ws, xs_j, bias,
                          bm=8, bk=512, bn=512, out_dtype=jnp.float32, interpret=True,
                          mode=mode, **extra)
    got = tw.w4a8_matmul(t(x8), t(p["q4"].view(np.int32)), t(p["scales"]), t(p["zeros"]),
                         t(p["wscale"]), t(xs), t(p["bias"]), mode=mode,
                         out_dtype=torch.float32, **textra)
    if mode == "gelu_quant":
        y8, ysc = np.asarray(want[0])[:m], np.asarray(want[1])[:m, ::128]
        assert got[0].dtype == torch.int8 and got[1].shape == (m, 2)
        diff = np.abs(got[0].numpy().astype(int) - y8.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        np.testing.assert_allclose(got[1].numpy(), ysc, rtol=1e-6)
        return
    assert got.shape == (m, 1024) and got.dtype == torch.float32
    assert relative(got, want) < 1e-6


@pytest.mark.parametrize("mode", ["plain", "grouped_xs"])
def test_w4a8_epilogue_order_is_exact(mode):
    """plain and grouped_xs against a numpy emulation of the kernel's exact
    order (int32 product, then separately rounded fp32 products and sums):
    bit for bit, which is what the card's check asks of the kernel."""
    p, x8, xs, _, _ = mode_inputs(mode, 40, seed=5)
    s8, z8 = tw.scaled_affine(t(p["scales"]), t(p["zeros"]), t(p["wscale"]))
    w8 = tw.requant_w8_plain(t(p["q4"].view(np.int32)), s8, z8).numpy().astype(np.int64)
    x = x8.astype(np.int64)
    if mode == "plain":
        y = (x @ w8).astype(np.float32) * xs * p["wscale"] + p["bias"]
    else:
        acc = np.zeros((40, 1024), np.float32)
        for kg in range(2):
            ks = slice(512 * kg, 512 * (kg + 1))
            acc = acc + (x[:, ks] @ w8[ks]).astype(np.float32) * xs[:, kg : kg + 1]
        y = acc * p["wscale"] + p["bias"]
    got = tw.w4a8_matmul(t(x8), t(p["q4"].view(np.int32)), t(p["scales"]), t(p["zeros"]),
                         t(p["wscale"]), t(xs), t(p["bias"]), mode=mode, out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), y)


def test_w4a8_linears_match_jax(monkeypatch):
    """``w4a8_linear``, ``w4a8_qk_linear`` and ``w4a8_ffn_gelu`` against their
    JAX namesakes (interpret), float and pre-quantized inputs, group 32 and
    64. Tolerances as for the kernel modes; the FFN adds gelu_quant's
    one-step flips, well under 1e-4 of the output."""
    rs = np.random.RandomState(6)
    x = rs.randn(2, 9, 256).astype(np.float32)
    for group in (32, 64):
        p = packed(256, 256, group, seed=7)
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        layer = layer_of(p)
        want = jw.w4a8_linear(jp, jnp.asarray(x), interpret=True)
        assert relative(tw.w4a8_linear(layer, t(x)), want) < 1e-6
        assert relative(linear(layer, quantize_shared(t(x))), want) < 1e-6

        nw = (rs.rand(128) + 0.5).astype(np.float32)
        ang = (rs.rand(9, 64) * 6.28).astype(np.float32)
        want = jw.w4a8_qk_linear(jp, jnp.asarray(x), jnp.asarray(nw), jnp.asarray(np.cos(ang)),
                                 jnp.asarray(np.sin(ang)), interpret=True)
        got = tw.w4a8_qk_linear(layer, t(x), t(nw), t(np.cos(ang)), t(np.sin(ang)))
        assert got.shape == (2, 9, 256) and relative(got, want) < 1e-6

    fc1, fc2 = packed(256, 1024, 64, seed=8), packed(1024, 256, 32, seed=9)
    l1, l2 = layer_of(fc1), layer_of(fc2)
    assert tw.w4a8_ffn_eligible(l1, l2) and not tw.w4a8_ffn_eligible(l2, l1)
    monkeypatch.setenv("DIFFUSIONKIT_TPU_FFN_BN1", str(tw.SCALE_TILE))
    want = jw.w4a8_ffn_gelu({k: jnp.asarray(v) for k, v in fc1.items()},
                            {k: jnp.asarray(v) for k, v in fc2.items()}, jnp.asarray(x),
                            interpret=True)
    got = tw.w4a8_ffn_gelu(l1, l2, t(x))
    assert got.shape == (2, 9, 256) and relative(got, want) < 1e-4
    assert torch.equal(ffn_gelu(l1, l2, t(x)), got)


def test_ineligible_w4a8_ffn_raises_rather_than_taking_a_float_path(jax_tpu_dispatch,
                                                                   monkeypatch):
    """A w4a8 FFN whose hidden (384) is not a multiple of the 512 scale tile
    takes the reference's ``fc2(gelu_quantize(fc1(x)))`` branch, never a
    float path: kernel E's plain mode twice with kernel #4 between, against
    the JAX ``ffn_gelu`` under its TPU dispatch. Tolerance as the w4a8
    linears' plus gelu_quantize's one-step flips: 1e-4 of the output."""
    p1, p2 = packed(256, 384, 64, seed=10), packed(384, 256, 64, seed=11)
    fc1, fc2 = layer_of(p1), layer_of(p2)
    assert not tw.w4a8_ffn_eligible(fc1, fc2)
    x = np.random.RandomState(12).randn(3, 256).astype(np.float32)
    plain, seen = tfq.gelu_quantize_plain, []
    monkeypatch.setattr(tfq, "gelu_quantize_plain",
                        lambda *a, **kw: seen.append(1) or plain(*a, **kw))
    got = ffn_gelu(fc1, fc2, t(x))
    want = jax_common.ffn_gelu({"fc1": {k: jnp.asarray(v) for k, v in p1.items()},
                                "fc2": {k: jnp.asarray(v) for k, v in p2.items()}}, jnp.asarray(x))
    assert seen == [1] and jax_tpu_dispatch == ["plain", "plain"]
    assert got.shape == (3, 256) and relative(got, want) < 1e-4


def test_wscale_helpers_match_jax():
    p = packed(512, 256, 32, seed=12)
    layer = layer_of({k: v for k, v in p.items() if k != "wscale"})
    assert layer.wscale is None
    np.testing.assert_array_equal(tq.wscale_from_q4(layer).numpy(), p["wscale"])
    want = jw.add_wscale_bound_tree({k: jnp.asarray(v) for k, v in p.items() if k != "wscale"})
    # XLA may contract z + 15 s into an FMA: one fp32 rounding apart.
    np.testing.assert_allclose(tq.add_wscale_bound_(layer).wscale.numpy(),
                               np.asarray(want["wscale"]), rtol=3e-7)
    w = np.random.RandomState(13).randn(128, 64).astype(np.float32)
    host = tq.quantize_kernel_host(w, 32, with_wscale=True)
    np.testing.assert_allclose(host["wscale"], np.asarray(jw.wscale_from_q4_host(host)), rtol=2e-6)
    assert tq.QuantizedLinear.from_host(host, torch.float32, device="cpu").wscale is not None


def test_quantize_mmdit_mode_gate():
    """Every mode of the reference's quantize-at-load is accepted, alone and
    with "-mixed"; an unknown mode raises."""
    for mode in (True, "int4", "int8", "w4a8", "w8a8", "w4a8-mixed", "int4-mixed"):
        pipe = FluxPipeline(load=False, low_memory_mode=False, device="cpu", quantize_mmdit=mode)
        assert pipe.quant_mode in ("int4", "int8", "w4a8", "w8a8")
        assert pipe.quant_mixed == (isinstance(mode, str) and mode.endswith("-mixed"))
    for mode in ("int2", "w8a16", "mixed"):
        with pytest.raises(ValueError):
            FluxPipeline(load=False, low_memory_mode=False, device="cpu", quantize_mmdit=mode)


# -- the tiny FLUX w4a8 model and pipeline -------------------------------------


def tiny_w4a8_flux(**kw):
    return dataclasses.replace(
        JAX_FLUX, depth_multimodal=1, depth_unified=2, num_heads=2, hidden_size_override=256,
        rope_axes_dim=(16, 56, 56), dtype=jnp.float32, **kw)


@pytest.fixture
def jax_tpu_dispatch(monkeypatch):
    """The JAX package's w4a8 dispatch as it runs on a TPU, on the CPU:
    fused quantizers in interpret mode, the backend reported as "tpu", every
    ``w4a8_matmul`` call in interpret mode. Yields the modes of its calls."""
    monkeypatch.setenv("DIFFUSIONKIT_TPU_FUSED_QUANT", "interpret")
    monkeypatch.setenv("DIFFUSIONKIT_TPU_FFN_BN1", str(tw.SCALE_TILE))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    calls = []
    orig = jw.w4a8_matmul

    def interpreted(*args, **kw):
        calls.append(kw.get("mode", "plain"))
        return orig(*args, **{**kw, "interpret": True})

    monkeypatch.setattr(jw, "w4a8_matmul", interpreted)
    yield calls
    jax.clear_caches()  # jit caches do not key on the patched backend


def record_port_modes(monkeypatch):
    modes = []
    orig = tw.w4a8_matmul_plain

    def recorded(*args, **kw):
        modes.append(args[7] if len(args) > 7 else kw.get("mode", "plain"))
        return orig(*args, **kw)

    monkeypatch.setattr(tw, "w4a8_matmul_plain", recorded)
    return modes


def count(modes):
    return [modes.count(m) for m in ("plain", "norm_rope", "gelu_quant", "grouped_xs")]


def w4a8_params(jcfg, seed):
    params = init_mmdit_params(jax.random.PRNGKey(0), jcfg, quantize_bits=4)
    params = randomize_packed(params, seed=seed)
    floats = {k: v for k, v in params.items() if k not in ("mm_blocks", "uni_blocks")}
    params.update(randomize(floats, seed=seed + 1))
    for blocks in (params["mm_blocks"]["img"], params["mm_blocks"]["txt"], params["uni_blocks"]):
        blocks["qk_norm"] = randomize(blocks["qk_norm"], seed=seed + 2)
    return jw.add_wscale_tree(with_unit_qk_scales(params))


def test_flux_w4a8_blocks_and_model_match_jax(jax_tpu_dispatch, monkeypatch):
    """Each block's residual update and the whole tiny model, against the JAX
    package under its TPU dispatch, with the same calls of each kernel E
    mode per block (8/2/2/2 dual-stream, 3/2/1/1 single-stream). Both sides
    are fp32; they differ by FMA contractions in XLA's epilogues, which can
    move an int8 activation one step (``assert_close_up_to_flips``)."""
    jcfg = tiny_w4a8_flux()
    params = w4a8_params(jcfg, seed=20)
    model = mmdit_from_jax(params, torch_config(jcfg, tcfg.MMDiTConfig), device="cpu")
    assert all(layer.wscale is not None for layer in model.modules()
               if isinstance(layer, tq.QuantizedLinear))
    port_modes = record_port_modes(monkeypatch)

    rs = np.random.RandomState(21)
    img, txt = rs.randn(1, 16, 256).astype(np.float32), rs.randn(1, 9, 256).astype(np.float32)
    c = rs.randn(1, 256).astype(np.float32)
    jrope = jax_rope_frequencies((4, 4), 9, jcfg.rope_axes_dim)
    rope = rope_frequencies((4, 4), 9, jcfg.rope_axes_dim)
    bp = jax.tree.map(lambda a: None if a is None else a[0], params["mm_blocks"],
                      is_leaf=lambda a: a is None)
    ji, jt = jax_mmdit._mm_block(bp, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(c), jrope,
                                 jcfg, None)
    with torch.no_grad():
        ti, tt = model.mm_blocks[0](t(img), t(txt), t(c), rope)
    assert count(jax_tpu_dispatch) == count(port_modes) == [8, 2, 2, 2]
    assert_close_up_to_flips(ti - t(img), np.asarray(ji) - img)
    assert_close_up_to_flips(tt - t(txt), np.asarray(jt) - txt)

    del jax_tpu_dispatch[:], port_modes[:]
    u = np.concatenate([txt, img], axis=1)
    up = jax.tree.map(lambda a: None if a is None else a[1], params["uni_blocks"],
                      is_leaf=lambda a: a is None)
    ju = jax_mmdit._unified_block(up, jnp.asarray(u), jnp.asarray(c), jrope, jcfg, None)
    with torch.no_grad():
        tu = model.uni_blocks[1](t(u), t(c), rope)
    assert count(jax_tpu_dispatch) == count(port_modes) == [3, 2, 1, 1]
    assert_close_up_to_flips(tu - t(u), np.asarray(ju) - u)

    args = [rs.randn(1, 8, 8, 16).astype(np.float32), rs.randn(1, 9, 4096).astype(np.float32),
            rs.randn(1, 768).astype(np.float32), np.array([700.0], np.float32)]
    want = np.asarray(jax_mmdit.apply_mmdit(params, jcfg, *map(jnp.asarray, args)))
    with torch.no_grad():
        got = model(*map(t, args)).numpy()
    assert got.shape == (1, 8, 8, 16)
    assert_close_up_to_flips(got, want, q90=3e-3)


def test_flux_w4a8_pipeline_matches_jax(jax_tpu_dispatch):
    """A tiny ``FluxPipeline(quantize_mmdit="w4a8")`` against the JAX
    pipeline under its TPU dispatch, on the same packed weights and bound
    ``wscale``: latents after two Euler steps as the model test bounds its
    outputs; then a whole ``generate_image`` of the port."""
    from test_pipeline import build_flux_pipeline, make_tiny_clip_tokenizer, TinyT5Tokenizer

    from diffusionkit_tpu_torch.convert import clip_from_jax, t5_from_jax, vae_decoder_from_jax
    from diffusionkit_tpu_torch.tokenizer import CLIPTokenizer

    jp = build_flux_pipeline()
    jp.activation_dtype = jnp.float32
    jcfg = tiny_w4a8_flux(token_level_text_embed_dim=8, pooled_text_embed_dim=8)
    jp.mmdit_config = jcfg
    jp.mmdit_params = jw.add_wscale_bound_tree(
        init_mmdit_params(jax.random.PRNGKey(0), jcfg, quantize_bits=4))
    jp.clip_l, jp.t5_params = randomize(jp.clip_l, 1), randomize(jp.t5_params, 2)
    jp.decoder_params = randomize(jp.decoder_params, 4)
    tp = FluxPipeline(load=False, low_memory_mode=False,
                      a16=False, device="cpu", quantize_mmdit="w4a8")
    tp.clip_l = clip_from_jax(
        jp.clip_l, torch_config(jp.clip_l_config, tcfg.CLIPTextModelConfig), device="cpu")
    tp.t5 = t5_from_jax(jp.t5_params, torch_config(jp.t5_config, tcfg.T5Config), device="cpu")
    tp.mmdit = mmdit_from_jax(jp.mmdit_params, torch_config(jcfg, tcfg.MMDiTConfig), device="cpu")
    tp.decoder = vae_decoder_from_jax(
        jp.decoder_params, torch_config(jp.decoder_config, tcfg.VAEDecoderConfig), device="cpu")
    jtok = make_tiny_clip_tokenizer()
    tp.tokenizer_l = CLIPTokenizer({}, jtok.vocab, pad_with_eos=jtok.pad_with_eos)
    tp.tokenizer_l.max_length = jtok.max_length
    tp.t5_tokenizer = TinyT5Tokenizer()
    # The packed model passed through; the bound wscale was kept.
    np.testing.assert_array_equal(
        tp.mmdit.uni_blocks[0].fc1.wscale.numpy(),
        np.asarray(jp.mmdit_params["uni_blocks"]["fc1"]["wscale"][0]))

    kw = dict(num_steps=2, cfg_weight=0.0, latent_size=(8, 8), seed=11)
    jc, jpool = jp.encode_text("a dog", cfg_weight=0.0)
    tc, tpool = tp.encode_text("a dog", cfg_weight=0.0)
    jlat, _ = jp.denoise_latents(jc, jpool, **kw)
    tlat, _ = tp.denoise_latents(tc, tpool, **kw)
    assert np.abs(np.asarray(jlat)).max() > 0.5
    assert_close_up_to_flips(tlat.numpy(), np.asarray(jlat), q90=3e-3)
    timg, log = tp.generate_image("a dog", verbose=False, **kw)
    assert np.asarray(timg).shape == (64, 64, 3) and len(log["denoising"]["iter_time"]) == 2
    assert set(jax_tpu_dispatch) == {"plain", "norm_rope", "gelu_quant", "grouped_xs"}
