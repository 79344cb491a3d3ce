"""The port's quantize-at-load (``ops/gptq.py``, the ALS grid of
``ops/quantized.py``, the pipelines' switches and the disk cache) against
the JAX package's, on the CPU.

- ``calib_batch`` draws the reference's calibration batch bit for bit.
- The ALS grid (``gptq_group`` with U = I, its plain version here) equals
  ``_als_refine_host`` bit for bit: codes, f16 scales and zeros.
- The GPTQ core on the reference's own test matrices: its H-weighted error
  within 1.05x of ``gptq_quantize_kernel`` and ``gptq_quantize_kernel_jax``,
  the schema and ``wscale`` as theirs, and it beats ALS by 10 % on
  correlated inputs; the shared-site concatenation equals separate calls
  bit for bit.
- The float mirror equals the JAX package's ``mirror_forward`` and the
  port's ``MMDiT.forward`` in fp32 (atol 2e-4, rtol 1e-3) on tiny SD3,
  SD3.5-shaped and FLUX configs, its per-site Hessians within 1e-4
  relative Frobenius of the JAX mirror's.
- ``gptq_quantize_mmdit`` (``MIN_SIZE`` / ``MIN_DIM`` lowered in both
  packages, as the JAX test does) packs the linears the JAX tree packs, at
  the same bits, "-mixed" too; its error on ``calib_batch(seed=99)`` within
  1.1x of the JAX GPTQ tree's (carried over by ``convert.mmdit_from_jax``)
  and of the ALS tree's.
- The pipelines: GPTQ by default, then the ALS and min/max switches, int8
  min/max, the fallback; the MMDiT and T5 caches and the T5 SmoothQuant
  switch.

The JAX reference trees are computed once per module.
"""

import copy
import dataclasses

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
from diffusionkit_tpu_torch import config as tcfg
from diffusionkit_tpu_torch import model_io
from diffusionkit_tpu_torch.convert import mmdit_from_jax
from diffusionkit_tpu_torch.models.t5 import T5Encoder
from diffusionkit_tpu_torch.ops import gptq as tg
from diffusionkit_tpu_torch.ops import kernels
from diffusionkit_tpu_torch.ops import quantized as tq
from diffusionkit_tpu_torch.ops.w8a8 import W8A8Linear, w8a8_module_
from diffusionkit_tpu_torch.pipeline import DiffusionPipeline, FluxPipeline

from test_torch_models import randomize, torch_config

torch.set_num_threads(2)

TINY_SD3 = JaxMMDiTConfig(depth_multimodal=3, num_heads=4, hidden_size_override=128,
                          pooled_text_embed_dim=64, token_level_text_embed_dim=96,
                          max_latent_resolution=16, dtype=jnp.float32)
TINY_SD35 = dataclasses.replace(TINY_SD3, use_qk_norm=True, upcast_multimodal_blocks=(1,))
TINY_FLUX = JaxMMDiTConfig(depth_multimodal=2, depth_unified=2, num_heads=4,
                           hidden_size_override=128, patchify_via_reshape=True,
                           pos_embed_type=JaxPE.PreSDPARope, rope_axes_dim=(16, 8, 8),
                           use_qk_norm=True, pooled_text_embed_dim=64,
                           token_level_text_embed_dim=96, dtype=jnp.float32)
# FLUX.1-dev: TINY_FLUX with the guidance embedder (tests/test_torch_loading.py's
# FLUX_DEV_TINY), whose calibration site feeds it 3.5 on both sides.
TINY_FLUX_DEV = dataclasses.replace(TINY_FLUX, guidance_embed=True)
CONFIGS = {"sd3": TINY_SD3, "sd35": TINY_SD35, "flux": TINY_FLUX, "flux_dev": TINY_FLUX_DEV}
CALIB = dict(batch=16, latent_hw=(16, 16))


def port_model(jcfg, params):
    return mmdit_from_jax(params, torch_config(jcfg, tcfg.MMDiTConfig), device="cpu")


def unpack_q4(q4: np.ndarray, k: int) -> np.ndarray:
    shifts = (np.arange(8, dtype=np.uint32) * 4)[None, :, None]
    return ((q4[:, None, :] >> shifts) & np.uint32(0xF)).reshape(k, -1)


def kinds(model):
    """Each linear's form: 4 / 8 (packed), "w4a8" or None (float)."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, tq.QuantizedLinear):
            out[name] = "w4a8" if m.wscale is not None else m.bits
        elif isinstance(m, torch.nn.Linear):
            out[name] = None
    return out


def same_state(a: torch.nn.Module, b: torch.nn.Module) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return set(sa) == set(sb) and all(
        sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]) for k in sa)


def forward(model, ev):
    args = [torch.from_numpy(ev[k]) for k in ("latent", "cond", "pooled", "t")]
    with torch.no_grad():
        return model(*args).float().numpy()


# -- calibration and the ALS grid ---------------------------------------------------


@pytest.mark.parametrize("name", ["sd3", "flux"])
@pytest.mark.parametrize("seed", [0, 99])
def test_calib_batch_is_bit_identical(name, seed):
    jcfg = CONFIGS[name]
    want = jg.calib_batch(jcfg, batch=7, latent_hw=(8, 12), seed=seed)
    got = tg.calib_batch(torch_config(jcfg, tcfg.MMDiTConfig), batch=7, latent_hw=(8, 12),
                         seed=seed)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("k,n,gs", [(256, 384, 32), (512, 200, 64), (384, 128, 128), (64, 96, 32)])
def test_als_grid_is_als_refine_host(k, n, gs):
    """Codes, f16 scales and zeros bit for bit, on Gaussian weights with an
    all-zero group column and a constant one among them."""
    w = np.random.RandomState(k + n).randn(k, n).astype(np.float32) * 0.05
    w[:gs, :3] = 0.0
    w[gs : 2 * gs, 5] = 1.0
    q, s, z = jq._als_refine_host(w.reshape(k // gs, gs, n))
    codes, s2, z2 = tg.als_grid(torch.from_numpy(w), gs)
    assert codes.dtype == torch.uint8
    np.testing.assert_array_equal(codes.numpy(), q.reshape(k, n))
    np.testing.assert_array_equal(s2.numpy(), s.astype(np.float32))
    np.testing.assert_array_equal(z2.numpy(), z.astype(np.float32))


@pytest.mark.parametrize("group", [32, 64])
def test_quantize_linear_takes_the_reference_grid(group, monkeypatch):
    """``quantize_linear``: int4 on the ALS grid by default, as the
    reference's ``quantize_kernel_host(refine=None)`` on its numpy path;
    with ``DIFFUSIONKIT_TPU_QUANT_REFINE=0`` the min/max grid; int8 always
    min/max."""
    import diffusionkit_tpu.native as jnative

    monkeypatch.setattr(jnative, "quantize_int4_als", lambda *a, **k: None)
    monkeypatch.setattr(jnative, "quantize_int4", lambda *a, **k: None)
    w = np.random.RandomState(group).randn(512, 256).astype(np.float32) / 16
    lin = torch.nn.Linear(512, 256)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T.copy()))
    for refine, bits in (("1", 4), ("0", 4), ("1", 8)):
        monkeypatch.setenv("DIFFUSIONKIT_TPU_QUANT_REFINE", refine)
        want = jq.quantize_kernel_host(w, bits, group)
        layer = tq.quantize_linear(lin, group, bits=bits)
        codes = layer.q8.numpy() if bits == 8 else unpack_q4(layer.q4.numpy().view(np.uint32), 512)
        ref = want["q8"] if bits == 8 else unpack_q4(want["q4"], 512)
        np.testing.assert_array_equal(codes, ref)
        np.testing.assert_array_equal(layer.scales.numpy(), want["scales"].astype(np.float32))
        np.testing.assert_array_equal(layer.zeros.numpy(), want["zeros"].astype(np.float32))


# -- the GPTQ core ----------------------------------------------------------------------


def correlated(seed, in_dim, out_dim, rows, rank):
    rs = np.random.RandomState(seed)
    mix = rs.randn(in_dim, rank) @ rs.randn(rank, in_dim) / np.sqrt(in_dim)
    X = rs.randn(rows, in_dim).astype(np.float32) @ (
        np.eye(in_dim, dtype=np.float32) + mix.astype(np.float32))
    W = rs.randn(in_dim, out_dim).astype(np.float32) * 0.05
    return X, W


def port_gptq(W, H, bits=4, group=32, wscale=False):
    """The port's GPTQ of W as the reference's param dict schema."""
    codes, s, z = tg.gptq_quantize(torch.from_numpy(W), torch.from_numpy(H), bits, group)
    lin = torch.nn.Linear(W.shape[0], W.shape[1], bias=False)
    layer = tq.packed_linear(lin, codes, s, z, bits, group)
    out = {"scales": s.numpy(), "zeros": z.numpy(), "codes": codes.numpy()}
    if wscale:
        out["wscale"] = tq.wscale_from_q4(layer).numpy()
    return out


@pytest.mark.parametrize("case", ["core", "membership"])
def test_gptq_core_against_the_reference(case):
    """The reference's test matrices (tests/test_gptq.py): the H-weighted
    error within 1.05x of the numpy and jitted cores, the scales f16 values
    of the reference's shape, ``wscale`` within rtol 0.1."""
    if case == "core":
        X, W = correlated(2, 128, 192, 1024, 16)
    else:
        rs = np.random.RandomState(1)
        W = rs.randn(64, 128).astype(np.float32) * 0.1
        X = rs.randn(200, 64).astype(np.float32)
    H = X.T @ X
    p_np = jg.gptq_quantize_kernel(W, H, bits=4, group_size=32, with_wscale=True)
    p_jx = jg.gptq_quantize_kernel_jax(W, H, bits=4, group_size=32, with_wscale=True)
    got = port_gptq(W, H, wscale=True)
    assert got["scales"].shape == p_jx["scales"].shape
    assert np.array_equal(got["scales"], got["scales"].astype(np.float16).astype(np.float32))
    assert np.array_equal(got["zeros"], got["zeros"].astype(np.float16).astype(np.float32))
    assert got["codes"].max() <= 15
    deq = tg.dequant(*(torch.from_numpy(got[k]) for k in ("codes", "scales", "zeros"))).numpy()
    e_t = np.sum((X @ (W - deq)) ** 2)  # the H-weighted error, H = X^T X
    for p in (p_np, p_jx):
        assert e_t <= 1.05 * np.sum((X @ (W - jg._dequant_host(p, W.shape[0]))) ** 2)
        np.testing.assert_allclose(got["wscale"], p["wscale"], rtol=0.1)


@pytest.mark.parametrize("bits", [4, 8])
def test_gptq_beats_als_on_correlated_inputs(bits):
    """On correlated inputs GPTQ's output error is at least 10 % below the
    data-free grid's (ALS at 4 bits, min/max at 8, as the reference)."""
    X, W = correlated(0, 128, 256, 512, 24)
    H = (X.T @ X).astype(np.float32)
    got = port_gptq(W, H, bits=bits)
    free = tq.quantize_weight(torch.from_numpy(W), 32, bits)
    e_g = np.linalg.norm(X @ (W - tg.dequant(*(torch.from_numpy(got[k]) for k in
                                                ("codes", "scales", "zeros"))).numpy()))
    e_a = np.linalg.norm(X @ (W - tg.dequant(*free).numpy()))
    assert e_g < 0.9 * e_a, (e_g, e_a)


@pytest.mark.parametrize("dead", [False, True])
def test_gptq_dead_inputs_and_degenerate_h(dead):
    """Dead inputs (a zero Hessian row) quantize the zeroed row; an
    indefinite Hessian, whose Cholesky factorisation fails, takes U = I,
    which is the ALS grid bit for bit."""
    X, W = correlated(3, 96, 128, 300, 8)
    H = X.T @ X
    if dead:
        H[5, :] = H[:, 5] = 0.0
        got = port_gptq(W, H)
        assert np.all(got["codes"][5] == np.round(-got["zeros"][0] / got["scales"][0]).clip(0, 15))
    else:
        indefinite = 2 * torch.ones(96, 96) - 1.5 * torch.eye(96)  # diagonal 0.5, eigenvalue -1.5
        codes, s, z = tg.gptq_quantize(torch.from_numpy(W), indefinite, 4, 32)
        want = tg.als_grid(torch.from_numpy(W), 32)
        for a, b in zip((codes, s, z), want):
            assert torch.equal(a, b)


def test_shared_h_concatenation_is_bit_identical():
    """q/k-like mats sharing one Hessian, GPTQ'd side by side, equal their
    separate calls bit for bit (the reference's own test)."""
    rs = np.random.RandomState(7)
    in_dim = 576
    lins = []
    for n, bias in ((64, True), (128, False)):
        lin = torch.nn.Linear(in_dim, n, bias=bias)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(rs.randn(n, in_dim).astype(np.float32) * 0.05))
            if bias:
                lin.bias.copy_(torch.from_numpy(rs.randn(n).astype(np.float32)))
        lins.append(lin)
    x = rs.randn(1024, in_dim).astype(np.float32) * 0.7
    H = torch.from_numpy((x.T @ x) / len(x))
    joint = tg.quantize_mats_shared_h(lins, H, 4, 32)
    for lin, got in zip(lins, joint):
        codes, s, z = tg.gptq_quantize(lin.weight.t(), H, 4, 32)
        assert same_state(got, tq.packed_linear(lin, codes, s, z, 4, 32))


# -- the mirror ---------------------------------------------------------------------------


def jax_site_hessians(params, jcfg, ev):
    """The JAX mirror's per-site Hessians, layer by layer, keyed as the port's."""
    from diffusionkit_tpu.models.mmdit import tree_index
    from diffusionkit_tpu.ops.rope import rope_frequencies

    x, txt, c, h_patch = jg._mirror_prologue(
        params, jcfg, *(jnp.asarray(ev[k]) for k in ("latent", "cond", "pooled", "t")))
    out = {"patch": h_patch}
    rope = None
    if jcfg.pos_embed_type != JaxPE.LearnedInputEmbedding:
        lh, lw = (ev["latent"].shape[i] // jcfg.patch_size for i in (1, 2))
        rope = rope_frequencies((lh, lw), txt.shape[1], jcfg.rope_axes_dim, theta=10000)
    n_uniform = jcfg.depth_multimodal - (1 if jcfg.depth_unified == 0 else 0)
    for i in range(n_uniform):
        x, txt, sites = jg._mirror_mm_layer(tree_index(params["mm_blocks"], i), x, txt, c, rope,
                                            jcfg)
        out.update({f"mm{i}.{k}": v for k, v in sites.items()})
    if jcfg.depth_unified == 0:
        x, _, sites = jg._mirror_mm_layer(params["mm_final"], x, txt, c, rope, jcfg,
                                          final_skip_text=True)
        out.update({f"mm_final.{k}": v for k, v in sites.items()})
    else:
        u = jnp.concatenate([txt, x], axis=1)
        for i in range(jcfg.depth_unified):
            u, sites = jg._mirror_uni_layer(tree_index(params["uni_blocks"], i), u, c, rope, jcfg)
            out.update({f"uni{i}.{k}": v for k, v in sites.items()})
        x = u[:, txt.shape[1]:]
    _, out["final"] = jg._mirror_epilogue(params, jcfg, x, c, ev["latent"].shape[1:3])
    out.update({f"c.{k}": v for k, v in jg._dense_c_hessians(params, jcfg, ev["pooled"]).items()})
    return out


def port_site_hessians(model, ev):
    args = [torch.from_numpy(ev[k]) for k in ("latent", "cond", "pooled", "t")]
    cfg = model.config
    with torch.no_grad():
        x, txt, c, h_patch = tg.mirror_prologue(model, *args)
        out = {"patch": h_patch}
        rope = tg._rope(model, args[0], txt.shape[1])
        for i, block in enumerate(model.mm_blocks):
            x, txt, sites = tg.mirror_mm_layer(block, x, txt, c, rope, cfg)
            out.update({f"mm{i}.{k}": v for k, v in sites.items()})
        if model.mm_final is not None:
            x, _, sites = tg.mirror_mm_layer(model.mm_final, x, txt, c, rope, cfg)
            out.update({f"mm_final.{k}": v for k, v in sites.items()})
        else:
            u = torch.cat([txt, x], dim=1)
            for i, block in enumerate(model.uni_blocks):
                u, sites = tg.mirror_uni_layer(block, u, c, rope, cfg)
                out.update({f"uni{i}.{k}": v for k, v in sites.items()})
            x = u[:, txt.shape[1]:]
        _, out["final"] = tg.mirror_epilogue(model, x, c, tuple(args[0].shape[1:3]))
        out.update({f"c.{k}": v for k, v in tg.dense_c_hessians(model, ev["pooled"]).items()})
    return out


@pytest.mark.parametrize("name", ["sd3", "sd35", "flux", "flux_dev"])
def test_mirror_matches_jax_and_the_forward(name):
    jcfg = CONFIGS[name]
    params = randomize(init_mmdit_params(jax.random.PRNGKey(0), jcfg), seed=3)
    model = port_model(jcfg, params)
    ev = jg.calib_batch(jcfg, batch=4, latent_hw=(16, 16), seed=5)
    args = [torch.from_numpy(ev[k]) for k in ("latent", "cond", "pooled", "t")]
    with torch.no_grad():
        got = tg.mirror_forward(model, *args).numpy()
    want = np.asarray(jg.mirror_forward(params, jcfg, *(ev[k] for k in
                                                        ("latent", "cond", "pooled", "t"))))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got, forward(model, ev), atol=2e-4, rtol=1e-3)
    jh, th = jax_site_hessians(params, jcfg, ev), port_site_hessians(model, ev)
    assert set(jh) == set(th)
    for key in jh:
        a, b = th[key].numpy(), np.asarray(jh[key])
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b), key


# -- the tree quantizer ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_trees():
    """Per (config, mixed): the float JAX params, the JAX GPTQ tree and the
    JAX ALS tree, MIN_SIZE / MIN_DIM lowered as the reference's test does."""
    out = {}
    saved = (jg.MIN_SIZE, jg.MIN_DIM)
    jg.MIN_SIZE, jg.MIN_DIM = 0, 1
    try:
        for name in ("sd3", "flux", "flux_dev"):
            jcfg = CONFIGS[name]
            params = randomize(init_mmdit_params(jax.random.PRNGKey(0), jcfg), seed=9)
            host = jax.tree.map(lambda a: None if a is None else np.asarray(a), params,
                                is_leaf=lambda a: a is None)
            for mixed in (False, True):
                ov = jq.MIXED_OVERRIDES if mixed else None
                gq = jg.gptq_quantize_mmdit(host, jcfg, bits=4, group_size=32, overrides=ov,
                                            **CALIB)
                als = jq.quantize_tree(host, bits=4, group_size=32, min_size=0, min_dim=1,
                                       overrides=ov)
                out[name, mixed] = (params, gq, als)
    finally:
        jg.MIN_SIZE, jg.MIN_DIM = saved
    return out


@pytest.mark.parametrize("mixed", [False, True], ids=["uniform", "mixed"])
@pytest.mark.parametrize("name", ["sd3", "flux", "flux_dev"])
def test_gptq_tree_matches_the_reference(name, mixed, reference_trees, monkeypatch):
    jcfg = CONFIGS[name]
    params, jax_gptq, jax_als = reference_trees[name, mixed]
    monkeypatch.setattr(tg, "MIN_SIZE", 0)
    monkeypatch.setattr(tg, "MIN_DIM", 1)
    model = port_model(jcfg, params)
    base = copy.deepcopy(model)
    tg.gptq_quantize_mmdit(model, bits=4, group_size=32,
                           overrides=tq.MIXED_OVERRIDES if mixed else None, **CALIB)
    want = port_model(jcfg, jax_gptq)
    form = kinds(model)
    assert form == kinds(want)
    assert form == kinds(port_model(jcfg, jax_als))
    if mixed:
        assert form["mm_blocks.0.img.ada"] == 8 and form["final_layer.ada"] is None
        assert form["mm_blocks.0.img.q"] == 4 and form["t_embedder.fc1"] is None
    else:
        assert form["final_layer.ada"] == form["x_embedder"] == form["mm_blocks.0.img.ada"] == 4
    if jcfg.guidance_embed:  # the guidance embedder as its siblings: float under -mixed
        assert form["guidance_embedder.fc1"] == form["t_embedder.fc1"] == (None if mixed else 4)
    for m in model.modules():
        if isinstance(m, tq.QuantizedLinear):
            assert torch.equal(m.scales, m.scales.half().float())
            assert torch.equal(m.zeros, m.zeros.half().float())
    ev = jg.calib_batch(jcfg, batch=4, latent_hw=(16, 16), seed=99)
    ref = forward(base, ev)

    def err(m):
        return float(np.linalg.norm(forward(m, ev) - ref))

    e_port = err(model)
    assert e_port <= 1.1 * err(want), (e_port, err(want))
    assert e_port <= 1.1 * err(port_model(jcfg, jax_als)), (e_port, err(port_model(jcfg, jax_als)))


def test_gptq_quantizes_a_bf16_model_from_its_own_values():
    """A bf16 model: each layer upcast for its own step only; the packed
    linears keep the bf16 bias dtype, and the result is the fp32 twin's
    GPTQ on the same (bf16-valued) weights bit for bit."""
    jcfg = dataclasses.replace(TINY_SD3, depth_multimodal=2)
    params = randomize(init_mmdit_params(jax.random.PRNGKey(0), jcfg), seed=4)
    f32 = port_model(jcfg, params)
    bf16 = copy.deepcopy(f32).to(torch.bfloat16)
    bf16.config = dataclasses.replace(f32.config, dtype=torch.bfloat16)
    for block in bf16.mm_blocks:
        block.config = dataclasses.replace(block.config, dtype=torch.bfloat16)
    f32.load_state_dict({k: v.float() for k, v in bf16.state_dict().items()})
    saved = (tg.MIN_SIZE, tg.MIN_DIM)
    tg.MIN_SIZE, tg.MIN_DIM = 0, 1
    try:
        for m in (f32, bf16):
            tg.gptq_quantize_mmdit(m, bits=4, group_size=32, batch=4, latent_hw=(8, 8))
    finally:
        tg.MIN_SIZE, tg.MIN_DIM = saved
    q32, q16 = f32.mm_blocks[0].img.fc1, bf16.mm_blocks[0].img.fc1
    assert isinstance(q16, tq.QuantizedLinear) and q16.bias.dtype == torch.bfloat16
    assert torch.equal(q32.q4, q16.q4) and torch.equal(q32.scales, q16.scales)


# -- the pipelines --------------------------------------------------------------------------


WIDE_FLUX = dataclasses.replace(TINY_FLUX, depth_multimodal=1, depth_unified=1, num_heads=2,
                                hidden_size_override=256, mlp_ratio=2,
                                token_level_text_embed_dim=256, pooled_text_embed_dim=32,
                                rope_axes_dim=(16, 56, 56))


def wide_flux():
    params = randomize(init_mmdit_params(jax.random.PRNGKey(0), WIDE_FLUX), seed=7)
    return port_model(WIDE_FLUX, params)


@pytest.fixture
def quiet_env(monkeypatch, tmp_path):
    for var in ("DIFFUSIONKIT_TPU_GPTQ", "DIFFUSIONKIT_TPU_QUANT_REFINE",
                "DIFFUSIONKIT_TPU_QUANT_CACHE", "DIFFUSIONKIT_TPU_T5_SMOOTH"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("DIFFUSIONKIT_TPU_CACHE_DIR", str(tmp_path / "cache"))
    return tmp_path


@pytest.mark.parametrize("case", ["gptq", "als", "minmax", "int8", "w4a8"])
def test_pipeline_quantizer_switches(case, quiet_env, monkeypatch):
    """GPTQ by default for int4 and w4a8; ``DIFFUSIONKIT_TPU_GPTQ=0`` the
    ALS grid; also ``DIFFUSIONKIT_TPU_QUANT_REFINE=0`` the min/max grid;
    int8 min/max. Each bit for bit the quantizer called directly."""
    mode = {"int8": "int8", "w4a8": "w4a8"}.get(case, "int4")
    if case in ("als", "minmax"):
        monkeypatch.setenv("DIFFUSIONKIT_TPU_GPTQ", "0")
    if case == "minmax":
        monkeypatch.setenv("DIFFUSIONKIT_TPU_QUANT_REFINE", "0")
    pipe = FluxPipeline(load=False, low_memory_mode=False, device="cpu", quantize_mmdit=mode,
                        quantize_group_size=32)
    model = wide_flux()
    want = copy.deepcopy(model)
    pipe.mmdit = model
    name = {"w4a8": "gptq", "int8": "minmax"}.get(case, case)
    assert pipe.quantizer["name"] == name and pipe.quantizer["seconds"] > 0
    if name == "gptq":
        tg.gptq_quantize_mmdit(want, bits=4, group_size=32)
    else:
        tq.quantize_module_(want, 32, bits=8 if mode == "int8" else 4)
    if mode == "w4a8":
        tq.add_wscale_(want)
    assert isinstance(pipe.mmdit.uni_blocks[0].fc1, tq.QuantizedLinear)
    assert same_state(pipe.mmdit, want)


@pytest.mark.parametrize("error", ["gptq@1", "gptq@6", "kernel"])
def test_pipeline_gptq_fallback(error, quiet_env, monkeypatch):
    """GPTQ failing at its 1st or 6th linear (after the earlier ones were
    swapped for packed ones) falls back with a warning to the ALS grid on
    the whole float model, as the reference's functional fallback: the
    MMDiT equals ``quantize_module_`` of a float copy bit for bit, is named
    "als" and is cached under the ``_gptq0_`` tag. A kernel error
    propagates."""
    import diffusionkit_tpu_torch.pipeline as pl

    if error == "kernel":
        def fail(*args, **kwargs):
            raise kernels.KernelError("gptq_group failed with CUDA error 700")

        monkeypatch.setattr(pl, "gptq_quantize_mmdit", fail)
        pipe = FluxPipeline(load=False, low_memory_mode=False, device="cpu",
                            quantize_mmdit="int4", quantize_group_size=32)
        with pytest.raises(kernels.KernelError):
            pipe.mmdit = wide_flux()
        return

    fail_at = int(error.split("@")[1])
    quantize_mat, calls, packed = tg.quantize_mat, [], []

    def fail_at_call(layer, *args, **kwargs):
        calls.append(layer)
        if len(calls) == fail_at:
            raise NotImplementedError("an exotic config")
        out = quantize_mat(layer, *args, **kwargs)
        packed.append(out is not layer)
        return out

    model = wide_flux()
    want = tq.quantize_module_(copy.deepcopy(model), 32)
    ckpt = quiet_env / "flux-schnell.safetensors"
    ckpt.write_bytes(b"float weights")
    monkeypatch.setattr(tg, "quantize_mat", fail_at_call)
    monkeypatch.setattr(model_io, "load_mmdit", lambda *a, **k: (model, None))
    pipe = FluxPipeline(load=False, low_memory_mode=False, device="cpu", quantize_mmdit="int4",
                        quantize_group_size=32, local_ckpt=str(ckpt))
    pipe.load_mmdit()
    assert len(calls) == fail_at and any(packed) == (fail_at > 1)
    assert pipe.quantizer["name"] == "als"
    assert kinds(pipe.mmdit) == kinds(want)
    assert same_state(pipe.mmdit, want)
    (name,) = cache_files(quiet_env)
    assert "_gptq0_" in name and "_gptq1_" not in name


# -- the caches ---------------------------------------------------------------------------------


@pytest.fixture
def sd3_file(quiet_env, monkeypatch):
    """A float SD3 checkpoint (the sgm namespace) of a wide tiny config, as
    SD3-medium's ``local_ckpt``."""
    from test_torch_loading import drawn
    import test_model_io as jt
    from safetensors.numpy import save_file

    jcfg = dataclasses.replace(jt.TINY_SD3, hidden_size_override=256, num_heads=4,
                               depth_multimodal=2, max_latent_resolution=16)
    monkeypatch.setitem(model_io.MMDIT_CONFIG, tcfg.SD3_MEDIUM,
                        torch_config(jcfg, tcfg.MMDiTConfig))
    path = quiet_env / "sd3_medium.safetensors"
    save_file(drawn(41, jt._sd3_raw_ckpt, jcfg), str(path))
    return path


def sd3_pipe(path, mode="int4"):
    return DiffusionPipeline(load=False, low_memory_mode=True, device="cpu", use_t5=False,
                             w16=False, quantize_mmdit=mode, quantize_group_size=32,
                             local_ckpt=str(path))


def cache_files(tmp_path):
    return sorted(p.name for p in (tmp_path / "cache" / "params").glob("*"))


@pytest.mark.parametrize("mode", ["int4", "w4a8-mixed"])
def test_mmdit_cache_round_trip(mode, sd3_file, quiet_env, monkeypatch):
    """Request 0 converts (GPTQ) and writes the cache; request 1 reads it,
    with no quantizer call, bit for bit."""
    import diffusionkit_tpu_torch.pipeline as pl

    pipe = sd3_pipe(sd3_file, mode)
    pipe.load_mmdit()
    assert pipe.quantizer["name"] == "gptq"
    files = cache_files(quiet_env)
    assert len(files) == 1 and files[0].startswith("torch_mmdit_") and "_gptq1_" in files[0]
    first = pipe.mmdit

    def called(*a, **k):
        raise AssertionError("the quantizer ran on a cached load")

    monkeypatch.setattr(pl, "gptq_quantize_mmdit", called)
    monkeypatch.setattr(pl, "quantize_module_", called)
    again = sd3_pipe(sd3_file, mode)
    again.load_mmdit()
    assert again.quantizer["name"] == "cached"
    assert kinds(again.mmdit) == kinds(first)
    assert same_state(again.mmdit, first)


def test_mmdit_cache_regenerates_a_corrupt_file(sd3_file, quiet_env, monkeypatch):
    """A truncated cache file is deleted, the model converted again (the
    ALS grid here, ``DIFFUSIONKIT_TPU_GPTQ=0``) and the file rewritten."""
    monkeypatch.setenv("DIFFUSIONKIT_TPU_GPTQ", "0")
    pipe = sd3_pipe(sd3_file)
    pipe.load_mmdit()
    (path,) = (quiet_env / "cache" / "params").glob("*")
    path.write_bytes(path.read_bytes()[:1000])
    again = sd3_pipe(sd3_file)
    again.load_mmdit()
    assert again.quantizer["name"] == "als"
    assert same_state(again.mmdit, pipe.mmdit)
    assert model_io.load_mmdit_cache(path, tcfg.SD3_MEDIUM, torch.float32, "cpu") is not None


def test_mmdit_cache_files_an_als_fallback_under_gptq0(sd3_file, quiet_env, monkeypatch):
    import diffusionkit_tpu_torch.pipeline as pl

    def fail(*args, **kwargs):
        raise NotImplementedError("forced")

    monkeypatch.setattr(pl, "gptq_quantize_mmdit", fail)
    pipe = sd3_pipe(sd3_file)
    pipe.load_mmdit()
    assert pipe.quantizer["name"] == "als"
    (name,) = cache_files(quiet_env)
    assert "_gptq0_" in name and "_gptq1_" not in name


@pytest.mark.parametrize("what", ["cache_off", "stale"])
def test_mmdit_cache_off_and_stale(what, sd3_file, quiet_env, monkeypatch):
    """``DIFFUSIONKIT_TPU_QUANT_CACHE=0`` writes nothing; a file of another
    layout is deleted and regenerated (the ALS grid here)."""
    monkeypatch.setenv("DIFFUSIONKIT_TPU_GPTQ", "0")
    if what == "cache_off":
        monkeypatch.setenv("DIFFUSIONKIT_TPU_QUANT_CACHE", "0")
        sd3_pipe(sd3_file).load_mmdit()
        assert not (quiet_env / "cache").exists() or cache_files(quiet_env) == []
        return
    pipe = sd3_pipe(sd3_file)
    pipe.load_mmdit()
    (path,) = (quiet_env / "cache" / "params").glob("*")
    monkeypatch.setattr(model_io, "CACHE_LAYOUT", model_io.CACHE_LAYOUT + 1)
    assert model_io.load_mmdit_cache(path, tcfg.SD3_MEDIUM, torch.float32, "cpu") is None
    assert not path.exists()


T5_WIDE = tcfg.T5Config(vocab_size=64, d_model=256, d_kv=64, d_ff=512, num_layers=2,
                        num_heads=4)


def t5_model(seed=0):
    with torch.no_grad():
        model = T5Encoder(T5_WIDE, torch.float32)
        gen = torch.Generator().manual_seed(seed)
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / np.sqrt(p.shape[-1]))
    return model


@pytest.mark.parametrize("smooth", ["1", "0"])
def test_t5_smooth_switch(smooth, quiet_env, monkeypatch):
    """``DIFFUSIONKIT_TPU_T5_SMOOTH=0`` gives the plain w8a8 conversion bit
    for bit; on, the SmoothQuant fold comes first and changes it."""
    monkeypatch.setenv("DIFFUSIONKIT_TPU_T5_SMOOTH", smooth)
    pipe = FluxPipeline(load=False, low_memory_mode=False, device="cpu", quantize_t5=True)
    model = t5_model()
    plain = w8a8_module_(copy.deepcopy(model))
    pipe.t5 = model
    assert isinstance(pipe.t5.layers[0].wi_0, W8A8Linear)
    assert same_state(pipe.t5, plain) == (smooth == "0")


def test_t5_cache_round_trip(quiet_env, monkeypatch):
    """``load_text_encoders`` under ``quantize_t5``: the first load writes
    the w8a8 T5 under the reference's tag, the second reads it bit for
    bit."""
    from test_torch_loading import write_aux

    import diffusionkit_tpu_torch.pipeline as pl

    ckpt = quiet_env / "ckpt"
    model = t5_model(1)
    sd = {"shared.weight": model.wte.weight, "encoder.final_layer_norm.weight":
          model.final_ln.weight,
          "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
          model.relative_attention_bias.weight}
    names = {"query_proj": "0.SelfAttention.q", "key_proj": "0.SelfAttention.k",
             "value_proj": "0.SelfAttention.v", "out_proj": "0.SelfAttention.o",
             "wi_0": "1.DenseReluDense.wi_0", "wi_1": "1.DenseReluDense.wi_1",
             "wo": "1.DenseReluDense.wo"}
    for i, layer in enumerate(model.layers):
        pre = f"encoder.block.{i}.layer"
        sd[f"{pre}.0.layer_norm.weight"] = layer.ln1.weight
        sd[f"{pre}.1.layer_norm.weight"] = layer.ln2.weight
        for attr, raw in names.items():
            sd[f"{pre}.{raw}.weight"] = getattr(layer, attr).weight
    write_aux(ckpt, "t5", {k: v.detach().numpy() for k, v in sd.items()}, dtype=np.float32)
    monkeypatch.setenv("DIFFUSIONKIT_TPU_CKPT_DIR", str(ckpt))
    monkeypatch.setattr(model_io, "T5_XXL", T5_WIDE)

    def pipe():
        return FluxPipeline(load=False, low_memory_mode=False, device="cpu", w16=False,
                            quantize_t5=True)

    first = pipe()
    first.load_t5()
    (name,) = cache_files(quiet_env)
    assert name.startswith("torch_t5_w8a8_smooth_float32_q")
    monkeypatch.setattr(pl, "smooth_t5", lambda *a, **k: pytest.fail("converted a cached T5"))
    second = pipe()
    second.load_t5()
    assert same_state(second.t5, first.t5)


def test_save_safetensors_writes_the_format(tmp_path):
    """The port's writer (the cache's; the card's machine has no
    safetensors package) gives a file the safetensors package reads back
    bit for bit, and so does the port's reader."""
    from safetensors.torch import load_file

    gen = torch.Generator().manual_seed(0)
    tensors = {"b": torch.randn(3, 5, generator=gen).bfloat16(),
               "f": torch.randn(7, generator=gen),
               "q4": torch.randint(-(2**31), 2**31 - 1, (2, 3), generator=gen, dtype=torch.int32),
               "q8": torch.randint(0, 256, (4, 4), generator=gen).to(torch.uint8),
               "w8": torch.randint(-127, 128, (3, 2), generator=gen).to(torch.int8),
               "one": torch.tensor([1], dtype=torch.int32)}
    path = tmp_path / "t.safetensors"
    model_io.save_safetensors(path, tensors)
    for got in (load_file(str(path)), model_io.load_safetensors(path)):
        assert set(got) == set(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_gptq_at_sd3s_pooled_width_is_the_references(capsys):
    """At SD3's 2048-wide pooled input the reference's calibration leaves
    the conditioning sites under-sampled (y_embedder's fc1 Hessian is 2224
    random rows for 2048 inputs, the ``ada`` ladder spans 48 pooled draws),
    and its GPTQ tree loses to its ALS tree end to end on held-out inputs.
    The port's GPTQ is the reference's there too: its error within 1.1x of
    the JAX GPTQ tree's, and its block linears alone (q, k, v, o, fc1,
    fc2) at or below ALS's. The errors are printed (``-s``)."""
    import diffusionkit_tpu.native as jnative
    from diffusionkit_tpu.config import SD3_2b as JAX_SD3

    jcfg = dataclasses.replace(JAX_SD3, depth_multimodal=3, num_heads=4,
                               hidden_size_override=256, dtype=jnp.float32)
    params = init_mmdit_params(jax.random.PRNGKey(0), jcfg)
    host = jax.tree.map(lambda a: None if a is None else np.asarray(a), params,
                        is_leaf=lambda a: a is None)
    model = port_model(jcfg, params)
    ev = jg.calib_batch(jcfg, batch=4, seed=99)
    ref = forward(model, ev)
    saved = jnative.quantize_int4_als
    jnative.quantize_int4_als = lambda *a, **k: None  # the numpy ALS, as the port's
    try:
        jax_gptq = port_model(jcfg, jg.gptq_quantize_mmdit(host, jcfg, bits=4, group_size=32,
                                                           batch=16))
    finally:
        jnative.quantize_int4_als = saved
    port = copy.deepcopy(model)
    tg.gptq_quantize_mmdit(port, bits=4, group_size=32, batch=16)
    als = tq.quantize_module_(copy.deepcopy(model), 32)

    def err(m):
        return float(np.linalg.norm(forward(m, ev) - ref))

    def blocks_only(src):
        hybrid = copy.deepcopy(model)
        for n, m in src.named_modules():
            if n.startswith("mm_") and n.rpartition(".")[2] in ("q", "k", "v", "o", "fc1", "fc2"):
                parent, _, attr = n.rpartition(".")
                setattr(hybrid.get_submodule(parent), attr, m)
        return hybrid

    e = {"port": err(port), "jax": err(jax_gptq), "als": err(als),
         "port_blocks": err(blocks_only(port)), "als_blocks": err(blocks_only(als))}
    with capsys.disabled():
        print(f"\nSD3 pooled 2048, hidden 256, 3 blocks: {e}")
    assert e["port"] <= 1.1 * e["jax"] and e["jax"] <= 1.1 * e["port"]
    assert e["jax"] > e["als"]  # the reference's GPTQ loses to its ALS grid here
    assert e["port_blocks"] <= e["als_blocks"]
