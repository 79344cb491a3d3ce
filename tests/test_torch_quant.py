"""int4 weight-only quantization of the PyTorch port against the JAX package.

Host packing and quantizing are compared bit for bit; the plain version of
kernel C (``int4_matmul_plain``) and ``int4_linear`` against the reference's
Pallas ``int4_matmul`` / ``int4_linear`` run in interpret mode, on the same
packed weights and numpy inputs from fixed seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionkit_tpu import model_io
from diffusionkit_tpu.config import FLUX_SCHNELL as JAX_FLUX
from diffusionkit_tpu.models import init_mmdit_params
from diffusionkit_tpu.ops import quantized as jq
from diffusionkit_tpu.ops.int4_matmul import int4_linear as jax_int4_linear
from diffusionkit_tpu.ops.int4_matmul import int4_matmul as jax_int4_matmul
from diffusionkit_tpu_torch import config as tcfg
from diffusionkit_tpu_torch.convert import mmdit_from_jax
from diffusionkit_tpu_torch.models import init_mmdit
from diffusionkit_tpu_torch.ops import quantized as tq
from diffusionkit_tpu_torch.ops.int4_matmul import (
    dequantize_int4,
    int4_linear,
    int4_matmul,
    int4_matmul_plain,
)
from diffusionkit_tpu_torch.pipeline import FluxPipeline

from test_torch_models import randomize, torch_config

torch.set_num_threads(1)

K, N = 512, 256


def packed_weights(group: int, seed: int = 0):
    """A (K, N) float kernel quantized by the reference (min/max grid)."""
    w = np.random.RandomState(seed).randn(K, N).astype(np.float32) / np.sqrt(K)
    return {k: np.asarray(v) for k, v in jq.quantize_kernel_host(w, 4, group, refine=False).items()}


def as_torch(p):
    return (torch.from_numpy(p["q4"].view(np.int32)), torch.from_numpy(p["scales"]),
            torch.from_numpy(p["zeros"]))


def test_pack_int4_host_is_bit_identical():
    q = np.random.RandomState(1).randint(0, 16, size=(64, 24)).astype(np.uint8)
    got, want = tq.pack_int4_host(q), jq.pack_int4_host(q)
    assert got.dtype == np.uint32 and np.array_equal(got, want)


@pytest.mark.parametrize("group", [32, 64])
def test_quantize_kernel_host_is_bit_identical(group):
    w = np.random.RandomState(2).randn(K, N).astype(np.float32)
    want = jq.quantize_kernel_host(w, 4, group, refine=False)
    got = tq.quantize_kernel_host(w, group)
    for key in ("q4", "scales", "zeros"):
        assert got[key].dtype == np.asarray(want[key]).dtype
        assert np.array_equal(got[key], np.asarray(want[key])), key


def test_mlx_q4_to_exec_is_bit_identical():
    rs = np.random.RandomState(3)
    w = rs.randn(N, K).astype(np.float32)  # MLX (out, in)
    mlx = jq.mlx_quantize_host(w, 4, 64)
    bias = rs.randn(N).astype(np.float32)
    want = model_io.mlx_q4_to_exec(mlx["weight"], mlx["scales"], mlx["biases"], bias, jnp.float32)
    got = tq.mlx_q4_to_exec(mlx["weight"], mlx["scales"], mlx["biases"], bias)
    for key in ("q4", "scales", "zeros", "bias"):
        assert np.array_equal(got[key], np.asarray(want[key])), key
    # The repack is lossless: it dequantises to MLX's own weights.
    deq = dequantize_int4(*as_torch(got), torch.float32).numpy()
    np.testing.assert_array_equal(deq.T, model_io.dequantize_mlx_4bit(
        mlx["weight"], mlx["scales"], mlx["biases"]))


def test_quantized_linear_carries_the_words_bit_for_bit():
    p = packed_weights(64)
    p["bias"] = np.arange(N, dtype=np.float32)
    layer = tq.QuantizedLinear.from_host(p, torch.bfloat16, device="cpu")
    assert layer.q4.dtype == torch.int32 and layer.group_size == 64
    assert np.array_equal(layer.q4.numpy().view(np.uint32), p["q4"])
    assert layer.bias.dtype == torch.bfloat16 and layer.scales.dtype == torch.float32


@pytest.mark.parametrize("loader", ["QuantizedLinear", "W8A8Linear"])
def test_from_host_loaders_default_to_the_card(loader):
    """Like the model builders and ``convert.*_from_jax``, the two host
    loaders put a layer on the card unless the caller asks for the CPU."""
    import inspect

    from diffusionkit_tpu_torch.ops import w8a8

    cls = tq.QuantizedLinear if loader == "QuantizedLinear" else w8a8.W8A8Linear
    assert inspect.signature(cls.from_host).parameters["device"].default == "cuda"


# int4_matmul_plain against the Pallas kernel in interpret mode. fp32: the
# same products summed in another order (K = 512 terms of O(1/sqrt(K))).
# bf16: both sides round the dequantised weight to bf16, accumulate in fp32
# and round once; two roundings of nearly equal fp32 sums differ by at most
# one bf16 ulp (2^-8 relative) of the output.
TOLS = {torch.float32: dict(atol=1e-5, rtol=1e-5), torch.bfloat16: dict(atol=2e-2, rtol=2**-7)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [32, 64])
def test_int4_matmul_plain_matches_pallas(group, dtype):
    p = packed_weights(group)
    x = np.random.RandomState(4).randn(70, K).astype(np.float32)  # ragged M
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_int4_matmul(jnp.asarray(x, jdt), *map(jnp.asarray, (p["q4"], p["scales"], p["zeros"])),
                           bm=64, bk=256, bn=128, interpret=True)
    xt = torch.from_numpy(x).to(dtype)
    launches = int4_matmul.launches
    got = int4_matmul(xt, *as_torch(p))
    assert int4_matmul.launches == launches  # a CPU tensor takes the plain version
    assert torch.equal(got, int4_matmul_plain(xt, *as_torch(p)))
    assert got.dtype == dtype and got.shape == (70, N)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_linear_bias_gelu_matches_jax(dtype):
    p = packed_weights(64, seed=5)
    rs = np.random.RandomState(6)
    p["bias"] = rs.randn(N).astype(np.float32)
    x = rs.randn(2, 35, K).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jp["bias"] = jp["bias"].astype(jdt)
    want = jax_int4_linear(jp, jnp.asarray(x, jdt), bm=32, bk=256, bn=128, act="gelu",
                           interpret=True)
    layer = tq.QuantizedLinear.from_host(p, dtype, device="cpu")
    got = int4_linear(layer, torch.from_numpy(x).to(dtype), act="gelu")
    assert got.shape == (2, 35, N) and got.dtype == dtype
    # bf16: the product, the bias sum and the GELU each round once on both
    # sides (the reference's bf16 GELU may round inside its chain too).
    tol = TOLS[dtype] if dtype == torch.float32 else dict(atol=3e-2, rtol=2**-6)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_random_quantized_linear_is_seeded_and_bounded():
    def make():
        layer = tq.QuantizedLinear(256, 128, 64, dtype=torch.float32)
        return tq.random_quantized_linear_(layer, torch.Generator().manual_seed(0), scale=0.02)

    a, b = make(), make()
    assert torch.equal(a.q4, b.q4)
    w = dequantize_int4(a.q4, a.scales, a.zeros, torch.float32)
    assert w.min() >= -0.02 and w.max() <= 0.02 + 1e-7
    # All 16 levels of every nibble position occur, including the top bit.
    nib = (a.q4[..., None] >> torch.arange(0, 32, 4, dtype=torch.int32)) & 0xF
    assert all(len(torch.unique(nib[..., j])) == 16 for j in range(8))


def test_quantize_at_load_matches_quantize_tree():
    """FluxPipeline(quantize_mmdit=True) packs an assigned float MMDiT as the
    reference's quantize_tree does (min/max grid, group 32, MIN_DIM 256)."""
    jcfg = dataclasses.replace(JAX_FLUX, depth_multimodal=1, depth_unified=1, num_heads=2,
                               hidden_size_override=256, mlp_ratio=2,
                               token_level_text_embed_dim=256, pooled_text_embed_dim=32,
                               dtype=jnp.float32)
    params = randomize(init_mmdit_params(jax.random.PRNGKey(0), jcfg), seed=7)
    jax_q = jq.quantize_tree(params, bits=4, group_size=32)  # refine off via the env below
    pipe = FluxPipeline(load=False, low_memory_mode=False,
                        device="cpu", quantize_mmdit=True, quantize_group_size=32)
    pipe.mmdit = mmdit_from_jax(params, torch_config(jcfg, tcfg.MMDiTConfig), device="cpu")
    want = mmdit_from_jax(jax_q, torch_config(jcfg, tcfg.MMDiTConfig), device="cpu").state_dict()
    got = pipe.mmdit.state_dict()
    assert set(got) == set(want)
    assert isinstance(pipe.mmdit.context_embedder, tq.QuantizedLinear)
    assert not isinstance(pipe.mmdit.x_embedder, tq.QuantizedLinear)  # 64 inputs < MIN_DIM
    for key in got:
        assert torch.equal(got[key], want[key]), key


@pytest.fixture(autouse=True)
def _minmax_grid(monkeypatch):
    # The reference's quantize_tree takes the min/max grid with this off, and
    # the pipelines take it (not GPTQ) with DIFFUSIONKIT_TPU_GPTQ=0.
    monkeypatch.setenv("DIFFUSIONKIT_TPU_QUANT_REFINE", "0")
    monkeypatch.setenv("DIFFUSIONKIT_TPU_GPTQ", "0")


def test_init_mmdit_int4_builds_packed_blocks_only():
    cfg = torch_config(dataclasses.replace(
        JAX_FLUX, depth_multimodal=1, depth_unified=1, num_heads=2, hidden_size_override=128,
        rope_axes_dim=(8, 28, 28), dtype=jnp.float32), tcfg.MMDiTConfig)
    model = init_mmdit(cfg, torch.Generator().manual_seed(0), quantize_bits=4, device="cpu")
    packed = {n for n, m in model.named_modules() if isinstance(m, tq.QuantizedLinear)}
    assert packed == {f"{b}.{p}" for b in ("mm_blocks.0.img", "mm_blocks.0.txt", "uni_blocks.0")
                      for p in ("q", "k", "v", "ada", "o", "fc1", "fc2")}
    assert model.uni_blocks[0].q.group_size == 64 and model.uni_blocks[0].k.bias is None
    assert torch.all(model.uni_blocks[0].qk_norm.q_scale == 1)
