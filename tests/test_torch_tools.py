"""Kernels #10 and #16 and the two tools that run them, against the JAX
package on the CPU.

#10 ``dequant_w8``'s plain version against the Pallas ``dequant_w8_pallas``
(interpret mode); #16 ``int8_dot``'s plain version against the reference
tool's ``pallas_int8_matmul``, imported by its file path and run under
``force_tpu_interpret_mode``; #10 then #11 against kernel E's plain
version on a layer drawn by the reference's ``random_quantized_linear``;
the tools' ``run`` on the CPU, where every wrapper takes its plain version.
Inputs come from numpy seeds; every comparison is exact.
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from diffusionkit_tpu.ops import w4a8_matmul as jw
from diffusionkit_tpu.ops.quantized import random_quantized_linear as jax_random_quantized_linear
from diffusionkit_tpu_torch.ops import quantized as tq
from diffusionkit_tpu_torch.ops import w4a8_matmul as tw
from diffusionkit_tpu_torch.tools import (
    bench_gemv,
    bench_mat,
    bench_rows,
    bench_w4a8_mat,
    microbench_int8,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def t(a):
    return torch.from_numpy(np.array(a))


def reference_tool(name: str):
    """A module of the reference's ``tools/`` directory, by its file path."""
    spec = importlib.util.spec_from_file_location(f"reference_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def random_w4a8_host(k: int, n: int, group: int, seed: int):
    """The reference's random packed layer (``random_quantized_linear``)
    with its bound wscale (``add_wscale_bound_tree``), as host arrays."""
    p = jax_random_quantized_linear(jax.random.PRNGKey(seed), k, n, bits=4, group_size=group,
                                    bias=False)
    p = jw.add_wscale_bound_tree({key: v for key, v in p.items() if v is not None})
    return {key: np.asarray(v) for key, v in p.items()}


def epilogue_orders(acc: np.ndarray, xs: np.ndarray, ws: np.ndarray, bias: np.ndarray,
                    out: torch.dtype):
    """The two values an XLA epilogue ``acc * xs * ws + bias`` may give in
    ``out``: every product and the sum rounded in fp32 (the port's order),
    or ``* ws + bias`` contracted into one FMA (the product exact in
    float64, one rounding to fp32)."""
    t1 = acc.astype(np.float32) * xs
    two = t1 * ws + bias
    fma = (t1.astype(np.float64) * ws + bias).astype(np.float32)
    return (torch.from_numpy(v).to(out).float().numpy() for v in (two, fma))


# -- #10 ---------------------------------------------------------------------


@pytest.mark.parametrize("group", [32, 64])
def test_dequant_w8_plain_matches_pallas_interpret(group):
    """#10's plain version is the transpose of ``dequant_w8_pallas``'s (K, N)
    grid, bit for bit, on the reference's s8/z8 (wscale-divided affine)."""
    p = random_w4a8_host(256, 256, group, seed=1)
    s8, z8, _, _ = jw._scaled_affine({key: jnp.asarray(v) for key, v in p.items()})
    want = np.asarray(jw.dequant_w8_pallas(jnp.asarray(p["q4"]), s8, z8, bk=128, bn=128,
                                           interpret=True))
    ts8, tz8 = tw.scaled_affine(t(p["scales"]), t(p["zeros"]), t(p["wscale"]))
    np.testing.assert_array_equal(ts8.numpy(), np.asarray(s8))
    np.testing.assert_array_equal(tz8.numpy(), np.asarray(z8))
    q4 = t(p["q4"].view(np.int32))
    launches = tw.dequant_w8.launches
    got = tw.dequant_w8(q4, ts8, tz8)
    assert tw.dequant_w8.launches == launches  # a CPU tensor takes the plain version
    assert got.dtype == torch.int8 and got.shape == (256, 256) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want.T)
    np.testing.assert_array_equal(tw.dequant_w8_plain(q4, ts8, tz8).numpy(), want.T)


@pytest.mark.parametrize("group", [4, 12])
def test_dequant_w8_plain_takes_groups_that_straddle_a_word(group):
    """Groups of 4 and 12 split packed words between two groups: the plain
    version requantises each nibble with its own group's affine, as a
    numpy emulation of the two roundings and the reference's XLA
    ``dequant_w8`` do, bit for bit."""
    rs = np.random.RandomState(2)
    k, n = 96, 24
    q = rs.randint(0, 16, (k, n)).astype(np.uint8)
    s8 = (rs.rand(k // group, n) * 20).astype(np.float32)
    z8 = (-rs.rand(k // group, n) * 120).astype(np.float32)
    packed = tq.pack_int4_host(q)
    got = tw.dequant_w8(t(packed.view(np.int32)), t(s8), t(z8)).numpy()
    y = q.astype(np.float32) * np.repeat(s8, group, 0) + np.repeat(z8, group, 0)
    np.testing.assert_array_equal(got, np.clip(np.round(y), -127, 127).astype(np.int8).T)
    want = np.asarray(jw.dequant_w8(jnp.asarray(packed), jnp.asarray(s8), jnp.asarray(z8)))
    np.testing.assert_array_equal(got, want.T)


# -- #16 ---------------------------------------------------------------------


@pytest.mark.parametrize("m", [64, 100])
def test_int8_dot_plain_matches_pallas_int8_matmul(m):
    """#16's plain version against the reference tool's bare Pallas int8
    matmul in TPU interpret mode (blocks 64/128/128, so M = 100 is ragged
    and the reference pads it), and against the exact int64 product."""
    tool = reference_tool("microbench_pallas_int8")
    rs = np.random.RandomState(3)
    x8 = rs.randint(-127, 128, (m, 256)).astype(np.int8)
    w8 = rs.randint(-127, 128, (256, 256)).astype(np.int8)  # the reference's (K, N)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(tool.pallas_int8_matmul(jnp.asarray(x8), jnp.asarray(w8),
                                                  bm=64, bk=128, bn=128))
    np.testing.assert_array_equal(want, x8.astype(np.int64) @ w8.astype(np.int64))
    launches = tw.int8_dot.launches
    got = tw.int8_dot(t(x8), t(w8.T))  # the port's (N, K)
    assert tw.int8_dot.launches == launches
    assert got.dtype == torch.int32 and got.shape == (m, 256)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tw.int8_dot_plain(t(x8), t(w8.T)).numpy(), want)


# -- #10 then #11 against kernel E ---------------------------------------------


@pytest.mark.parametrize("m", [1, 48])
def test_materialized_w8_path_matches_fused_w4a8(m):
    """The port's version of the reference's
    ``test_materialized_w8_path_bit_identical``: #10's plain grid fed to
    #11's plain version equals kernel E's plain version (``plain`` mode)
    bit for bit, on the reference's random packed layer carried over by
    ``QuantizedLinear.from_host``; and #10's grid is the reference's
    ``dequant_w8`` grid."""
    p = random_w4a8_host(256, 384, 64, seed=4)
    p["bias"] = (0.1 * np.random.RandomState(5).randn(384)).astype(np.float32)
    layer = tq.QuantizedLinear.from_host(p, torch.float32, device="cpu")
    s8, z8 = tw.scaled_affine(layer.scales, layer.zeros, layer.wscale)
    w8 = tw.dequant_w8(layer.q4, s8, z8)
    js8, jz8, _, _ = jw._scaled_affine({key: jnp.asarray(v) for key, v in p.items()})
    np.testing.assert_array_equal(w8.numpy().T, np.asarray(jw.dequant_w8(jnp.asarray(p["q4"]),
                                                                         js8, jz8)))
    rs = np.random.RandomState(6)
    x8 = t(rs.randint(-127, 128, (m, 256)).astype(np.int8))
    xs = t((rs.rand(m, 1) + 0.5).astype(np.float32) / (127 * 16))
    for dtype in (torch.float32, torch.bfloat16):
        bias = layer.bias.to(dtype)
        fused = tw.w4a8_matmul(x8, layer.q4, layer.scales, layer.zeros, layer.wscale, xs, bias,
                               out_dtype=dtype)
        mat = tw.w8_matmul(x8, w8, layer.wscale, xs, bias, out_dtype=dtype)
        assert mat.dtype == dtype and torch.equal(mat, fused)


@pytest.mark.parametrize("m", [17, 48, 256])
@pytest.mark.parametrize("group", [32, 64])
def test_materialised_route_is_w4a8_plain_and_the_reference(m, group):
    """Mode plain's route above 16 rows ("mat"): #10's plain grid fed to
    #11's plain version with a bf16 bias equals kernel E's plain version
    (mode plain), the port's wrapper on the CPU and a numpy emulation of
    the kernels' epilogue order, bit for bit, on the reference's random
    packed layer at (K, N) = (512, 256); the reference's Pallas
    ``w4a8_matmul`` in interpret mode (bf16 out) equals, element by
    element, that order or the one whose ``* ws + bias`` XLA contracts into
    an FMA (``epilogue_orders``), bit for bit."""
    assert tw.w4a8_route(m, "plain") == "mat"
    p = random_w4a8_host(512, 256, group, seed=8)
    bias = torch.from_numpy((0.1 * np.random.RandomState(9).randn(256)).astype(np.float32))
    p["bias"] = bias.bfloat16().float().numpy()  # the model's bf16 bias, on both sides
    layer = tq.QuantizedLinear.from_host(p, torch.bfloat16, device="cpu")
    rs = np.random.RandomState(10)
    x8 = rs.randint(-127, 128, (m, 512)).astype(np.int8)
    xs = ((rs.rand(m, 1) + 0.5) / (127 * 512**0.5)).astype(np.float32)
    args = (t(x8), layer.q4, layer.scales, layer.zeros, layer.wscale, t(xs), layer.bias)
    s8, z8 = tw.scaled_affine(layer.scales, layer.zeros, layer.wscale)
    mat = tw.w8_matmul_plain(t(x8), tw.dequant_w8_plain(layer.q4, s8, z8), layer.wscale, t(xs),
                             layer.bias)
    assert mat.dtype == torch.bfloat16 and mat.shape == (m, 256)
    assert torch.equal(mat, tw.w4a8_matmul_plain(*args, mode="plain"))
    assert torch.equal(mat, tw.w4a8_matmul(*args))
    js8, jz8, jws, jbias = jw._scaled_affine({key: jnp.asarray(v) for key, v in p.items()})
    want = np.asarray(jw.w4a8_matmul(jnp.asarray(x8), jnp.asarray(p["q4"]), js8, jz8, jws,
                                     jnp.asarray(xs), jbias, bm=16, bk=512, bn=256,
                                     out_dtype=jnp.bfloat16, interpret=True).astype(jnp.float32))
    w8 = tw.dequant_w8_plain(layer.q4, s8, z8).numpy().astype(np.int64)
    two, fma = epilogue_orders(x8.astype(np.int64) @ w8.T, xs, p["wscale"], p["bias"],
                               torch.bfloat16)
    np.testing.assert_array_equal(mat.float().numpy(), two)
    assert np.all((want == two) | (want == fma))


@pytest.mark.parametrize("out", ["bf16", "fp32"])
def test_w8_matmul_plain_at_k64_matches_pallas_interpret(out):
    """#11's plain version at K = 64 (the SD3 x_embedder's depth, which the
    card runs on its 64-deep Hopper loop) at (48, 64, 256), bf16 and fp32
    out: bit for bit the numpy emulation of the kernel's epilogue order,
    and the reference's Pallas ``w8_matmul`` in interpret mode equal,
    element by element, to that order or to its FMA-contracted one, bit
    for bit."""
    tdt, jdt = {"bf16": (torch.bfloat16, jnp.bfloat16), "fp32": (torch.float32, jnp.float32)}[out]
    assert tw.w8_route(48, 64, 256) == "sm90_k64"
    rs = np.random.RandomState(11)
    x8 = rs.randint(-127, 128, (48, 64)).astype(np.int8)
    w8 = rs.randint(-127, 128, (64, 256)).astype(np.int8)  # the reference's (K, N)
    xs = ((rs.rand(48, 1) + 0.5) / (127 * 8)).astype(np.float32)
    ws = ((rs.rand(256) + 0.5) / 127).astype(np.float32)
    bias = torch.from_numpy((0.1 * rs.randn(256)).astype(np.float32)).to(tdt)
    want = np.asarray(jw.w8_matmul(jnp.asarray(x8), jnp.asarray(w8), jnp.asarray(ws),
                                   jnp.asarray(xs), jnp.asarray(bias.float().numpy()), bm=16,
                                   bk=64, bn=128, out_dtype=jdt, interpret=True
                                   ).astype(jnp.float32))
    got = tw.w8_matmul(t(x8), t(np.ascontiguousarray(w8.T)), t(ws), t(xs), bias, tdt)
    assert got.dtype == tdt and got.shape == (48, 256)
    two, fma = epilogue_orders(x8.astype(np.int64) @ w8, xs, ws, bias.float().numpy(), tdt)
    np.testing.assert_array_equal(got.float().numpy(), two)
    assert np.all((want == two) | (want == fma))


# -- the tools -----------------------------------------------------------------


def test_bench_w4a8_mat_runs_on_the_cpu():
    """Every row of the port's bench_w4a8_mat at a tiny shape: a time, and
    mat_pl and mat_xla equal to kernel, first call and last, bit for bit;
    no kernel launches on the CPU."""
    launches = (tw.dequant_w8.launches, tw.w8_matmul.launches, tw.w4a8_matmul.launches)
    rows = bench_w4a8_mat.run(40, 256, 128, iters=2, device="cpu")
    assert [r["name"] for r in rows] == ["kernel", "mat_xla", "mat_pl", "mxu8", "mxubf16"]
    assert all(r["ms"] > 0 and r["rate"] > 0 for r in rows)
    by = {r["name"]: r for r in rows}
    for key in ("y0", "y"):
        assert by["kernel"][key].dtype == torch.bfloat16 and by["kernel"][key].shape == (40, 128)
        assert torch.equal(by["mat_pl"][key], by["kernel"][key])
        assert torch.equal(by["mat_xla"][key], by["mat_pl"][key])
    assert by["mxu8"]["y0"].dtype == torch.int32
    assert (tw.dequant_w8.launches, tw.w8_matmul.launches, tw.w4a8_matmul.launches) == launches
    assert bench_w4a8_mat.launches(16) == {"dequant_w8": 35, "w8_matmul": 17,
                                           "w4a8_matmul[plain]": 17, "quantize": 1}


def test_bench_mat_runs_on_the_cpu():
    """bench_mat on the CPU: one weight copy, no time, #10's grid that of
    its plain version on the layer drawn the same way, #11 at K = 64 that
    of its plain version, and each call's bytes counted by hand."""
    shapes = {"dequant": [(256, 128, 32)], "w8": [(40, 64, 128)]}
    rows = bench_mat.run(shapes, device="cpu")
    assert [(r["name"], r["shape"], r["copies"]) for r in rows] == [
        ("dequant", (256, 128, 32), 1), ("w8", (40, 64, 128), 1)]
    assert all(f["warm_ms"] is None and f["cold_ms"] is None
               for r in rows for f in r["flows"].values())
    assert list(rows[1]["flows"]) == ["w8_matmul"]  # torch._int_mm on the card only
    gen = torch.Generator().manual_seed(0)  # run's draws, in run's order
    q4, sc, z, ws, _ = bench_gemv.layer("w4a8_matmul", 256, 128, 32, gen, torch.device("cpu"))
    s8, z8 = tw.scaled_affine(sc, z, ws)
    assert torch.equal(rows[0]["flows"]["dequant_w8"]["out"], tw.dequant_w8_plain(q4, s8, z8))
    x8 = torch.randint(-127, 128, (40, 64), generator=gen, dtype=torch.int8)
    xs = (torch.rand(40, 1, generator=gen) + 0.5) / (127 * 64**0.5)
    w8 = torch.randint(-127, 128, (128, 64), generator=gen, dtype=torch.int8)
    wsc = (torch.rand(128, generator=gen) + 0.5) / 127
    b = (0.1 * torch.randn(128, generator=gen)).bfloat16()
    assert torch.equal(rows[1]["flows"]["w8_matmul"]["out"], tw.w8_matmul_plain(x8, w8, wsc, xs, b))
    # words K*N/2, scales and zeros 8 * groups * N, the int8 grid K*N
    assert rows[0]["bytes"] == 256 * 128 // 2 + 8 * 8 * 128 + 256 * 128
    # x8, w8, xscale, wscale and bf16 bias, bf16 y
    assert rows[1]["bytes"] == 40 * 64 + 128 * 64 + 4 * 40 + 4 * 128 + 2 * 128 + 2 * 40 * 128


def test_bench_gemv_runs_on_the_cpu():
    """bench_gemv on the CPU: one row a kernel and shape, no time, one weight
    copy, and each call's output that of the kernel's plain version on a
    layer drawn the same way."""
    shapes = {"int4_matmul": [(1, 128, 256, 32)], "int8_matmul": [(2, 128, 128, 32)],
              "w4a8_matmul": [(2, 256, 128, 64)]}
    rows = bench_gemv.run(shapes, device="cpu")
    assert [(r["name"], r["shape"]) for r in rows] == [
        (name, shape) for name, ss in shapes.items() for shape in ss]
    gen = torch.Generator().manual_seed(0)  # run's draws, in run's order
    for r in rows:
        m, k, n, group = r["shape"]
        assert r["warm_ms"] is None and r["cold_ms"] is None and r["copies"] == 1
        assert r["y"].shape == (m, n) and r["y"].dtype == torch.bfloat16
        assert r["weight_bytes"] == bench_gemv.weight_bytes(r["name"], k, n, group)
        (call,) = bench_gemv.calls(r["name"], r["shape"], 1, gen, torch.device("cpu"))
        assert torch.equal(call(), r["y"])


def test_bench_gemv_runs_fp32_on_the_cpu():
    """bench_gemv's fp32 rows (C and #13 on fp32 x) on the CPU: an fp32
    output, that of the plain version on fp32 x and a layer drawn the same
    way; an ``M,K,N,group`` argument times them beside the bf16 forms."""
    from diffusionkit_tpu_torch.ops import int4_matmul as ti

    shapes = {"int4_matmul[f32]": [(1, 128, 256, 64)], "int8_matmul[f32]": [(2, 128, 128, 32)]}
    rows = bench_gemv.run(shapes, device="cpu")
    gen = torch.Generator().manual_seed(0)  # run's draws, in run's order
    for r in rows:
        m, k, n, group = r["shape"]
        assert r["y"].dtype == torch.float32 and r["y"].shape == (m, n)
        assert r["weight_bytes"] == (k * n if r["name"].startswith("int8") else k * n // 2) + \
            8 * (k // group) * n
        x = torch.randn(m, k, generator=gen)
        qw, s, z = bench_gemv.layer(r["name"], k, n, group, gen, torch.device("cpu"))
        plain = ti.int8_matmul_plain if r["name"].startswith("int8") else ti.int4_matmul_plain
        assert torch.equal(r["y"], plain(x, qw, s, z))
    got = bench_gemv.parse_shapes(["2,2432,14592,64"])
    assert got["int4_matmul[f32]"] == got["int8_matmul[f32]"] == [(2, 2432, 14592, 64)]


def test_bench_gemv_runs_w8_on_the_cpu():
    """bench_gemv's #11 rows on the CPU: the int8 entry, the quantizing
    entry and kernel D then #11, each output that of the plain versions on
    a layer drawn the same way, the weight's bytes K N + 4 N (w8 and its
    fp32 wscale); ``M,K,N`` arguments time the three."""
    from diffusionkit_tpu_torch.ops.fused_quant import quantize_plain

    shape = (2, 256, 128)
    shapes = {name: [shape] for name in bench_gemv.W8_NAMES}
    rows = bench_gemv.run(shapes, device="cpu")
    assert [r["name"] for r in rows] == list(bench_gemv.W8_NAMES)
    gen = torch.Generator().manual_seed(0)  # run's draws, in run's order
    for r in rows:
        assert r["weight_bytes"] == 256 * 128 + 4 * 128 and r["copies"] == 1
        x = (2 * torch.randn(2, 256, generator=gen)).bfloat16()
        w8 = torch.randint(-127, 128, (128, 256), generator=gen, dtype=torch.int8)
        ws = (torch.rand(128, generator=gen) + 0.5) / (127 * 256**0.5)
        b = (0.1 * torch.randn(128, generator=gen)).bfloat16()
        aq = quantize_plain(x)
        assert torch.equal(r["y"], tw.w8_matmul_plain(aq.x8, w8, ws, aq.xscale, b))
    got = bench_gemv.parse_shapes(["2,1536,9216", "1,3072,18432,64"])
    assert all(got[name] == [(2, 1536, 9216)] for name in bench_gemv.W8_NAMES)
    assert got["int4_matmul"] == [(1, 3072, 18432, 64)]
    assert bench_gemv.DEFAULT_GEMV_SHAPES["w8_matmul"] == (
        (2, 1536, 9216), (2, 1536, 3072), (2, 2048, 1536), (2, 256, 1536), (2, 1536, 1536))


def test_bench_gemv_shapes_go_to_every_kernel_that_takes_them():
    """An ``M,K,N,group`` argument times C and #13, and E where its K and
    group allow."""
    got = bench_gemv.parse_shapes(["1,3072,18432,64", "2,192,256,32", "2,1536,384,192"])
    assert got["int4_matmul"] == got["int8_matmul"] == [
        (1, 3072, 18432, 64), (2, 192, 256, 32), (2, 1536, 384, 192)]
    assert got["w4a8_matmul"] == [(1, 3072, 18432, 64)]
    assert bench_gemv.parse_shapes([]) is None


def test_bench_rows_runs_on_the_cpu():
    """bench_rows on the CPU: one row a kernel and shape, no time, one input
    copy, each call's output that of the kernel's plain version on inputs
    drawn the same way, and the bytes a call moves."""
    from diffusionkit_tpu_torch.ops.fused_quant import gelu_quantize_plain, mod_ln_quantize_plain

    shapes = {"mod_ln_quantize": [(2, 5, 256)], "gelu_quantize": [(3, 512)]}
    rows = bench_rows.run(shapes, device="cpu")
    assert [(r["name"], r["shape"]) for r in rows] == [
        ("mod_ln_quantize", (2, 5, 256)), ("gelu_quantize", (3, 512))]
    assert [r["bytes"] for r in rows] == [3 * 2560 + 4 * 10 + 4 * 512, 3 * 1536 + 4 * 3]
    gen = torch.Generator().manual_seed(0)  # run's draws, in run's order
    vec = torch.randn(2, 6 * 256, generator=gen).bfloat16()
    x = (torch.randn(2, 5, 256, generator=gen) * 2 + 0.5).bfloat16()
    y = (torch.randn(3, 512, generator=gen) * 2).bfloat16()
    wants = [mod_ln_quantize_plain(x, vec[:, None, :256], vec[:, None, 256:512]),
             gelu_quantize_plain(y)]
    for r, want in zip(rows, wants):
        assert r["warm_ms"] is None and r["cold_ms"] is None and r["copies"] == 1
        assert torch.equal(r["out"].x8, want.x8) and torch.equal(r["out"].xscale, want.xscale)
    assert bench_rows.parse_shapes(["gelu_quantize:308,6144", "mod_ln_quantize:2,154,1536"]) == {
        "gelu_quantize": [(308, 6144)], "mod_ln_quantize": [(2, 154, 1536)]}
    assert bench_rows.parse_shapes([]) is None
    with pytest.raises(ValueError, match="unknown kernel"):
        bench_rows.parse_shapes(["mod_ln:2,64"])


def test_bench_rows_times_kernel_d_on_the_cpu():
    """bench_rows' kernel D rows on the CPU: each output that of D's plain
    version on inputs drawn the same way, the bytes a call moves (the bf16
    row read, the int8 row and its fp32 scale written), and D's path shapes
    among the defaults."""
    from diffusionkit_tpu_torch.ops.fused_quant import quantize_plain

    shapes = {"quantize": [(3, 512), (2, 64)]}
    rows = bench_rows.run(shapes, device="cpu")
    assert [r["bytes"] for r in rows] == [3 * 1536 + 4 * 3, 3 * 128 + 4 * 2]
    gen = torch.Generator().manual_seed(0)
    for r in rows:
        y = (torch.randn(r["shape"], generator=gen) * 2).bfloat16()
        want = quantize_plain(y)
        assert r["warm_ms"] is None and r["copies"] == 1
        assert torch.equal(r["out"].x8, want.x8) and torch.equal(r["out"].xscale, want.xscale)
    assert {(4352, 3072), (16384, 3072), (16640, 3072), (4352, 12288), (2048, 1536)} <= set(
        bench_rows.DEFAULT_ROW_SHAPES["quantize"])
    assert bench_rows.parse_shapes(["quantize:2048,1536"]) == {"quantize": [(2048, 1536)]}


def test_bench_rows_times_the_split_row_forms_on_the_cpu():
    """bench_rows' two-pass and tiles rows on the CPU: each output that of
    the two passes' plain versions on one rank's inputs drawn the same way
    (the tiles' fp32 columns from col0), the bytes the function moves, and
    the paths' shapes among the defaults."""
    from diffusionkit_tpu_torch.ops import fused_quant as fq

    shapes = {"quantize_two_pass": [(3, 512)], "gelu_quantize_two_pass": [(2, 128)],
              "gelu_quant_tiles": [(4, 256, 256, 2)]}
    rows = bench_rows.run(shapes, device="cpu")
    assert [r["bytes"] for r in rows] == [3 * 1536 + 4 * 3, 3 * 256 + 4 * 2,
                                          5 * 1024 + 4 * 8]
    gen = torch.Generator().manual_seed(0)
    for r, form in zip(rows[:2], (None, "erf")):
        y = (torch.randn(r["shape"], generator=gen) * 2).bfloat16()
        want = fq.quantize_amax_plain(y, fq.row_absmax_plain(y, form), form)
        assert r["warm_ms"] is None and r["copies"] == 1
        assert torch.equal(r["out"].x8, want.x8) and torch.equal(r["out"].xscale, want.xscale)
    g = torch.randn(4, 256, generator=gen) * 2
    want8, want_s = fq.tile_quantize_plain(g, fq.tile_absmax_plain(g, 256, 2), 256)
    assert torch.equal(rows[2]["out"][0], want8) and torch.equal(rows[2]["out"][1], want_s)
    assert {(8192, 1216), (256, 5120)} <= set(bench_rows.DEFAULT_ROW_SHAPES["quantize_two_pass"])
    assert (8192, 4864, 0, 19) in bench_rows.DEFAULT_ROW_SHAPES["gelu_quant_tiles"]
    assert bench_rows.parse_shapes(["gelu_quant_tiles:8192,2432,2432,19"]) == {
        "gelu_quant_tiles": [(8192, 2432, 2432, 19)]}


def test_microbench_int8_runs_on_the_cpu():
    """Both rows of the port's microbench_int8 at a tiny shape (a ragged M
    of 40): a time each, and int8_dot equal to torch._int_mm, first call
    and last."""
    launches = tw.int8_dot.launches
    rows = microbench_int8.run(40, 128, 256, iters=2, device="cpu")
    assert [r["name"] for r in rows] == ["int_mm", "int8_dot"]
    assert all(r["ms"] > 0 and r["rate"] > 0 for r in rows)
    for key in ("y0", "y"):
        assert rows[1][key].dtype == torch.int32 and rows[1][key].shape == (40, 256)
        assert torch.equal(rows[1][key], rows[0][key])
    assert tw.int8_dot.launches == launches
    assert microbench_int8.launches(16) == {"int8_dot": 17}


@pytest.mark.parametrize("shape,dtype", [((1, 40, 2, 64), torch.bfloat16),
                                         ((1, 40, 1, 512), torch.bfloat16),
                                         ((1, 40, 2, 64), torch.float32),
                                         ((1, 40, 2, 128), torch.float32),
                                         ((1, 40, 1, 512), torch.float32)])
def test_bench_flash_runs_on_the_cpu(shape, dtype):
    """bench_flash at a tiny ragged shape on the CPU, in bf16 and fp32 and
    at d=512: one row per kernel (#14 not at d=512) and the library's
    attention, no time taken, the plain versions of kernel B (its output
    transposed), #15, #14 and the library's attention agreeing within bf16
    rounding (fp32: 1e-5); no kernel launches on the CPU."""
    from diffusionkit_tpu_torch.ops import flash_attention as fa
    from diffusionkit_tpu_torch.tools import bench_flash

    wrappers = (fa.flash_attention_bshd, fa.flash_attention, fa.flash_attention_stats)
    launches = [fn.launches for fn in wrappers]
    rows = bench_flash.run([shape], device="cpu", dtype=dtype)
    names = [n for n in bench_flash.NAMES if shape[-1] != 512 or n != "flash_attention_stats"]
    assert [r["name"] for r in rows] == names
    assert all(r["ms"] is None and r["tflops"] is None for r in rows)
    out = {r["name"]: r["out"].float() for r in rows}
    want = out["flash_attention_bshd"].transpose(1, 2)
    b, s, h, d = shape
    assert want.shape == (b, h, s, d)
    assert all(r["out"].dtype == (torch.float32 if r["name"] == "flash_attention_stats" else dtype)
               for r in rows)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    for name in names[1:]:
        assert torch.allclose(out[name], want, atol=tol, rtol=0), name
    assert [fn.launches for fn in wrappers] == launches


@pytest.mark.parametrize("setting", [True, False])
def test_bench_flash_leaves_the_tf32_setting_as_it_found_it(setting, monkeypatch):
    """bench_flash turns TF32 matmuls off for an fp32 run only, and puts the
    caller's setting back after it."""
    from diffusionkit_tpu_torch.tools import bench_flash

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", setting)
    seen = []
    real = bench_flash._rows

    def rows(*args):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(*args)

    monkeypatch.setattr(bench_flash, "_rows", rows)
    for dtype in (torch.float32, torch.bfloat16):
        bench_flash.run([(1, 8, 1, 64)], device="cpu", dtype=dtype)
        assert torch.backends.cuda.matmul.allow_tf32 == setting
    assert seen == [False, setting]


# Kernel names as torch.profiler reports them, demangled and mangled, and
# the family chip_smoke.py's device-time split (tools/profile_step.py's)
# files each under.
PROFILER_NAMES = [
    ("void (anonymous namespace)::flash_fwd_sm90<128, false>(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, __nv_bfloat16*, int, long long, long long, long long, float)",
     "flash_attention_bshd"),
    ("_ZN12_GLOBAL__N_114flash_fwd_sm90ILi64ELb0EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16ixxxf",
     "flash_attention_bshd"),
    ("void (anonymous namespace)::flash_fwd_sm90<64, true>(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, __nv_bfloat16*, int, long long, long long, long long, float)",
     "flash_attention"),
    ("_ZN12_GLOBAL__N_114flash_fwd_sm90ILi128ELb1EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16ixxxf",
     "flash_attention"),
    ("void (anonymous namespace)::flash_fwd_sm90_stats<128>(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, float*, float*, float*, int, int, long long, long long, long long, float)",
     "flash_attention_stats"),
    ("_ZN12_GLOBAL__N_120flash_fwd_sm90_statsILi128EEEv14CUtensorMap_stS1_S1_PfS2_S2_iixxxf",
     "flash_attention_stats"),
    ("void (anonymous namespace)::flash_fwd_sm90_stats64(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, float*, float*, int, int, float)", "flash_attention_stats"),
    ("_ZN56_GLOBAL__N__d4f5b339_23_flash_attention_sm90_cu_b995789c22flash_fwd_sm90_stats64E"
     "14CUtensorMap_stS0_S0_S0_PfS1_iif", "flash_attention_stats"),
    ("void (anonymous namespace)::flash_fwd_bhsd_small<64, true>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, std::conditional<true, float, "
     "__nv_bfloat16>::type*, float*, float*, int, int, (anonymous namespace)::Strides, "
     "(anonymous namespace)::Strides, (anonymous namespace)::Strides, "
     "(anonymous namespace)::Strides, float)", "flash_attention_stats"),
    ("_ZN12_GLOBAL__N_120flash_fwd_bhsd_smallILi64ELb1EEEvPK13__nv_bfloat16S3_S3_PNSt11conditional"
     "IXT0_EfS1_E4typeEPfS8_iiNS_7StridesES9_S9_S9_f", "flash_attention_stats"),
    ("void (anonymous namespace)::flash_fwd_wide<512, false>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, int, "
     "(anonymous namespace)::Strides, (anonymous namespace)::Strides, "
     "(anonymous namespace)::Strides, (anonymous namespace)::Strides, float)",
     "flash_attention_bshd"),
    ("_ZN12_GLOBAL__N_114flash_fwd_wideILi512ELb1EEEvPK13__nv_bfloat16S3_S3_PS1_iNS_7StridesES5_"
     "S5_S5_f", "flash_attention"),
    ("void (anonymous namespace)::flash_fwd_f32<128, 0>(float const*, float const*, float const*, "
     "float*, float*, float*, int, int)", "flash_attention_bshd"),
    ("_ZN12_GLOBAL__N_113flash_fwd_f32ILi64ELi1EEEvPKfS2_S2_PfS3_S3_ii", "flash_attention"),
    ("void (anonymous namespace)::flash_fwd_f32<64, 2>(float const*, float const*, float const*, "
     "float*, float*, float*, int, int)", "flash_attention_stats"),
    ("void (anonymous namespace)::w8_mm_sm90<int, 256>(CUtensorMap_st, CUtensorMap_st, "
     "float const*, float const*, int const*, int*, int, int, int)", "int8_dot"),
    ("_ZN12_GLOBAL__N_110w8_mm_sm90IiLi128EEEv14CUtensorMap_stS1_PKfS3_PKT_PS4_iii", "int8_dot"),
    ("void (anonymous namespace)::w8_mm_sm90<__nv_bfloat16, 128>(CUtensorMap_st, "
     "CUtensorMap_st, float const*, float const*, __nv_bfloat16 const*, __nv_bfloat16*, int, "
     "int, int)", "w8_matmul"),
    ("_ZN12_GLOBAL__N_110w8_mm_sm90IfLi256EEEv14CUtensorMap_stS1_PKfS3_PKT_PS4_iii",
     "w8_matmul"),
    ("void (anonymous namespace)::w8_mm<int, 128, 1, 1, 2>(signed char const*, "
     "signed char const*, float const*, float const*, int const*, int*, int, int, int)",
     "int8_dot"),
    ("_ZN12_GLOBAL__N_15w8_mmIiLi64ELi4ELi2ELi8EEEvPKaS2_PKfS4_PKT_PS5_iii", "int8_dot"),
    ("void (anonymous namespace)::w8_mm<__nv_bfloat16, 128, 1, 1, 2>(signed char const*, "
     "signed char const*, float const*, float const*, __nv_bfloat16 const*, __nv_bfloat16*, "
     "int, int, int)", "w8_matmul"),
    ("_ZN12_GLOBAL__N_15w8_mmIfLi64ELi4ELi1ELi8EEEvPKaS2_PKfS4_PKT_PS5_iii", "w8_matmul"),
    ("void (anonymous namespace)::w4a8_mm<2, 4, 2, 8>((anonymous namespace)::Params)",
     "w4a8_matmul"),
    ("void (anonymous namespace)::dequant_w8_kernel(unsigned int const*, float const*, "
     "float const*, signed char*, int, int, int)", "dequant_w8"),
    ("void (anonymous namespace)::dequant_w8_kernel<0>(unsigned int const*, float const*, "
     "float const*, float const*, signed char*, int, int, int)", "dequant_w8"),
    ("_ZN45_GLOBAL__N__5112a248_12_w8_matmul_cu_00cd031717dequant_w8_kernelILi1EEEvPKjPKfS4_S4_"
     "Paiii", "dequant_w8"),
    ("void (anonymous namespace)::w8_mm_sm90_k64<__nv_bfloat16>(CUtensorMap_st, CUtensorMap_st, "
     "float const*, float const*, __nv_bfloat16 const*, __nv_bfloat16*, int, int, int)",
     "w8_matmul"),
    ("_ZN12_GLOBAL__N_114w8_mm_sm90_k64IfEEv14CUtensorMap_stS1_PKfS3_PKT_PS4_iii", "w8_matmul"),
    ("void (anonymous namespace)::w8_mm_sm90_k64<int>(CUtensorMap_st, CUtensorMap_st, "
     "float const*, float const*, int const*, int*, int, int, int)", "int8_dot"),
    ("_ZN12_GLOBAL__N_114w8_mm_sm90_k64IiEEv14CUtensorMap_stS1_PKfS3_PKT_PS4_iii", "int8_dot"),
    ("void (anonymous namespace)::flash_fwd_wide_sm90<false>(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, __nv_bfloat16*, float*, float*, float*, int, int, int, long long, "
     "long long, long long, float)", "flash_attention_bshd"),
    ("_ZN12_GLOBAL__N_119flash_fwd_wide_sm90ILb1EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16PfS4_"
     "S4_iiixxxf", "flash_attention"),
    ("void (anonymous namespace)::flash_wide_merge<false>(float const*, float const*, "
     "float const*, __nv_bfloat16*, int, long long, long long, long long)",
     "flash_attention_bshd"),
    ("_ZN12_GLOBAL__N_116flash_wide_mergeILb1EEEvPKfS2_S2_P13__nv_bfloat16ixxx",
     "flash_attention"),
    ("void (anonymous namespace)::flash_fwd_3xtf32<0>(float const*, float const*, float const*, "
     "float*, int, (anonymous namespace)::Strides, (anonymous namespace)::Strides, "
     "(anonymous namespace)::Strides, (anonymous namespace)::Strides, float)",
     "flash_attention_bshd"),
    ("_ZN12_GLOBAL__N_116flash_fwd_3xtf32ILi1EEEvPKfS2_S2_PfiNS_7StridesES4_S4_S4_f",
     "flash_attention"),
    ("void (anonymous namespace)::flash_fwd_3xtf32_sm90<64, 2>(float const*, float const*, "
     "float const*, float*, float*, float*, int, int, (anonymous namespace)::Strides, "
     "(anonymous namespace)::Strides, (anonymous namespace)::Strides, "
     "(anonymous namespace)::Strides, float)", "flash_attention_stats"),
    ("_ZN12_GLOBAL__N_121flash_fwd_3xtf32_sm90ILi128ELi0EEEvPKfS2_S2_PfS3_S3_iiNS_7StridesES4_S4_"
     "S4_S4_f", "flash_attention_bshd"),
    ("void (anonymous namespace)::w4a8_mm_sm90<0, 128>(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::Params)", "w4a8_matmul"),
    ("_ZN12_GLOBAL__N_112w4a8_mm_sm90ILi2ELi64EEEv14CUtensorMap_stS1_S1_S1_NS_6ParamsE",
     "w4a8_matmul"),
    ("_ZN52_GLOBAL__N__3dfd659d_19_w4a8_matmul_sm90_cu_815f210f12w4a8_mm_sm90ILi3ELi128EEE"
     "v14CUtensorMap_stS1_S1_S1_NS_6ParamsE", "w4a8_matmul"),
    ("void (anonymous namespace)::int4_mm_sm90<128>(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, int, int, int, int)", "int4_matmul"),
    ("_ZN52_GLOBAL__N__78b407cf_19_int4_matmul_sm90_cu_5c6450d012int4_mm_sm90ILi64EEEv14CUte"
     "nsorMap_stS1_S1_S1_P13__nv_bfloat16iiii", "int4_matmul"),
    ("void (anonymous namespace)::int8_mm_sm90<64>(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, int, int, int, int)", "int8_matmul"),
    ("_ZN52_GLOBAL__N__78b407cf_19_int4_matmul_sm90_cu_5c6450d012int8_mm_sm90ILi128EEEv14CUt"
     "ensorMap_stS1_S1_S1_P13__nv_bfloat16iiii", "int8_matmul"),
    ("void (anonymous namespace)::int4_mm<1, 1, 2>(__nv_bfloat16 const*, void const*, "
     "float const*, float const*, __nv_bfloat16*, int, int, int, int, long long)",
     "int4_matmul"),
    ("void (anonymous namespace)::int8_mm<1, 1, 2>(__nv_bfloat16 const*, void const*, "
     "float const*, float const*, __nv_bfloat16*, int, int, int, int, long long)",
     "int8_matmul"),
    ("void (anonymous namespace)::int4_gemv((anonymous namespace)::Params)",
     "int4_matmul[gemv]"),
    ("_ZN45_GLOBAL__N__35495323_12_gemv_sm90_cu_138d6bc29int8_gemvENS_6ParamsE",
     "int8_matmul[gemv]"),
    ("void (anonymous namespace)::w4a8_gemv((anonymous namespace)::Params)",
     "w4a8_matmul[gemv]"),
    ("void (anonymous namespace)::w8_gemv<__nv_bfloat16, __nv_bfloat16>("
     "(anonymous namespace)::W8Params)", "w8_matmul[gemv]"),
    ("void (anonymous namespace)::w8_gemv<signed char, float>((anonymous namespace)::W8Params)",
     "w8_matmul[gemv]"),
    ("_ZN45_GLOBAL__N__35495323_12_gemv_sm90_cu_138d6bc27w8_gemvIfS1_EEvNS_8W8ParamsE",
     "w8_matmul[gemv]"),
    ("void (anonymous namespace)::quantize_kernel<__nv_bfloat16, 6>(__nv_bfloat16 const*, "
     "signed char*, float*, int, int)", "quantize"),
    ("_ZN41_GLOBAL__N__7e71744e_9_mod_ln_cu_86424f8f15quantize_kernelIfLi16EEEvPKT_PaPfii",
     "quantize"),
]


@pytest.fixture(scope="module")
def chip_smoke():
    """chip_smoke.py loaded by its path (registered while it runs: its
    dataclasses look their module up)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    try:
        spec.loader.exec_module(module)
    finally:
        del sys.modules[spec.name]
    return module


@pytest.mark.parametrize("name,family", PROFILER_NAMES)
def test_chip_smoke_files_each_kernel_under_its_family(chip_smoke, name, family):
    """The family chip_smoke.py's phase 7 splits a profiled step's device
    time by (``tools/profile_step.family``, the one copy it calls), on each
    flash and int8 GEMM instantiation's name (#14 on the Hopper kernel is
    not #15 or kernel B, #16 on the Hopper GEMM not #11)."""
    assert not hasattr(chip_smoke, "family")
    assert chip_smoke.profile_step.family(name) == family


PTXAS_LOG = """
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119flash_fwd_wide_sm90ILb0EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119flash_fwd_wide_sm90ILb0EEEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 203 registers, used 2 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120flash_fwd_bhsd_smallILi64ELb1EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120flash_fwd_bhsd_smallILi64ELb1EEEv
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size
"""


@pytest.mark.parametrize("bad", [None, "spill", "C7512"])
def test_chip_smoke_ptxas_report_holds_the_new_kernels_to_no_spill(chip_smoke, tmp_path, bad):
    """chip_smoke's phase-2 report on a ptxas log: an older kernel's spill is
    reported and allowed, a spill in the d=512 or 3xTF32 flash kernels or a
    C7512 line anywhere fails the phase."""
    log = PTXAS_LOG
    if bad == "spill":
        log = log.replace("0 bytes spill stores", "16 bytes spill stores")
    elif bad == "C7512":
        log += ("ptxas /tmp/x.ptx, line 9; warning : (C7512) Potential Performance Loss: "
                "wgmma.mma_async instructions are serialized\n")
    path = tmp_path / "lib.log"
    path.write_text(log)
    if bad is None:
        chip_smoke.ptxas_report(path)
    else:
        with pytest.raises(AssertionError, match="ptxas"):
            chip_smoke.ptxas_report(path)


HOPPER_MATMULS = [
    "_ZN52_GLOBAL__N__3dfd659d_19_w4a8_matmul_sm90_cu_815f210f12w4a8_mm_sm90ILi1ELi64EEEv",
    "_ZN52_GLOBAL__N__78b407cf_19_int4_matmul_sm90_cu_5c6450d012int4_mm_sm90ILi128EEEv",
    "_ZN52_GLOBAL__N__78b407cf_19_int4_matmul_sm90_cu_5c6450d012int8_mm_sm90ILi64EEEv",
    "_ZN45_GLOBAL__N__35495323_12_gemv_sm90_cu_138d6bc29int4_gemvENS_6ParamsE",
    "_ZN45_GLOBAL__N__35495323_12_gemv_sm90_cu_138d6bc29int8_gemvENS_6ParamsE",
    "_ZN45_GLOBAL__N__35495323_12_gemv_sm90_cu_138d6bc29w4a8_gemvENS_6ParamsE",
    "_ZN45_GLOBAL__N__35495323_12_gemv_sm90_cu_138d6bc27w8_gemvIaS1_EEvNS_8W8ParamsE",
    "_ZN12_GLOBAL__N_114w8_mm_sm90_k64I13__nv_bfloat16EEv14CUtensorMap_stS2_PKfS4_PKT_PS5_iii",
    "_ZN45_GLOBAL__N__5112a248_12_w8_matmul_cu_00cd031717dequant_w8_kernelILi0EEEvPKjPKfS4_S4_"
    "Paiii",
]


ROW_KERNELS = [
    "_ZN41_GLOBAL__N__7e71744e_9_mod_ln_cu_86424f8f19mod_ln_quant_kernelI13__nv_bfloat16Li6EEEvPKT_"
    "S4_S4_PaPfiixf",
    "_ZN41_GLOBAL__N__7e71744e_9_mod_ln_cu_86424f8f20gelu_quantize_kernelIfLi3ELi0EEEvPKT_PaPfi",
    "_ZN41_GLOBAL__N__7e71744e_9_mod_ln_cu_86424f8f15quantize_kernelI13__nv_bfloat16Li6EEEvPKT_"
    "PaPfii",
]


@pytest.mark.parametrize("entry", ROW_KERNELS)
@pytest.mark.parametrize("spill", [0, 4])
def test_chip_smoke_ptxas_report_holds_the_row_kernels_to_no_spill(chip_smoke, tmp_path, entry,
                                                                   spill):
    """The row kernels A', D and #4 fail phase 2 on any spill."""
    log = (f"ptxas info    : Compiling entry function '{entry}' for 'sm_90a'\n"
           f"    8 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
           "ptxas info    : Used 48 registers, used 16 barriers\n")
    path = tmp_path / "lib.log"
    path.write_text(PTXAS_LOG + log)
    if spill:
        with pytest.raises(AssertionError, match="spills"):
            chip_smoke.ptxas_report(path)
    else:
        chip_smoke.ptxas_report(path)


@pytest.mark.parametrize("entry", HOPPER_MATMULS)
@pytest.mark.parametrize("spill", [0, 8])
def test_chip_smoke_ptxas_report_holds_the_hopper_matmuls_to_no_spill(chip_smoke, tmp_path, entry,
                                                                       spill):
    """The Hopper main loops of kernels E, C and #13, the M <= 16 GEMVs of
    C, #13, E and #11, #11's 64-deep Hopper loop and #10 fail phase 2 on
    any spill, as the flash kernels redesigned before them."""
    log = (f"ptxas info    : Compiling entry function '{entry}' for 'sm_90a'\n"
           f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
           "ptxas info    : Used 168 registers, used 16 barriers\n")
    path = tmp_path / "lib.log"
    path.write_text(PTXAS_LOG + log)
    if spill:
        with pytest.raises(AssertionError, match="spills"):
            chip_smoke.ptxas_report(path)
    else:
        chip_smoke.ptxas_report(path)


@pytest.mark.parametrize("spill", [0, 8])
def test_chip_smoke_ptxas_report_holds_the_d64_stats_kernel_to_no_spill(chip_smoke, tmp_path,
                                                                         spill):
    """#14's 64-row kernel at d = 64 fails phase 2 on any spill (the
    mma.sync kernel it replaced spilled 8 bytes)."""
    entry = ("_ZN56_GLOBAL__N__d4f5b339_23_flash_attention_sm90_cu_b995789c"
             "22flash_fwd_sm90_stats64E14CUtensorMap_stS0_S0_S0_PfS1_iif")
    log = (f"ptxas info    : Compiling entry function '{entry}' for 'sm_90a'\n"
           f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
           "ptxas info    : Used 154 registers, used 2 barriers\n")
    path = tmp_path / "lib.log"
    path.write_text(PTXAS_LOG + log)
    if spill:
        with pytest.raises(AssertionError, match="spills"):
            chip_smoke.ptxas_report(path)
    else:
        chip_smoke.ptxas_report(path)


def test_chip_smoke_counts_the_sd3_ring_path(chip_smoke):
    """Path h (SD3-medium 1024² through the one-rank ring): every joint
    attention one #14 call, 24 blocks x 50 steps, kernel B only in the VAE
    mid-block, kernel A as path a; its flash twin h' launches as path a."""
    from diffusionkit_tpu_torch.config import SD3_2b

    ring = chip_smoke.per_request_launches(chip_smoke.SD3_RING, SD3_2b)
    plain = chip_smoke.per_request_launches(chip_smoke.SD3, SD3_2b)
    assert chip_smoke.SD3_RING.latent == (128, 128) and chip_smoke.SD3_RING.steps == 50
    assert ring == {"flash_attention_stats": 1200, "flash_attention_bshd": 1,
                    "mod_ln": plain["mod_ln"]}
    assert chip_smoke.per_request_launches(chip_smoke.SD3_RING_TWIN, SD3_2b) == plain
    assert plain["flash_attention_bshd"] == 1201
    assert len(chip_smoke.SD3_RING_TWIN.requests) == 1


@pytest.mark.parametrize("path,dual,uni,img,txt", [
    ("flux-w4a8", 19, 38, 4096, 256), ("flux-w4a8-2048-ring", 19, 38, 16384, 256),
    ("flux-w4a8-t5w8a8", 19, 38, 4096, 256)])
def test_chip_smoke_counts_the_materialised_route_on_the_flux_paths(chip_smoke, path, dual, uni,
                                                                    img, txt):
    """A FLUX w4a8 request's launches: mode plain's 8 calls a dual block and
    3 a single block, the `ada` GEMVs (M = 1) on kernel E, every other
    (v/o of the image stream and the single blocks, the text stream's
    q/k/v/o: 190 a step at 19 + 38 blocks) on #10 then #11, 4 steps; the
    w8a8 T5's 7 products a layer on #11 besides (path f)."""
    from diffusionkit_tpu_torch.config import FLUX_SCHNELL

    p = {q.name: q for q in (chip_smoke.FLUX_W4A8, chip_smoke.FLUX_RING, chip_smoke.FLUX_E2E)}[path]
    per = chip_smoke.per_request_launches(p, FLUX_SCHNELL)
    mat = p.steps * (6 * dual + 2 * uni)
    assert (p.steps, (p.latent[0] // 2) ** 2, p.txt_tokens) == (4, img, txt)
    assert per["w4a8_matmul[mat]"] == per["dequant_w8"] == mat == 760
    t5 = 7 * chip_smoke.T5_LAYERS if path == "flux-w4a8-t5w8a8" else 0
    assert per["w8_matmul"] == mat + t5
    assert per["w4a8_matmul[gemv]"] == p.steps * (2 * dual + uni)
    assert per["w4a8_matmul[plain]"] == 0  # kernel E's Hopper loop, apart from its GEMV


@pytest.mark.parametrize("path", ["sd3-int8-fp32", "flux-fp32"])
def test_chip_smoke_counts_the_fp32_paths_on_fp32_forms(chip_smoke, path):
    """Paths y and z: every counted launch on its fp32 form, the fp32 GEMV
    exactly each step's `ada`s (and on y the y / t embedders' and the final
    `ada`) times the steps (SD3-medium: 2 a block, 24 blocks, 53 a CFG
    forward; FLUX.1-schnell: 2 a dual block and 1 a single, 76 a step),
    counted exactly; kernel B once more in the fp32 decoder; no C on y, no
    #13 on z; and the kernels line names the new GEMV on that path."""
    from diffusionkit_tpu_torch.config import FLUX_SCHNELL, SD3_2b

    p = {q.name: q for q in (chip_smoke.SD3_INT8_FP32, chip_smoke.FLUX_FP32)}[path]
    sd3 = path.startswith("sd3")
    per = chip_smoke.per_request_launches(p, SD3_2b if sd3 else FLUX_SCHNELL)
    name = "int8_matmul" if sd3 else "int4_matmul"
    assert per[f"{name}[f32-gemv]"] == per[f"{name}[gemv]"] == (50 * 53 if sd3 else 4 * 76)
    assert f"{name}[f32-gemv]" in chip_smoke.EXACT
    assert chip_smoke.MAIN_PATH[f"{name}[f32-gemv]"] == path
    for k in chip_smoke.F32_COUNTED:
        assert per.get(f"{k}[f32]", 0) == per.get(k, 0), k
    assert per["flash_attention_bshd"] == p.steps * (24 if sd3 else 57) + 1
    other = "int4_matmul" if sd3 else "int8_matmul"
    assert per.get(other, 0) == 0 and per.get("w4a8_matmul[gemv]", 0) == 0


def test_chip_smoke_counts_kernel_e_plain_apart_from_its_gemv(chip_smoke):
    """The kernels line's mode plain entry counts kernel E's Hopper loop
    alone, not the M <= 16 GEMV counted in its own entry; since mode plain
    above 16 rows runs #10 then #11, that loop's launches are read from the
    tool path whose kernel row still runs it."""
    chip_smoke.reset_counts()
    try:
        tw.w4a8_matmul.mode_launches["plain"] = 5
        tw.w4a8_matmul.gemv_launches = 3
        got = chip_smoke.counts()
    finally:
        chip_smoke.reset_counts()
    assert (got["w4a8_matmul[plain]"], got["w4a8_matmul[gemv]"]) == (2, 3)
    assert chip_smoke.MAIN_PATH["w4a8_matmul[plain]"] in chip_smoke.TOOLS
    tool = chip_smoke.TOOLS[chip_smoke.MAIN_PATH["w4a8_matmul[plain]"]]
    assert tool.launches(chip_smoke.DEFAULT_ITERS)["w4a8_matmul[plain]"] > 0


SASS_OLD = """
code for sm_90a
        Function : _ZN45_GLOBAL__N__5112a248_12_w8_matmul_cu_00cd03175w8_mmIiLi128EEEv
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
                                                                 /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;            /* 0x0000000000007919 */
        Function : _ZN45_GLOBAL__N__5112a248_12_w8_matmul_cu_00cd031717dequant_w8_kernelEv
        /*0000*/                   EXIT ;                        /* 0x000000000000794d */
"""
SASS_NEW = """
code for sm_90a
        Function : _ZN45_GLOBAL__N__81d0dac6_12_w8_matmul_cu_00cd03175w8_mmIiLi128EEEv
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
                                                                 /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;            /* 0x0000000000007919 */
        Function : _ZN45_GLOBAL__N__81d0dac6_12_w8_matmul_cu_00cd031717dequant_w8_kernelEv
        /*0000*/                   NOP ;                         /* 0x0000000000007918 */
        /*0010*/                   EXIT ;                        /* 0x000000000000794d */
        Function : _ZN45_GLOBAL__N__81d0dac6_12_w8_matmul_cu_00cd031710w8_mm_sm90Ev
        /*0000*/                   EXIT ;                        /* 0x000000000000794d */
"""


def test_sass_diff_matches_kernels_across_builds():
    """sass_diff on two disassemblies of one source: a kernel matches its
    counterpart whatever the translation unit's hash, its addresses and
    encodings; a changed body DIFFERS; a new kernel is "only new"."""
    from diffusionkit_tpu_torch.tools.sass_diff import compare, sass_functions

    old, new = sass_functions(SASS_OLD), sass_functions(SASS_NEW)
    assert old["_ZN45_GLOBAL__N__12_w8_matmul_cu_00cd03175w8_mmIiLi128EEEv"] == [
        "LDC R1, c[0x0][0x28] ;", "S2R R0, SR_TID.X ;"]
    assert compare(old, new) == [  # by name
        ("only new", "_ZN45_GLOBAL__N__12_w8_matmul_cu_00cd031710w8_mm_sm90Ev", 0, 1),
        ("DIFFERS", "_ZN45_GLOBAL__N__12_w8_matmul_cu_00cd031717dequant_w8_kernelEv", 1, 2),
        ("IDENTICAL", "_ZN45_GLOBAL__N__12_w8_matmul_cu_00cd03175w8_mmIiLi128EEEv", 2, 2),
    ]


SASS_PATHS = """
        Function : _ZN4rowsEv
        /*0000*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        /*0010*/                   FCHK P0, R4, R5 ;
        /*0020*/              @!P0 BRA 0x50 ;
        /*0030*/                   MOV R4, 0x50 ;
        /*0040*/                   CALL.REL.NOINC 0x200 ;
        /*0050*/               @P1 BRA P2, 0x90 ;
        /*0060*/                   FCHK P0, R6, R5 ;
        /*0070*/                   FFMA R6, R6, R5, RZ ;
        /*0080*/                   NOP ;
        /*0090*/              @!P2 BRA 0xd0 ;
        /*00a0*/                   FCHK P0, R7, R5 ;
        /*00b0*/                   STG.E desc[UR4][R2.64], R6 ;
        /*00c0*/                   NOP ;
        /*00d0*/                   EXIT ;
        /*00e0*/                   CALL.REL.NOINC 0x200 ;
        /*00f0*/                   BRA 0xf0;
"""


def test_sass_main_path_leaves_out_slow_path_calls():
    """sass_diff's main path runs from the entry to the first EXIT, jumps
    over a division's call of its slow path but not over other skipped
    blocks (a masked block a row's active threads run), and counts no NOP
    and nothing past the EXIT (the slow path itself)."""
    from diffusionkit_tpu_torch.tools.sass_diff import listings, main_path, sass_functions

    listing = listings(SASS_PATHS)["_ZN4rowsEv"]
    assert len(listing) == len(sass_functions(SASS_PATHS)["_ZN4rowsEv"]) == 16
    assert listing[2] == (0x20, "@!P0 BRA 0x50 ;")
    # LDG, FCHK, BRA (over the call), BRA, FCHK, FFMA, BRA, FCHK, STG, EXIT
    assert main_path(listing) == 10


def test_tool_arguments_default_to_the_references():
    from diffusionkit_tpu_torch.tools import parse_args, widen

    assert parse_args([]) == (4352, 3072, 12288, 16)
    assert parse_args(["8", "64", "32"]) == (8, 64, 32, 16)
    assert parse_args(["8", "64", "32", "3"]) == (8, 64, 32, 3)
    y = torch.arange(6).reshape(2, 3)
    assert torch.equal(widen(y, 5), torch.tensor([[0, 1, 2, 0, 1], [3, 4, 5, 3, 4]]))
    assert torch.equal(widen(y, 2), y[:, :2])
