"""The port's tensor and data parallelism against the JAX package on the CPU.

The Megatron shard plan (``parallel/sharding.py``) is held leaf for leaf
against the reference's ``mmdit_shardings`` / ``t5_shardings`` through
``convert.py``'s name map, and at full width (built on ``meta``) for where
each split linear lands. The sharded forwards and pipelines run in gloo
ranks, as tests/test_torch_ring.py runs its ring: ``python -c``
subprocesses of ``RANK_CODE`` that import the port and never jax (each
reports its jax modules), one spawn of 2 ranks (meshes (1, 2) and (2, 1))
and one of 4 (mesh (2, 2)); the JAX side runs GSPMD on the virtual 8-device
CPU mesh of ``tests/conftest.py``, as tests/test_parallel.py runs it.

Tolerances, each stated where it is used: fp32 models as
tests/test_parallel.py holds its sharded forwards (atol 2e-4, rtol 1e-4:
partial products summed in another order); w8a8, and w4a8 against the
reference's TPU dispatch in interpret mode, up to int8 flips (XLA
contracts some epilogue products into FMAs; tests/test_torch_w4a8.py's
``assert_close_up_to_flips``); pipelines as tests/test_torch_flux.py's
(latents 1e-3, pixels one level).
"""

import collections
import copy
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import PartitionSpec as P

from diffusionkit_tpu.config import FLUX_SCHNELL as JAX_FLUX
from diffusionkit_tpu.config import MMDiTConfig as JaxMMDiTConfig
from diffusionkit_tpu.config import PositionalEncoding as JaxPositionalEncoding
from diffusionkit_tpu.config import T5Config as JaxT5Config
from diffusionkit_tpu.models import apply_mmdit, apply_t5_encoder, init_mmdit_params, init_t5_params
from diffusionkit_tpu.ops import w4a8_matmul as jw
from diffusionkit_tpu.ops.quantized import MIXED_OVERRIDES, quantize_tree
from diffusionkit_tpu.ops.w8a8 import w8a8_tree
from diffusionkit_tpu.parallel import create_mesh as jax_create_mesh
from diffusionkit_tpu.parallel import (
    data_sharding, mmdit_shardings, shard_params, t5_shardings,
)
from diffusionkit_tpu_torch import config as tcfg
from diffusionkit_tpu_torch.convert import mmdit_from_jax, t5_from_jax
from diffusionkit_tpu_torch.models.mmdit import MMDiT
from diffusionkit_tpu_torch.ops import fused_quant as tfq
from diffusionkit_tpu_torch.ops.int4_matmul import dequantize_int4, dequantize_int8
from diffusionkit_tpu_torch.ops.quantized import QuantizedLinear
from diffusionkit_tpu_torch.ops.w4a8_matmul import w4a8_linear
from diffusionkit_tpu_torch.ops.w8a8 import W8A8Linear, w8a8_linear
from diffusionkit_tpu_torch.parallel import collectives, local_mesh, shard_module_
from diffusionkit_tpu_torch.parallel.sharding import mmdit_plan, off_kernel, routes, t5_plan
from diffusionkit_tpu_torch.pipeline import DiffusionPipeline, FluxPipeline

from test_torch_flux import flux_pipelines  # noqa: F401 (a fixture)
from test_torch_flux import flux_inputs, randomize_packed, with_unit_qk_scales
from test_torch_models import randomize, torch_config
from test_torch_pipeline import NEGATIVE, PROMPT, SEED
from test_torch_pipeline import pipelines as sd3_pipelines  # noqa: F401 (a fixture)
from test_torch_ring import tiny_flux_params
from test_torch_w4a8 import assert_close_up_to_flips
from test_torch_w4a8 import jax_tpu_dispatch  # noqa: F401 (a fixture)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

# One rank: join the group, run every case of the job on its mesh, save the
# outputs, the collectives each forward issued, and whether any jax module
# was imported.
RANK_CODE = """
import copy, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from diffusionkit_tpu_torch import pipeline as pl
from diffusionkit_tpu_torch.ops.common import linear
from diffusionkit_tpu_torch.ops.fused_quant import quantize_two_pass
from diffusionkit_tpu_torch.parallel import (
    axis_index, axis_size, collectives, create_mesh, group, init_distributed, shard_module_)
job_path, rank, world, init = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]


class TinyT5Tokenizer:  # tests/test_pipeline.py's, which the ranks do not import
    max_length, pad_with_eos, pad_token = 16, False, 0

    def tokenize(self, text):
        return [(ord(c) % 50) + 1 for c in text[: self.max_length - 1]] + [1]


init_distributed(init, world, rank, device="cpu")
job = torch.load(job_path, weights_only=False)
out = {}
for name, case in job.get("forward", {}).items():
    mesh = create_mesh(*case["mesh"], device="cpu")
    model = shard_module_(copy.deepcopy(case["model"]), mesh)
    for attr in case.get("keep_whole", ()):  # put back whole after the split
        setattr(model, attr, copy.deepcopy(getattr(case["model"], attr)))
    d, r = axis_size(mesh, "data"), axis_index(mesh, "data")
    args = [a.chunk(d)[r] if case.get("split_batch") else a for a in case["inputs"]]
    collectives.stats.reset()
    with torch.no_grad():
        y = model(*args, **case.get("kw", {}), **({"mesh": mesh} if case.get("mesh_kw") else {}))
    out[name] = {"out": y, "stats": collectives.stats.snapshot(),
                 "sizes": {k: dict(v) for k, v in collectives.stats.sizes.items()}}
    if case.get("keep_whole"):  # the unsharded forward in this process, its threads
        with torch.no_grad():
            out[name]["whole"] = case["model"](*args)
for name, case in job.get("rows", {}).items():
    mesh = create_mesh(*case["mesh"], device="cpu")
    holder = shard_module_(copy.deepcopy(case["holder"]), mesh)
    n, i = axis_size(mesh, "model"), axis_index(mesh, "model")
    x = case["x"].chunk(n, dim=-1)[i].contiguous()
    with torch.no_grad():
        out[name] = {"linear": linear(holder.o, x),
                     "quantize": quantize_two_pass(x, group(mesh, "model")),
                     "gelu_quantize": quantize_two_pass(x, group(mesh, "model"), "erf")}
for name, case in job.get("pipeline", {}).items():
    mesh = create_mesh(*case["mesh"], device="cpu")
    pipe = getattr(pl, case["cls"])(load=False, low_memory_mode=False, a16=False, device="cpu",
                                     mesh=mesh, **case["kw"])
    for attr, m in case["models"].items():
        setattr(pipe, attr, copy.deepcopy(m))
    if case.get("tiny_t5_tokenizer"):
        pipe.t5_tokenizer = TinyT5Tokenizer()
    res = {}
    req = case["request"]
    cond, pooled = pipe.encode_text(req["text"], req["cfg"], req["negative"])
    for n_img in (2, 3):
        lat, _ = pipe.denoise_latents(cond, pooled, num_steps=2, cfg_weight=req["cfg"],
                                      latent_size=(8, 8), seed=req["seed"], num_images=n_img)
        res[f"latents{n_img}"] = lat
    imgs = pipe.generate_images_batched(req["texts"], num_steps=2, cfg_weight=req["cfg"],
                                        latent_size=(8, 8), seeds=req["seeds"])
    res["batched"] = np.stack([np.asarray(im) for im in imgs])
    out[name] = res
out["jax_modules"] = sorted(m for m in sys.modules
                            if m == "jax" or m.startswith(("jax.", "diffusionkit_tpu.")))
torch.save(out, f"{job_path}.rank{rank}")
dist.destroy_process_group()
"""


def run_ranks(tmp: Path, world: int, job: dict) -> list:
    """Run ``job`` in ``world`` gloo ranks; each rank's outputs."""
    job_path = tmp / "job.pt"
    torch.save(job, job_path)
    init = f"file://{tmp / 'rendezvous'}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", RANK_CODE, str(job_path), str(r), str(world),
                               init], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [torch.load(f"{job_path}.rank{r}", weights_only=False) for r in range(world)]


# -- tiny models (tests/test_parallel.py's widths; model axis 2 divides) ------

TP_SD3 = JaxMMDiTConfig(depth_multimodal=2, num_heads=4, hidden_size_override=64,
                        max_latent_resolution=16, dtype=jnp.float32)
TP_FLUX = JaxMMDiTConfig(depth_multimodal=1, depth_unified=2, num_heads=4,
                         hidden_size_override=64, patchify_via_reshape=True,
                         pos_embed_type=JaxPositionalEncoding.PreSDPARope,
                         rope_axes_dim=(4, 6, 6), pooled_text_embed_dim=32, use_qk_norm=True,
                         dtype=jnp.float32)
# The w4a8 FLUX of tests/test_torch_w4a8.py (hidden 256, two heads of 128):
# at two model ranks every split linear keeps kernel E's shapes (local N of
# 128, fc1's 512 a scale tile), so the sharded forward takes E's modes.
W4A8_FLUX = dataclasses.replace(JAX_FLUX, depth_multimodal=1, depth_unified=2, num_heads=2,
                                hidden_size_override=256, rope_axes_dim=(16, 56, 56),
                                dtype=jnp.float32)
TP_T5 = JaxT5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4)
CONFIGS = {"sd3": TP_SD3, "flux": TP_FLUX}


def mmdit_inputs(config, b=2):
    """tests/test_parallel.py's ``_mmdit_inputs``."""
    rs = np.random.RandomState(0)
    return [rs.randn(b, 8, 8, 16).astype(np.float32),
            rs.randn(b, 8, config.token_level_text_embed_dim).astype(np.float32),
            rs.randn(b, config.pooled_text_embed_dim).astype(np.float32),
            np.array([500.0] * b, np.float32)]


def float_tree(config, seed=3):
    params = randomize(init_mmdit_params(jax.random.PRNGKey(0), config), seed=seed)
    return with_unit_qk_scales(params) if config.depth_unified else params


def mmdit_tree(name: str, mode: str):
    """The JAX tree of a forward case: float, or quantized from it as
    tests/test_parallel.py quantizes (int8 at group 64 on hidden 64: one
    quant group in o's input, so o is gathered); w4a8 is its own model."""
    if mode == "w4a8":
        params = init_mmdit_params(jax.random.PRNGKey(0), W4A8_FLUX, quantize_bits=4)
        params = randomize_packed(params, seed=20)
        floats = {k: v for k, v in params.items() if k not in ("mm_blocks", "uni_blocks")}
        params.update(randomize(floats, seed=21))
        return jw.add_wscale_tree(with_unit_qk_scales(params)), W4A8_FLUX
    config = CONFIGS[name]
    params = float_tree(config)
    host = jax.tree.map(np.asarray, params)
    if mode == "int4":
        params = quantize_tree(host, bits=4, group_size=16, min_size=1, min_dim=1)
    elif mode == "int8":
        params = quantize_tree(host, bits=8, group_size=64, min_size=1, min_dim=1)
    elif mode == "int4-mixed":
        params = quantize_tree(host, bits=4, group_size=16, min_size=1, min_dim=1,
                               overrides=MIXED_OVERRIDES)
    elif mode == "w8a8":
        params = w8a8_tree(host, min_size=1, min_dim=1)
    return params, config


def jax_sharded(params, config, inputs, data: int, model: int) -> np.ndarray:
    """tests/test_parallel.py's GSPMD forward: the plan's shardings, the
    inputs split over ``data``."""
    mesh = jax_create_mesh(data, model, devices=jax.devices()[: data * model])
    sharded = shard_params(params, mmdit_shardings(params, mesh))
    args = [jax.device_put(jnp.asarray(x), data_sharding(mesh, x.ndim)) for x in inputs]
    return np.asarray(jax.jit(lambda p, *a: apply_mmdit(p, config, *a))(sharded, *args))


FORWARD_MODES = ["float", "int4", "int8", "w8a8", "int4-mixed"]
FORWARD_CASES = [(name, mode) for name in ("sd3", "flux") for mode in FORWARD_MODES] + [
    ("flux", "w4a8")]


def forward_job(mesh) -> dict:
    job = {}
    for name, mode in FORWARD_CASES:
        params, config = mmdit_tree(name, mode)
        model = mmdit_from_jax(params, torch_config(config, tcfg.MMDiTConfig), device="cpu")
        inputs = mmdit_inputs(config, b=1 if mode == "w4a8" else 2)
        job[f"{name}-{mode}"] = {"model": model, "inputs": list(map(torch.from_numpy, inputs)),
                                 "mesh": mesh, "split_batch": mode != "w4a8", "mesh_kw": True}
    if mesh == (1, 2):  # batch 1: the reference's _ada needs data to divide it
        jcfg, params = tiny_flux_params()
        job["flux-ring"] = {
            "model": mmdit_from_jax(params, torch_config(jcfg, tcfg.MMDiTConfig), device="cpu"),
            "inputs": list(map(torch.from_numpy, flux_inputs())), "mesh": mesh,
            "mesh_kw": True, "kw": {"sdpa_impl": "ring"}}
    for mode in ("fp32", "w8a8"):
        params = t5_tree(mode)
        job[f"t5-{mode}"] = {"model": t5_from_jax(params, torch_config(TP_T5, tcfg.T5Config),
                                                  device="cpu"),
                             "inputs": [torch.from_numpy(T5_TOKENS).long()], "mesh": mesh}
    return job


T5_TOKENS = np.asarray([[5, 3, 9, 1, 2, 8, 7, 4]], np.int32)

# SD3.5-large's ratios at a tiny size: heads of 64 (6 heads: 3 a rank over
# 2, a head and a half over 4, as 38 heads give 19 and 9.5), hidden 384
# (192 a rank over 2: not a multiple of kernel E's 128-column tile, as 1216
# is not), fc1 1536 (768 and 384 a rank: not a multiple of E's 512-column
# scale tile, as 4864 is not), o's six group-64 scale rows (three a rank
# over 2, not whole over 4, as 38 give 19 and 9.5), QK-norm, block 1 in fp32.
# Its split linears take SD3.5-large's routes (off_kernel lists the same).
SD35_RATIOS = JaxMMDiTConfig(depth_multimodal=3, num_heads=6, hidden_size_override=384,
                             max_latent_resolution=16, use_qk_norm=True,
                             upcast_multimodal_blocks=(1,), dtype=jnp.float32)
SD35_TP_MODES = ["int4", "w4a8"]


def sd35_tree(mode: str):
    """SD35_RATIOS' JAX tree, its block linears drawn packed at group 64
    (the 4-bit release's layout): int4, or w4a8 with its wscale."""
    params = init_mmdit_params(jax.random.PRNGKey(0), SD35_RATIOS, quantize_bits=4)
    params = randomize_packed(params, seed=22)
    floats = {k: v for k, v in params.items() if k not in ("mm_blocks", "mm_final")}
    params.update(randomize(floats, seed=23))
    return jw.add_wscale_tree(params) if mode == "w4a8" else params


# The float linears the plan splits in the MMDiT: their fp32 sums in another
# order are a split model's only inexact steps.
SPLIT_FLOATS = ("t_embedder", "y_embedder", "final_layer")


def sd35_job(n: int) -> dict:
    """The SD3.5-ratio forwards over a (1, n) mesh; w4a8 also with the split
    float linears put back whole."""
    job = {}
    for mode in SD35_TP_MODES:
        model = mmdit_from_jax(sd35_tree(mode), torch_config(SD35_RATIOS, tcfg.MMDiTConfig),
                               device="cpu")
        job[f"sd35-{mode}"] = {"model": model, "mesh": (1, n), "mesh_kw": True,
                               "inputs": list(map(torch.from_numpy, mmdit_inputs(SD35_RATIOS)))}
    job["sd35-w4a8-floats-whole"] = {**job["sd35-w4a8"], "keep_whole": SPLIT_FLOATS}
    return job


def t5_tree(mode: str):
    params = randomize(init_t5_params(jax.random.PRNGKey(0), TP_T5), seed=1)
    for ln in (params["layers"]["ln1"], params["layers"]["ln2"], params["final_ln"]):
        ln["weight"] = ln["weight"] + 1.0
    if mode == "w8a8":
        params = w8a8_tree(jax.tree.map(np.asarray, params), min_size=1, min_dim=1)
    return params


# The rows case: a w8a8, a w4a8, a bf16 and an int4 / int8 weight-only fan-in
# linear (K = 1024, N = 256; group 64, so each of 4 ranks holds 4 groups)
# and an activation, for the int32 reduction, the fp32 partial sums and the
# two-pass quantizers.
ROWS_K, ROWS_N = 1024, 256


def rows_case(kind: str) -> dict:
    gen = torch.Generator().manual_seed(7)
    holder = torch.nn.Module()
    if kind == "bf16":
        holder.o = torch.nn.Linear(ROWS_K, ROWS_N, dtype=torch.bfloat16).requires_grad_(False)
        holder.o.weight.normal_(0, ROWS_K**-0.5, generator=gen)
    elif kind == "w8a8":
        holder.o = W8A8Linear(ROWS_K, ROWS_N, dtype=torch.float32)
        holder.o.w8.random_(-127, 128, generator=gen)
        holder.o.wscale.uniform_(1e-3, 2e-3, generator=gen)
    elif kind in ("int4", "int8"):
        bits = int(kind[3])
        holder.o = QuantizedLinear(ROWS_K, ROWS_N, 64, dtype=torch.bfloat16, bits=bits)
        if bits == 4:
            holder.o.q4.random_(-2**31, 2**31 - 1, generator=gen)
        else:
            holder.o.q8.random_(0, 256, generator=gen)
        holder.o.scales.uniform_(5e-4, 1e-3, generator=gen).mul_(16 if bits == 4 else 1)
        holder.o.zeros.uniform_(-8e-3, -4e-3, generator=gen).mul_(16 if bits == 4 else 32)
    else:
        holder.o = QuantizedLinear(ROWS_K, ROWS_N, 64, dtype=torch.float32, wscale=True)
        holder.o.q4.random_(-2**31, 2**31 - 1, generator=gen)
        holder.o.scales.uniform_(5e-4, 1e-3, generator=gen)
        holder.o.zeros.uniform_(-8e-3, -4e-3, generator=gen)
        from diffusionkit_tpu_torch.ops.quantized import add_wscale_
        holder.o.wscale = None
        add_wscale_(holder)
    holder.o.bias.normal_(0, 0.1, generator=gen)
    x = torch.randn(37, ROWS_K, generator=gen)
    x[3, 5] = 40.0  # an outlier on the first rank's columns sets a row's scale
    return {"holder": holder, "x": x.to(holder.o.bias.dtype)}


def rows_job(mesh) -> dict:
    return {kind: {**rows_case(kind), "mesh": mesh}
            for kind in ("w8a8", "w4a8", "bf16", "int4", "int8")}


# -- the pipelines ---------------------------------------------------------------

SD3_REQUEST = {"text": PROMPT, "negative": NEGATIVE, "cfg": 5.0, "seed": SEED,
               "texts": ["a cat", "a dog", "a red car"], "seeds": [1, 2, 3]}
FLUX_REQUEST = {"text": "a dog", "negative": "", "cfg": 0.0, "seed": 11,
                "texts": ["a cat", "a dog", "a red car"], "seeds": [4, 5, 6]}


def pipeline_job(sd3, flux, meshes) -> dict:
    _, sp = sd3
    _, fp = flux
    job = {}
    for mesh in meshes:
        job[f"sd3-{mesh}"] = {
            "cls": "DiffusionPipeline", "mesh": mesh, "request": SD3_REQUEST,
            "kw": {"shift": 3.0, "use_t5": False},
            "models": {k: getattr(sp, k) for k in ("clip_l", "clip_g", "mmdit", "decoder",
                                                   "tokenizer_l", "tokenizer_g")}}
        job[f"flux-{mesh}"] = {
            "cls": "FluxPipeline", "mesh": mesh, "request": FLUX_REQUEST, "kw": {},
            "tiny_t5_tokenizer": True,
            "models": {k: getattr(fp, k) for k in ("clip_l", "t5", "mmdit", "decoder",
                                                   "tokenizer_l")}}
    return job


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory, sd3_pipelines, flux_pipelines):  # noqa: F811
    job = {"forward": {**forward_job((1, 2)), **sd35_job(2)}, "rows": rows_job((1, 2)),
           "pipeline": pipeline_job(sd3_pipelines, flux_pipelines, [(1, 2), (2, 1)])}
    return run_ranks(tmp_path_factory.mktemp("tp2"), 2, job)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory, sd3_pipelines, flux_pipelines):  # noqa: F811
    job = {"forward": {**forward_job((2, 2)), **sd35_job(4)}, "rows": rows_job((1, 4)),
           "pipeline": pipeline_job(sd3_pipelines, flux_pipelines, [(2, 2)])}
    return run_ranks(tmp_path_factory.mktemp("tp4"), 4, job)


@pytest.fixture(scope="module")
def jax_pipelines(sd3_pipelines, flux_pipelines):  # noqa: F811
    """The JAX pipelines' results on the port's request, under a (2, 2)
    mesh: latents of num_images = 3 (whose first two images are
    num_images = 2's: the batch's noise is drawn in one seeded call) and
    generate_images_batched of the three prompts."""
    out = {}
    for name, (jp, _), req in (("sd3", sd3_pipelines, SD3_REQUEST),
                               ("flux", flux_pipelines, FLUX_REQUEST)):
        jp.mesh = jax_create_mesh(2, 2, devices=jax.devices()[:4])
        try:
            cond, pooled = jp.encode_text(req["text"], req["cfg"], req["negative"])
            lat, _ = jp.denoise_latents(cond, pooled, num_steps=2, cfg_weight=req["cfg"],
                                        latent_size=(8, 8), seed=req["seed"], num_images=3)
            imgs = jp.generate_images_batched(req["texts"], num_steps=2, cfg_weight=req["cfg"],
                                              latent_size=(8, 8), seeds=req["seeds"])
        finally:
            jp.mesh = None
        out[name] = {"latents": np.asarray(lat),
                     "batched": np.stack([np.asarray(im) for im in imgs])}
    return out


# -- 1. the plan against the reference's shardings, leaf for leaf ---------------


def port_name(path) -> list:
    """The port's state-dict names of one JAX leaf (a stacked leaf gives
    one a block), through convert.py's name map."""
    keys = [p.key for p in path]
    leaf = {"kernel": "weight"}.get(keys[-1], keys[-1])
    if keys[0] in ("wte", "relative_attention_bias"):
        return [f"{keys[0]}.weight"]
    return [".".join(keys[:-1] + [leaf])]


def port_dim(spec, ndim: int, leaf: str):
    """The port dim of a JAX spec on a leaf of ``ndim`` dims (stacked
    leaves carry a leading block axis; the rules place by negative axis)."""
    axes = [i for i, s in enumerate(spec) if s == "model"]
    if not axes:
        return None
    from_end = ndim - axes[0]
    if leaf in ("kernel", "w8"):  # transposed to (out, in)
        return {1: 0, 2: 1}[from_end]
    return {1: -1, 2: -2}[from_end]


def assert_plan_matches(params, shardings, plan, stacked: dict):
    checked = 0
    for path, sh in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        keys = [p.key for p in path]
        arr = params
        for k in keys:
            arr = arr[k]
        want = port_dim(sh.spec, np.ndim(arr), keys[-1])
        names = port_name(path)
        depth = stacked.get(keys[0])
        if depth is not None:
            names = [n.replace(f"{keys[0]}.", f"{keys[0]}.{i}.", 1) for n in names
                     for i in range(depth)]
        for name in names:
            got = plan.params[name]
            if want is not None and want < 0:
                want_dim = len(got.shape) + want
            else:
                want_dim = want
            assert got.rule_dim == want_dim, (name, sh.spec, got)
            checked += 1
    assert checked == len(plan.params)


def stacked_depths(config):
    flux = config.depth_unified > 0
    out = {"mm_blocks": config.depth_multimodal - (0 if flux else 1)}
    if flux:
        out["uni_blocks"] = config.depth_unified
    return out


PLAN_CASES = FORWARD_CASES


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", PLAN_CASES, ids=[f"{a}-{b}" for a, b in PLAN_CASES])
def test_plan_matches_the_references_shardings(case, n):
    params, config = mmdit_tree(*case)
    mesh = jax_create_mesh(1, n, devices=jax.devices()[:n])
    model = mmdit_from_jax(params, torch_config(config, tcfg.MMDiTConfig), device="cpu")
    plan = mmdit_plan(model, n)
    assert_plan_matches(params, mmdit_shardings(params, mesh), plan, stacked_depths(config))
    # A fan-in linear is gathered exactly where its scale rows do not divide
    # (int8 at group 64: o's 64 inputs are one group; fc2's 256 are 4).
    for path, lin in plan.linears.items():
        scales = plan.params.get(f"{path}.scales")
        split_rows = lin.layout in ("row", "gathered")
        odd = scales is not None and scales.shape[0] % n != 0
        assert (lin.layout == "gathered") == (split_rows and odd), path
    assert bool(plan.gathered()) == (case[1] == "int8")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", ["fp32", "w8a8"])
def test_t5_plan_matches_the_references_shardings(mode, n):
    params = t5_tree(mode)
    mesh = jax_create_mesh(1, n, devices=jax.devices()[:n])
    model = t5_from_jax(params, torch_config(TP_T5, tcfg.T5Config), device="cpu")
    plan = t5_plan(model, n)
    assert_plan_matches(params, t5_shardings(params, mesh), plan,
                        {"layers": TP_T5.num_layers})
    assert plan.linears["layers.0.wo"].layout == "row"
    assert plan.linears["layers.0.wi_0"].layout == "col"


def test_plan_keeps_a_non_dividing_leaf_whole():
    """A leaf whose target dim the axis does not divide stays whole, as the
    reference's rule: 4 heads' q of 64 columns over 3 ranks (the whole
    column-parallel linear), and the int8 o's single scale group over 2."""
    params, config = mmdit_tree("sd3", "int8")
    mesh = jax_create_mesh(1, 2, devices=jax.devices()[:2])
    sh = mmdit_shardings(params, mesh)
    assert sh["mm_blocks"]["img"]["o"]["scales"].spec == P()
    assert sh["mm_blocks"]["img"]["o"]["q8"].spec == P(None, "model", None)
    model = mmdit_from_jax(params, torch_config(config, tcfg.MMDiTConfig), device="cpu")
    plan = mmdit_plan(model, 2)
    o = plan.params["mm_blocks.0.img.o.q8"]
    assert o.rule_dim == 0 and o.dim is None and o.local == o.shape
    assert plan.linears["mm_blocks.0.img.o"].layout == "gathered"
    three = mmdit_plan(mmdit_from_jax(*float_and_config("sd3"), device="cpu"), 3)
    assert three.linears["mm_blocks.0.img.q"].layout == "whole"
    assert three.linears["mm_blocks.0.img.o"].layout == "whole"


def float_and_config(name):
    config = CONFIGS[name]
    return float_tree(config), torch_config(config, tcfg.MMDiTConfig)


# -- 2. full width: local shapes and routes --------------------------------------

FULL = {"sd3-medium": tcfg.SD3_MEDIUM, "sd35-large": tcfg.SD35_LARGE,
        "flux-schnell": tcfg.FLUX_SCHNELL_VERSION}
FULL_MODES = [None, 4, 8, "w4a8", "w8a8"]


def meta_mmdit(version: str, mode):
    with torch.device("meta"):
        model = MMDiT(tcfg.MMDIT_CONFIG[version], quantize_bits=4 if mode == "w4a8" else mode)
        if mode == "w4a8":
            for layer in model.modules():
                if isinstance(layer, QuantizedLinear):
                    layer.wscale = torch.empty(layer.out_features)
    return model


def sd35_roadmap_line(mode, n) -> str:
    label = {None: "bf16", 4: "int4", 8: "int8"}.get(mode, mode)
    return (f"SD3.5-large {label} over {n} ranks: "
            + ("; ".join(off_kernel(meta_mmdit(tcfg.SD35_LARGE, mode), n)) or "none"))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", FULL_MODES, ids=["bf16", "int4", "int8", "w4a8", "w8a8"])
@pytest.mark.parametrize("name", sorted(FULL))
def test_full_width_linears_keep_their_kernels(name, mode, n):
    """Every split linear's local shape, and its route at that shape:
    SD3-medium and FLUX.1-schnell keep every kernel and layout at 2 and 4
    ranks; SD3.5-large's exceptions are those ROADMAP.md lists."""
    model = meta_mmdit(FULL[name], mode)
    table = routes(model, n)
    cfg = tcfg.MMDIT_CONFIG[FULL[name]]
    h = cfg.hidden_size
    layout, local, _ = table["mm_blocks.0.img.q"]
    assert layout == "col" and local == (h, h // n)
    assert table["mm_blocks.0.img.fc2"][:2] == ("row", (4 * h // n, h))
    assert table["mm_blocks.0.img.ada"][1] == (h, 6 * h // n)
    if name == "sd35-large":
        roadmap = (REPO / "ROADMAP.md").read_text()
        assert sd35_roadmap_line(mode, n) in roadmap
    else:
        assert off_kernel(model, n) == []
        if mode == "w4a8" and name == "flux-schnell":
            assert table["uni_blocks.0.fc1"][2] == "E"
            assert table["uni_blocks.0.o"][2] == "#10 + #16 int32"


# -- 3 and 5. the sharded forwards, and their collectives -----------------------


_W4A8_WANT = {}


def jax_w4a8_forward(request, params, config, inputs) -> np.ndarray:
    """The JAX package's w4a8 forward under its TPU dispatch on the CPU
    (tests/test_torch_w4a8.py's ``jax_tpu_dispatch``: E's modes and the
    fused quantizers in interpret mode), unsharded: the reference's TP
    result is the same function of the same tree. Computed once."""
    if "want" not in _W4A8_WANT:
        dispatch = request.getfixturevalue("jax_tpu_dispatch")
        _W4A8_WANT["want"] = np.asarray(apply_mmdit(params, config, *map(jnp.asarray, inputs)))
        assert "grouped_xs" in dispatch and "norm_rope" in dispatch
    return _W4A8_WANT["want"]


def assert_forward(outs, name, mode, data, model, request):
    params, config = mmdit_tree(name, mode)
    inputs = mmdit_inputs(config, b=1 if mode == "w4a8" else 2)
    if mode == "w4a8":
        # Against JAX under its TPU dispatch, at
        # test_flux_w4a8_blocks_and_model_match_jax's tolerance (XLA's FMA
        # contractions in the epilogues move an int8 activation one step:
        # ``assert_close_up_to_flips``); and, closer, against the port's
        # unsharded w4a8 model: E's modes and the int32 reductions are
        # exact, the fp32 sums of fc2's partials move the last bits.
        want = jax_w4a8_forward(request, params, config, inputs)
        assert np.abs(want).max() > 0.5
        port = mmdit_from_jax(params, torch_config(config, tcfg.MMDiTConfig), device="cpu")
        with torch.no_grad():
            whole = port(*map(torch.from_numpy, inputs)).numpy()
        for out in outs:
            got = out[f"{name}-{mode}"]["out"].numpy()
            assert_close_up_to_flips(got, want, q90=3e-3)
            np.testing.assert_allclose(got, whole, atol=1e-5, rtol=1e-5)
        return
    want = jax_sharded(params, config, inputs, data, model)
    assert np.abs(want).max() > 0.5
    rows = np.array_split(np.arange(want.shape[0]), data)
    for rank, out in enumerate(outs):
        got = out[f"{name}-{mode}"]["out"].numpy()
        want_r = want[rows[rank // model]]
        if mode == "w8a8":
            assert_close_up_to_flips(got, want_r, q90=3e-3)
        else:
            np.testing.assert_allclose(got, want_r, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("case", FORWARD_CASES, ids=[f"{a}-{b}" for a, b in FORWARD_CASES])
def test_mmdit_forward_on_two_ranks_matches_jax(ranks2, case, request):
    assert_forward(ranks2, *case, data=1, model=2, request=request)


@pytest.mark.parametrize("case", FORWARD_CASES, ids=[f"{a}-{b}" for a, b in FORWARD_CASES])
def test_mmdit_forward_on_a_2x2_mesh_matches_jax(ranks4, case, request):
    assert_forward(ranks4, *case, data=2, model=2, request=request)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", SD35_TP_MODES)
def test_sd35_ratios_take_sd35_larges_routes(mode, n):
    """SD35_RATIOS over n ranks leaves the same kernels and layouts as
    SD3.5-large at full width (``off_kernel``)."""
    bits = "w4a8" if mode == "w4a8" else 4
    tiny = mmdit_from_jax(sd35_tree(mode), torch_config(SD35_RATIOS, tcfg.MMDiTConfig),
                          device="cpu")
    assert off_kernel(tiny, n) == off_kernel(meta_mmdit(tcfg.SD35_LARGE, bits), n) != []


_SD35_WANT = {}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", SD35_TP_MODES)
def test_sd35_forward_split_matches_jax(ranks2, ranks4, mode, n, request):
    """The SD3.5-ratio model split over (1, n), on the routes SD3.5-large's
    split linears take (q/k/v and o off their kernels, heads gathered over
    4, the w4a8 FFN unfused), against the JAX package's forward of the same
    tree: int4 as the float cases (atol 2e-4, rtol 1e-4), w4a8 under the
    reference's TPU dispatch up to int8 flips (``q90=3e-3``), and so against
    the port's unsharded w4a8 forward. The split w4a8 linears off E's
    shapes keep E's arithmetic and the split FFN the fused pair's, its fp32
    sum over the scale tiles in the unsharded order (``ops/common``): with
    the split float linears (the t / y embedders, the final layer's ada)
    put back whole, the split forward is the whole one bit for bit; with
    them split, their fp32 sums in another order flip an int8 step here and
    there (0.15 % relative L2 from the whole forward over 2 and 4 ranks)."""
    params = sd35_tree(mode)
    inputs = mmdit_inputs(SD35_RATIOS)
    outs = ranks2 if n == 2 else ranks4
    if mode == "int4":
        want = jax_sharded(params, SD35_RATIOS, inputs, 1, n)
    else:
        if "w4a8" not in _SD35_WANT:
            dispatch = request.getfixturevalue("jax_tpu_dispatch")
            _SD35_WANT["w4a8"] = np.asarray(apply_mmdit(params, SD35_RATIOS,
                                                        *map(jnp.asarray, inputs)))
            assert dispatch.count("plain") > 0
        want = _SD35_WANT["w4a8"]
        port = mmdit_from_jax(params, torch_config(SD35_RATIOS, tcfg.MMDiTConfig), device="cpu")
        with torch.no_grad():
            whole = port(*map(torch.from_numpy, inputs)).numpy()
    assert np.abs(want).max() > 0.5
    for out in outs:
        got = out[f"sd35-{mode}"]["out"].numpy()
        if mode == "int4":
            np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
        else:
            assert_close_up_to_flips(got, want, q90=3e-3)
            assert_close_up_to_flips(got, whole, q90=3e-3)
            exact = out["sd35-w4a8-floats-whole"]
            assert torch.equal(exact["out"], exact["whole"])


@pytest.mark.parametrize("n", [2, 4])
def test_sd35_tiles_route_all_reduces_only_the_straddled_tiles(ranks2, ranks4, n):
    """The split w4a8 FFN ("tiles") max all-reduces one value a row for each
    scale tile a rank boundary cuts, and nothing for the tiles a rank holds
    whole: SD35_RATIOS' fc1 of 1536 (3 tiles) over 2 ranks cuts tile 1, so
    (M, 1) a call, not (M, 3); over 4 it cuts all three. A forward's max
    all-reduces are those of the FFNs (the image stream's in every block,
    the text stream's but in the last) and, over 2 ranks, the two-pass D's
    of o's input (one value a row of the same rows; over 4, o is gathered)."""
    outs = ranks2 if n == 2 else ranks4
    cfg = SD35_RATIOS
    shared = len(tfq.straddled_tiles(cfg.mlp_ratio * cfg.hidden_size, n))
    assert shared == (1 if n == 2 else 3)
    (b, h, w, _), txt = mmdit_inputs(cfg)[0].shape, mmdit_inputs(cfg)[1]
    rows = {"img": b * (h // cfg.patch_size) * (w // cfg.patch_size),
            "txt": txt.shape[0] * txt.shape[1]}
    depth = cfg.depth_multimodal
    want = collections.Counter()
    for stream, calls in (("img", depth), ("txt", depth - 1)):
        want[rows[stream] * shared] += calls  # the FFN's straddled tiles
        if n == 2:
            want[rows[stream]] += calls  # o's input by the two-pass D
    for out in outs:
        for case in ("sd35-w4a8", "sd35-w4a8-floats-whole"):
            assert out[case]["sizes"]["all_reduce_max"] == dict(want), case


def test_mmdit_ring_with_the_model_sharded_matches_jax(ranks2):
    """tests/test_torch_ring.py's two-rank MMDiT case (sdpa_impl="ring") with
    the model sharded too: each rank's heads gathered whole for the ring
    (the sequence split over ``model``) and its own kept after it, against
    the JAX ring on a (1, 2) mesh, at tests/test_parallel.py's ring
    tolerance."""
    jcfg, params = tiny_flux_params()
    mesh = jax_create_mesh(1, 2, devices=jax.devices()[:2])
    want = np.asarray(apply_mmdit(params, jcfg, *map(jnp.asarray, flux_inputs()),
                                  sdpa_impl="ring", mesh=mesh))
    assert np.abs(want).max() > 0.5
    for out in ranks2:
        np.testing.assert_allclose(out["flux-ring"]["out"].numpy(), want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["fp32", "w8a8"])
def test_t5_on_two_and_four_ranks_matches_jax(ranks2, ranks4, mode):
    """tests/test_parallel.py's T5 (4 heads, d_ff 64) against JAX's sharded
    forward; fp32 at its tolerance, w8a8 up to int8 flips."""
    params = t5_tree(mode)
    for outs, (data, model) in ((ranks2, (1, 2)), (ranks4, (2, 2))):
        mesh = jax_create_mesh(data, model, devices=jax.devices()[: data * model])
        sharded = shard_params(params, t5_shardings(params, mesh))
        want = np.asarray(jax.jit(lambda p, t: apply_t5_encoder(p, t, TP_T5))(
            sharded, jnp.asarray(T5_TOKENS)))
        for out in outs:
            got = out[f"t5-{mode}"]["out"].numpy()
            if mode == "w8a8":
                assert_close_up_to_flips(got, want, q90=3e-3)
            else:
                np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_collective_pattern_is_megatrons(ranks2):
    """The counterpart of tests/test_parallel.py's compiled-HLO check, on
    the float FLUX forward of a (1, 2) mesh (one dual block, two single
    blocks, batch 2, 8 text + 16 image tokens): every fan-in linear sums
    its partial products once, so a dual block all-reduces 4 activations
    (image and text o and fc2) and a single block 2 (o and fc2): 8; the
    embedders' fc2 (t and y) add 2 of one row a sample, below B * 6H. The
    all-gathers are the modulation vectors (the blocks' ada and the final
    layer's), each at most B * 6H; nothing weight-sized is sent."""
    b, h = 2, TP_FLUX.hidden_size
    limit = b * 6 * h
    for out in ranks2:
        sizes = out["flux-float"]["sizes"]  # calls by element count, per kind
        big = sum(c for s, c in sizes["all_reduce_sum"].items() if s > limit)
        assert big == 4 * TP_FLUX.depth_multimodal + 2 * TP_FLUX.depth_unified
        assert sum(sizes["all_reduce_sum"].values()) == big + 2
        assert sum(sizes["all_gather"].values()) == (2 * TP_FLUX.depth_multimodal
                                                     + TP_FLUX.depth_unified + 1)
        assert all(s <= limit for s in sizes["all_gather"])
        assert sizes["all_reduce_max"] == {}  # float: no row is quantized
        assert all(s < 4 * h * h for k in sizes for s in sizes[k])
        quant = out["flux-w8a8"]["sizes"]
        # w8a8: o and fc2 sum in int32, their inputs' absmax all-reduced by
        # the two-pass D (o) and #4 (fc2), one value a row.
        assert sum(quant["all_reduce_max"].values()) == big + 2


def test_ranks_import_no_jax(ranks2, ranks4):
    assert all(out["jax_modules"] == [] for out in ranks2 + ranks4)


# -- 4. bit-exactness -------------------------------------------------------------


@pytest.mark.parametrize("kind", ["w8a8", "w4a8"])
def test_row_parallel_int8_product_is_the_unsharded_one_bit_for_bit(ranks2, ranks4, kind):
    """A fan-in w8a8 (or w4a8) linear over 2 and 4 ranks: the two-pass D's
    row scales are the whole rows', the int32 partial products sum exactly,
    and #11's epilogue runs once, so every rank's output is the unsharded
    ``w8a8_linear`` (``w4a8_linear``) bit for bit."""
    case = rows_case(kind)
    with torch.no_grad():
        want = (w8a8_linear if kind == "w8a8" else w4a8_linear)(case["holder"].o, case["x"])
    for out in ranks2 + ranks4:
        assert torch.equal(out[kind]["linear"], want)


def test_row_parallel_float_linear_rounds_once(ranks2, ranks4):
    """A bf16 fan-in linear over 2 and 4 ranks: each rank's partial product
    in fp32 (no bf16 rounding of a partial sum), summed in fp32, the bias
    added, one rounding to bf16. Against the fp32 product of the whole rows
    rounded once: the fp32 sums in another order can move a value across a
    bf16 rounding boundary, so at most one bf16 step (2^-7 relative) and
    under 1 % of the outputs (bf16-rounded partials move about a third of
    them)."""
    case = rows_case("bf16")
    lin, x = case["holder"].o, case["x"]
    want = F.linear(x.float(), lin.weight.float(), lin.bias.float())
    rounded = want.to(torch.bfloat16)
    for out in ranks2 + ranks4:
        got = out["bf16"]["linear"]
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        moved = got != rounded
        assert int(moved.sum()) < 0.01 * got.numel()
        step = want.abs() * 2.0**-7
        assert bool(((got.float() - want).abs() <= step + 1e-30).all())


def jax_row_parallel_linear(case: dict, n: int) -> np.ndarray:
    """The JAX package's ``quantized_linear`` on the same packed weight
    under GSPMD on a (1, ``n``) mesh of the conftest's CPU devices: the
    weight's rows (and x's features) split over ``model``, as the
    reference's plan splits a fan-in linear; on the CPU it dequantises in
    x's dtype and takes one dot with fp32 output, so the ranks' fp32
    partial products are all-reduced and rounded once after the bias."""
    from jax.sharding import NamedSharding

    from diffusionkit_tpu.ops.quantized import quantized_linear

    lin = case["holder"].o
    leaf = "q4" if lin.bits == 4 else "q8"
    w = getattr(lin, leaf).numpy()
    params = {leaf: w.view(np.uint32) if leaf == "q4" else w, "scales": lin.scales.numpy(),
              "zeros": lin.zeros.numpy(),
              "bias": jnp.asarray(lin.bias.float().numpy(), jnp.bfloat16)}
    mesh = jax_create_mesh(1, n, devices=jax.devices()[:n])
    rows = NamedSharding(mesh, P("model", None))
    sharded = {k: jax.device_put(jnp.asarray(v), rows if k != "bias" else
                                 NamedSharding(mesh, P(None))) for k, v in params.items()}
    x = jax.device_put(jnp.asarray(case["x"].float().numpy(), jnp.bfloat16),
                       NamedSharding(mesh, P(None, "model")))
    y = jax.jit(lambda p, a: quantized_linear(p, a))(sharded, x)
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("kind", ["int4", "int8"])
def test_row_parallel_quantized_linear_rounds_once(ranks2, ranks4, kind):
    """An int4 / int8 weight-only fan-in linear on bf16 x over 2 and 4
    ranks: each rank's partial product from C / #13 in fp32 (their plain
    versions here, ``out_dtype=torch.float32``), summed in fp32, the bias
    added, one rounding to bf16. Held as
    test_row_parallel_float_linear_rounds_once holds the bf16 linear:
    against the fp32 product of the whole rows on the same dequantised
    weight (rounded to bf16, as the kernels round it) and against the JAX
    package's GSPMD ``quantized_linear`` over the same ranks, at most one
    bf16 step (plus the fp32 sums' error, 2K 2^-24 (|x| @ |w|), where the
    output cancels) apart and on under 1 % of the outputs (the fp32 sums
    in other orders cross a rounding boundary now and then; bf16-rounded
    partials move about a third of them)."""
    case = rows_case(kind)
    lin, x = case["holder"].o, case["x"]
    deq = dequantize_int4 if lin.bits == 4 else dequantize_int8
    w = deq(lin.q4 if lin.bits == 4 else lin.q8, lin.scales, lin.zeros, torch.bfloat16).float()
    want = x.float() @ w + lin.bias.float()
    assert float(want.abs().max()) > 0.5
    # The fp32 sums' own error in any order, 2K 2^-24 (|x| @ |w|): it
    # dominates where the output cancels to near zero.
    slack = 2 * ROWS_K * 2.0**-24 * (x.float().abs() @ w.abs())
    for outs, n in ((ranks2, 2), (ranks4, 4)):
        jax_y = torch.from_numpy(jax_row_parallel_linear(case, n))
        for out in outs:
            got = out[kind]["linear"]
            assert got.dtype == torch.bfloat16 and got.shape == want.shape
            step = want.abs() * 2.0**-7 + slack
            for ref in (want.to(torch.bfloat16).float(), jax_y):
                moved = got.float() != ref
                assert int(moved.sum()) < 0.01 * got.numel(), int(moved.sum())
                assert bool(((got.float() - ref).abs() <= step).all())


@pytest.mark.parametrize("form", [None, "erf", "tanh"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_two_pass_plain_versions_are_the_one_pass_on_whole_rows(form, n):
    """The two passes' plain versions, each rank's columns quantized on the
    max of the ranks' absmaxes, concatenated: the one-pass plain version
    (D's, or #4's in ``form``) on whole rows, bit for bit; rows with an
    outlier, a zero row and a row of one sign."""
    gen = torch.Generator().manual_seed(5)
    y = torch.randn(9, 512, generator=gen) * torch.logspace(-3, 2, 9)[:, None]
    y[2, 400] = 1e4
    y[4] = 0.0
    y[6] = y[6].abs()
    for dtype in (torch.float32, torch.bfloat16):
        yd = y.to(dtype)
        parts = yd.chunk(n, dim=-1)
        amax = torch.stack([tfq.row_absmax(p, form) for p in parts]).amax(dim=0)
        aqs = [tfq.quantize_amax(p, amax, form) for p in parts]
        want = tfq.quantize_plain(yd) if form is None else tfq.gelu_quantize_plain(yd, form)
        assert torch.equal(torch.cat([a.x8 for a in aqs], dim=-1), want.x8)
        for a in aqs:
            assert torch.equal(a.xscale, want.xscale) and a.out_dtype == dtype


@pytest.mark.parametrize("n", [1, 2, 4])
def test_tile_passes_are_e_gelu_quant_over_split_hidden(n):
    """The tiles route's two passes (``tile_absmax``, ``tile_quantize``,
    plain versions here) on each rank's columns of fc1's fp32 output (E's
    mode plain), the absmaxes max-reduced over the ranks: E's gelu_quant
    bytes side by side and its tile scales where each rank holds columns,
    bit for bit. A hidden of 5 scale tiles, so over 2 and 4 ranks tiles
    straddle ranks; a row of zeros and one with an outlier."""
    from diffusionkit_tpu_torch.ops import w4a8_matmul as tw

    gen = torch.Generator().manual_seed(7)
    m, k, hidden, group = 6, 256, 5 * tw.SCALE_TILE, 64
    x8 = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    x8[3] = 0
    q4 = torch.randint(-2**31, 2**31, (k // 8, hidden), generator=gen, dtype=torch.int64).int()
    scales = torch.rand(k // group, hidden, generator=gen) * 0.02 + 1e-3
    zeros = -8.0 * scales
    wscale = scales.amax(dim=0) * 8.0 / 127.0
    xscale = torch.rand(m, 1, generator=gen) * 0.05
    xscale[1] = 3.0
    bias = torch.randn(hidden, generator=gen) * 0.1
    args = (x8, q4, scales, zeros, wscale, xscale, bias)
    want8, want_s = tw.w4a8_matmul_plain(*args, mode="gelu_quant")
    g = tw.w4a8_matmul_plain(*args, out_dtype=torch.float32)
    n1, tiles = hidden // n, hidden // tw.SCALE_TILE
    parts = [g[:, r * n1:(r + 1) * n1].contiguous() for r in range(n)]
    amax = torch.stack([tfq.tile_absmax(p, r * n1, tiles) for r, p in enumerate(parts)]).amax(0)
    got = [tfq.tile_quantize(p, amax, r * n1) for r, p in enumerate(parts)]
    assert torch.equal(torch.cat([y8 for y8, _ in got], dim=-1), want8)
    for r, (_, ys) in enumerate(got):
        held = slice(r * n1 // tw.SCALE_TILE, ((r + 1) * n1 - 1) // tw.SCALE_TILE + 1)
        assert torch.equal(ys[:, held], want_s[:, held])
        assert not ys[:, :held.start].any() and not ys[:, held.stop:].any()


@pytest.mark.parametrize("hidden, n, want", [(9728, 1, []), (9728, 2, [9]),
                                             (9728, 4, [4, 9, 14]), (1024, 4, [0, 1]),
                                             (1536, 2, [1]), (1536, 4, [0, 1, 2])])
def test_straddled_tiles(hidden, n, want):
    """The scale tiles a rank boundary cuts: SD3.5-large's hidden over 1, 2
    and 4 ranks, two tiles over 4 (256 columns a rank: each rank holds part
    of one tile, and the boundary at 512 cuts none), and SD35_RATIOS' fc1."""
    assert tfq.straddled_tiles(hidden, n) == want


def _e_gelu_quant_case(m: int, hidden: int, seed: int):
    """fc1's fp32 output (E's mode plain) of a random w4a8 layer of width
    ``hidden`` at K = 256, group 64, and E's gelu_quant of it: ``(g, y8,
    yscale)``; a row of zeros and a row with a large scale."""
    from diffusionkit_tpu_torch.ops import w4a8_matmul as tw

    gen = torch.Generator().manual_seed(seed)
    k, group = 256, 64
    x8 = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    x8[3] = 0
    q4 = torch.randint(-2**31, 2**31, (k // 8, hidden), generator=gen, dtype=torch.int64).int()
    scales = torch.rand(k // group, hidden, generator=gen) * 0.02 + 1e-3
    wscale = scales.amax(dim=0) * 8.0 / 127.0
    xscale = torch.rand(m, 1, generator=gen) * 0.05
    xscale[1] = 3.0
    args = (x8, q4, scales, -8.0 * scales, wscale, xscale, torch.randn(hidden, generator=gen) * 0.1)
    want8, want_s = tw.w4a8_matmul_plain(*args, mode="gelu_quant")
    return tw.w4a8_matmul_plain(*args, out_dtype=torch.float32), want8, want_s


@pytest.mark.parametrize("hidden, n", [(5 * 512, 2), (5 * 512, 4), (2 * 512, 4), (19 * 512, 2),
                                       (19 * 512, 4)])
def test_tile_absmax_reads_only_the_tiles_a_rank_holds_in_part(hidden, n):
    """Pass 1's plain version on each rank's columns: 0 in every tile the
    rank holds whole and in those it holds no column of, the max |GELU|
    of its columns in the tiles it holds in part (each a straddled tile);
    a rank of 256 columns holds part of one tile."""
    g, _, _ = _e_gelu_quant_case(6, hidden, seed=8)
    n1, tiles = hidden // n, hidden // 512
    v = tfq.gelu_as(g).abs()
    for r in range(n):
        amax = tfq.tile_absmax(g[:, r * n1:(r + 1) * n1].contiguous(), r * n1, tiles)
        for t in range(tiles):
            lo, hi = max(t * 512, r * n1), min((t + 1) * 512, (r + 1) * n1)
            if lo < hi and hi - lo < 512:
                assert t in tfq.straddled_tiles(hidden, n), (r, t)
                assert torch.equal(amax[:, t], v[:, lo:hi].amax(dim=1)), (r, t)
            else:
                assert not amax[:, t].any(), (r, t)


@pytest.mark.parametrize("hidden, n", [(5 * 512, 2), (5 * 512, 4), (2 * 512, 4)])
def test_straddled_exchange_of_the_passes_is_e_gelu_quant(hidden, n):
    """The tiles route's exchange written out in one process: the plain
    passes on each rank's columns with only the straddled tiles' columns
    max-reduced (each rank keeps its own 0 in the others) give E's
    gelu_quant bytes side by side, its scales where each rank holds
    columns, 0 elsewhere, bit for bit; over 4 ranks of a 2-tile hidden each
    rank holds only part of one tile. The route itself
    (``ops/common._w4a8_ffn_tiles``) runs in the gloo ranks: its all-reduce
    sizes in ``test_sd35_tiles_route_all_reduces_only_the_straddled_tiles``,
    its output in ``test_sd35_forward_split_matches_jax``."""
    g, want8, want_s = _e_gelu_quant_case(6, hidden, seed=9)
    n1, tiles = hidden // n, hidden // 512
    shared = tfq.straddled_tiles(hidden, n)
    amaxes = [tfq.tile_absmax(g[:, r * n1:(r + 1) * n1].contiguous(), r * n1, tiles)
              for r in range(n)]
    reduced = torch.stack([a[:, shared] for a in amaxes]).amax(0)
    for r, amax in enumerate(amaxes):
        amax[:, shared] = reduced
        y8, ys = tfq.tile_quantize(g[:, r * n1:(r + 1) * n1].contiguous(), amax, r * n1)
        assert torch.equal(y8, want8[:, r * n1:(r + 1) * n1]), r
        held = slice(r * n1 // 512, ((r + 1) * n1 - 1) // 512 + 1)
        assert torch.equal(ys[:, held], want_s[:, held]), r
        assert not ys[:, :held.start].any() and not ys[:, held.stop:].any()


def test_two_pass_over_ranks_is_the_one_pass(ranks2, ranks4):
    """``quantize_two_pass`` over real groups of 2 and 4 gloo ranks: the
    ranks' bytes concatenated are D's (and #4's) on the whole rows."""
    x = rows_case("w8a8")["x"]
    for outs in (ranks2, ranks4):
        for key, want in (("quantize", tfq.quantize_plain(x)),
                          ("gelu_quantize", tfq.gelu_quantize_plain(x, "erf"))):
            got = torch.cat([out["w8a8"][key].x8 for out in outs], dim=-1)
            assert torch.equal(got, want.x8)
            assert all(torch.equal(out["w8a8"][key].xscale, want.xscale) for out in outs)


# -- 6. the pipelines ----------------------------------------------------------------


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (2, 2)], ids=["1x2", "2x1", "2x2"])
@pytest.mark.parametrize("name", ["sd3", "flux"])
def test_pipeline_on_a_mesh_matches_jax(ranks2, ranks4, jax_pipelines, name, mesh):
    """The tiny SD3 (CFG 5) and FLUX pipelines of tests/test_torch_pipeline.py
    and tests/test_torch_flux.py on a mesh: ``denoise_latents`` for 2 and 3
    images (3 over 2 data ranks: chunks of 2 and 1) and
    ``generate_images_batched`` of 3 prompts, against the JAX pipeline on a
    (2, 2) mesh; every rank returns every image."""
    outs = ranks4 if mesh == (2, 2) else ranks2
    want = jax_pipelines[name]
    assert np.abs(want["latents"]).max() > 1.0
    for out in outs:
        res = out[f"{name}-{mesh}"]
        for n_img in (2, 3):
            got = res[f"latents{n_img}"].numpy()
            assert got.shape[0] == n_img
            np.testing.assert_allclose(got, want["latents"][:n_img], atol=1e-3, rtol=1e-3)
        got = res["batched"].astype(int)
        assert got.shape == want["batched"].shape == (3, 64, 64, 3) and got.std() > 5
        assert np.abs(got - want["batched"].astype(int)).max() <= 1
    first = outs[0][f"{name}-{mesh}"]
    for out in outs[1:]:
        assert torch.equal(out[f"{name}-{mesh}"]["latents3"], first["latents3"])
        assert np.array_equal(out[f"{name}-{mesh}"]["batched"], first["batched"])


# -- 7. one rank -------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_rank():
    return local_mesh("cpu")


@pytest.mark.parametrize("mode", ["float", "w8a8", "w4a8"])
def test_one_rank_mesh_is_the_unsharded_model(one_rank, mode):
    """On a one-rank mesh the plan splits nothing and marks no linear, and
    the forward issues no collective: the no-mesh output bit for bit."""
    name = "flux"
    params, config = mmdit_tree(name, mode)
    model = mmdit_from_jax(params, torch_config(config, tcfg.MMDiTConfig), device="cpu")
    inputs = list(map(torch.from_numpy, mmdit_inputs(config, b=1)))
    with torch.no_grad():
        want = model(*inputs)
        sharded = shard_module_(copy.deepcopy(model), one_rank)
        assert not any(hasattr(m, "tp") for m in sharded.modules())
        collectives.stats.reset()
        got = sharded(*inputs, mesh=one_rank)
    assert torch.equal(got, want)
    assert all(v["calls"] == 0 for v in collectives.stats.snapshot().values())


def test_one_rank_pipeline_is_the_pipeline_without_a_mesh(flux_pipelines, one_rank):  # noqa: F811
    _, tp = flux_pipelines
    meshed = FluxPipeline(load=False, low_memory_mode=False, a16=False, device="cpu",
                          mesh=one_rank)
    for name in ("clip_l", "t5", "mmdit", "decoder", "tokenizer_l", "t5_tokenizer"):
        setattr(meshed, name, getattr(tp, name))
    kw = dict(num_steps=2, cfg_weight=0.0, latent_size=(8, 8), seed=11, num_images=3)
    cond, pooled = tp.encode_text("a dog", cfg_weight=0.0)
    want, _ = tp.denoise_latents(cond, pooled, **kw)
    collectives.stats.reset()
    got, _ = meshed.denoise_latents(cond, pooled, **kw)
    assert torch.equal(got, want)
    assert all(v["calls"] == 0 for v in collectives.stats.snapshot().values())


def test_data_rows_are_contiguous_ragged_chunks(monkeypatch):
    """Each data rank's images: contiguous, the first n mod d ranks one
    more, a rank past n none (a (3, 1) mesh read through the mesh
    helpers)."""
    import diffusionkit_tpu_torch.pipeline as pl

    pipe = DiffusionPipeline(load=False, low_memory_mode=False, use_t5=False, device="cpu")
    monkeypatch.setattr(pl, "axis_size", lambda mesh, name: 3 if name == "data" else 1)
    chunks = []
    for r in range(3):
        monkeypatch.setattr(pl, "axis_index", lambda mesh, name, r=r: r if name == "data" else 0)
        chunks.append([pipe._data_rows(n) for n in (1, 3, 5, 6)])
    assert [c[0] for c in chunks] == [(0, 1), (1, 1), (1, 1)]
    assert [c[1] for c in chunks] == [(0, 1), (1, 2), (2, 3)]
    assert [c[2] for c in chunks] == [(0, 2), (2, 4), (4, 5)]
    assert [c[3] for c in chunks] == [(0, 2), (2, 4), (4, 6)]


def test_parallel_modules_and_example_import_no_jax():
    """The plan, the collectives and the example's ``--help`` load no jax
    and nothing of the JAX package."""
    code = (
        "import runpy, sys\n"
        "from diffusionkit_tpu_torch.parallel import collectives, mesh, sharding\n"
        "sys.argv = ['prog', '--help']\n"
        "try:\n"
        "    runpy.run_path('examples/multichip_tp_torch.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    code = e.code\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'diffusionkit_tpu.')))\n"
        "assert not bad, bad\n"
        "sys.exit(code)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "--tp" in proc.stdout
