"""The port's meshes and ring attention against the JAX package on the CPU.

The ring runs in gloo ranks: ``python -c`` subprocesses of ``RANK_CODE``
that import the port and never jax (each checks), meet at a ``file://``
rendezvous in a temporary directory, and save their outputs. The JAX ring
runs on the virtual 8-device CPU mesh of ``tests/conftest.py``. One spawn of
two ranks and one of four serve every multi-rank case; in-process tests use
``local_mesh("cpu")``, a one-rank gloo group.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionkit_tpu.models import apply_mmdit, init_mmdit_params
from diffusionkit_tpu.parallel import create_mesh as jax_create_mesh
from diffusionkit_tpu.parallel.ring_attention import ring_attention as jax_ring_attention
from diffusionkit_tpu_torch import config as tcfg
from diffusionkit_tpu_torch.convert import mmdit_from_jax
from diffusionkit_tpu_torch.ops.attention import sdpa, xla_sdpa
from diffusionkit_tpu_torch.ops.flash_attention import flash_attention_plain, flash_attention_stats
from diffusionkit_tpu_torch.parallel import create_mesh, local_mesh, merge_chunk_stats
from diffusionkit_tpu_torch.parallel.ring_attention import ring_attention
from diffusionkit_tpu_torch.pipeline import DiffusionPipeline, FluxPipeline

from test_torch_flux import flux_pipelines  # noqa: F401 (a fixture)
from test_torch_flux import flux_inputs, tiny_flux, with_unit_qk_scales
from test_torch_models import randomize, torch_config
from test_torch_pipeline import NEGATIVE, PROMPT, SEED
from test_torch_pipeline import pipelines as sd3_pipelines  # noqa: F401 (a fixture)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

# One rank: join the group, run every case of the job on its mesh, save the
# outputs and whether any jax module was imported.
RANK_CODE = """
import sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from diffusionkit_tpu_torch.parallel import create_mesh, init_distributed, ring_attention
job_path, rank, world, init = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
init_distributed(init, world, rank, device="cpu")
job = torch.load(job_path, weights_only=False)
out = {}
for name, case in job["ring"].items():
    mesh = create_mesh(*case["mesh"], device="cpu")
    out[name] = ring_attention(case["q"], case["k"], case["v"], case["scale"], mesh)
if "mmdit" in job:
    spec = job["mmdit"]
    mesh = create_mesh(*spec["mesh"], device="cpu")
    with torch.no_grad():
        out["mmdit"] = spec["model"](*spec["inputs"], sdpa_impl="ring", mesh=mesh)
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
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [torch.load(f"{job_path}.rank{r}", weights_only=False) for r in range(world)]


def qkv(seed: int, shape):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(3)]


def jax_ring(arrays, data: int, model: int) -> np.ndarray:
    q, k, v = map(jnp.asarray, arrays)
    mesh = jax_create_mesh(data, model, devices=jax.devices()[: data * model])
    return np.asarray(jax_ring_attention(q, k, v, q.shape[-1] ** -0.5, mesh))


# (seed, (B, H, S, D), (data, model)) of each ring case.
RING2 = {"divisible": (10, (2, 3, 256, 32), (1, 2)), "padded": (11, (1, 2, 251, 64), (1, 2))}
RING4 = {"divisible": (12, (2, 3, 256, 32), (1, 4)), "padded": (13, (1, 2, 250, 32), (1, 4)),
         "data_axis": (14, (2, 2, 250, 64), (2, 2))}


def ring_job(cases: dict) -> dict:
    job = {}
    for name, (seed, shape, mesh) in cases.items():
        q, k, v = map(torch.from_numpy, qkv(seed, shape))
        job[name] = {"q": q, "k": k, "v": v, "scale": shape[-1] ** -0.5, "mesh": mesh}
    return job


def tiny_flux_params():
    jcfg = tiny_flux()
    params = with_unit_qk_scales(randomize(init_mmdit_params(jax.random.PRNGKey(0), jcfg), seed=4))
    return jcfg, params


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    jcfg, params = tiny_flux_params()
    model = mmdit_from_jax(params, torch_config(jcfg, tcfg.MMDiTConfig), device="cpu")
    job = {"ring": ring_job(RING2),
           "mmdit": {"model": model, "mesh": (1, 2),
                     "inputs": list(map(torch.from_numpy, flux_inputs()))}}
    return run_ranks(tmp_path_factory.mktemp("ring2"), 2, job)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("ring4"), 4, {"ring": ring_job(RING4)})


def assert_ranks_agree_with_jax(outs, name, cases):
    seed, shape, (data, model) = cases[name]
    want = jax_ring(qkv(seed, shape), data, model)
    for out in outs:  # every rank holds the whole output
        got = out[name].numpy()
        assert got.shape == shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(RING2))
def test_ring_on_two_gloo_ranks_matches_jax(ranks2, name):
    assert_ranks_agree_with_jax(ranks2, name, RING2)


@pytest.mark.parametrize("name", sorted(RING4))
def test_ring_on_four_gloo_ranks_matches_jax(ranks4, name):
    assert_ranks_agree_with_jax(ranks4, name, RING4)


def test_ring_ranks_import_no_jax(ranks2, ranks4):
    assert all(out["jax_modules"] == [] for out in ranks2 + ranks4)


def test_mmdit_ring_on_two_gloo_ranks_matches_jax(ranks2):
    """A tiny FLUX MMDiT (2 dual + 2 single blocks, hidden 128; 20 image +
    9 text tokens, padded to 30 over the ring) with sdpa_impl="ring" against
    the JAX apply_mmdit with sdpa_impl="ring" on a 1x2 mesh."""
    jcfg, params = tiny_flux_params()
    mesh = jax_create_mesh(1, 2, devices=jax.devices()[:2])
    want = np.asarray(apply_mmdit(params, jcfg, *map(jnp.asarray, flux_inputs()),
                                  sdpa_impl="ring", mesh=mesh))
    assert np.abs(want).max() > 0.5
    for out in ranks2:
        # The fp32 model-level baseline of tests/test_parallel.py's ring test.
        np.testing.assert_allclose(out["mmdit"].numpy(), want, atol=2e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def one_rank():
    return local_mesh("cpu")


def test_local_mesh_is_one_rank_with_the_references_axes(one_rank):
    assert one_rank.mesh_dim_names == ("data", "model") and tuple(one_rank.shape) == (1, 1)
    assert torch.distributed.get_backend() == "gloo"
    assert local_mesh("cpu").shape == one_rank.shape  # the group is reused
    with pytest.raises(ValueError, match="2x1"):
        create_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        create_mesh(1, 1, device="cuda")


def test_sdpa_ring_needs_a_mesh(one_rank):
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="mesh"):
        sdpa(q, q, q, 0.125, impl="ring")
    # Both layouts on the one-rank ring give full attention.
    q, k, v = map(torch.from_numpy, qkv(15, (2, 3, 40, 64)))
    want = xla_sdpa(q, k, v, 0.125)
    torch.testing.assert_close(sdpa(q, k, v, 0.125, impl="ring", mesh=one_rank), want,
                               atol=1e-5, rtol=1e-5)
    got = sdpa(*(t.transpose(1, 2) for t in (q, k, v)), 0.125, impl="ring", mesh=one_rank,
               layout="bshd")
    torch.testing.assert_close(got.transpose(1, 2), want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(ring_attention(q, k, v, 0.125, one_rank, use_flash=False), want,
                               atol=1e-5, rtol=1e-5)


def test_sdpa_flash_under_a_mesh_is_the_call_without_one(one_rank):
    """A mesh shards no heads: impl="flash" and auto run as they do without
    one, also at a head dim the reference's mesh path sends to XLA."""
    q, k, v = map(torch.from_numpy, qkv(16, (1, 3, 40, 32)))
    for impl in ("flash", None):
        want = sdpa(q, k, v, 0.125, impl=impl)
        torch.testing.assert_close(sdpa(q, k, v, 0.125, impl=impl, mesh=one_rank), want,
                                   atol=0, rtol=0)
    torch.testing.assert_close(sdpa(q, k, v, 0.125, impl="flash", mesh=one_rank),
                               flash_attention_plain(q, k, v, 0.125), atol=0, rtol=0)


@pytest.mark.parametrize("s", [256, 250])
def test_merge_chunk_stats_over_four_chunks_is_full_attention(s):
    """The ring's arithmetic on one process: each query slice against every
    key chunk in the ring's rotation order with its vlen_local, merged by
    merge_chunk_stats, equals full attention (the padded keys masked)."""
    n = 4
    q, k, v = (torch.from_numpy(a) for a in qkv(16, (1, 2, s, 32)))
    want = xla_sdpa(q, k, v, 32**-0.5)
    pad = (-s) % n
    q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
    s_local = (s + pad) // n
    outs = []
    for me in range(n):
        qs = q[:, :, me * s_local:(me + 1) * s_local]
        m = torch.full((1, 2, s_local, 1), -1e30)
        l, acc = torch.zeros(1, 2, s_local, 1), torch.zeros(1, 2, s_local, 32)
        for step in range(n):
            src = (me - step) % n
            chunk = slice(src * s_local, (src + 1) * s_local)
            vlen_local = min(max(s - src * s_local, 0), s_local)
            m, l, acc = merge_chunk_stats(
                m, l, acc, *flash_attention_stats(qs, k[:, :, chunk], v[:, :, chunk],
                                                  32**-0.5, vlen_local))
        outs.append(acc / l)
    got = torch.cat(outs, dim=2)[:, :, :s]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_mmdit_ring_on_local_mesh_matches_the_plain_forward(one_rank):
    jcfg, params = tiny_flux_params()
    model = mmdit_from_jax(params, torch_config(jcfg, tcfg.MMDiTConfig), device="cpu")
    inputs = list(map(torch.from_numpy, flux_inputs()))
    with torch.no_grad():
        want = model(*inputs)
        got = model(*inputs, sdpa_impl="ring", mesh=one_rank)
    assert want.abs().max() > 0.5
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_flux_pipeline_ring_matches_jax(flux_pipelines, one_rank):  # noqa: F811
    """The tiny FluxPipeline with sdpa_impl="ring" on local_mesh("cpu")
    against the JAX pipeline with sdpa_impl="ring" on a 1x1 mesh, with
    tests/test_torch_flux.py's tolerances."""
    jp, tp = flux_pipelines
    ring = FluxPipeline(load=False, low_memory_mode=False,
                        a16=False, device="cpu", sdpa_impl="ring", mesh=one_rank)
    for name in ("clip_l", "t5", "mmdit", "decoder", "tokenizer_l", "t5_tokenizer"):
        setattr(ring, name, getattr(tp, name))
    jp.sdpa_impl, jp.mesh = "ring", jax_create_mesh(1, 1, devices=jax.devices()[:1])
    try:
        kw = dict(num_steps=2, cfg_weight=0.0, latent_size=(8, 8), seed=11)
        jc, jpool = jp.encode_text("a dog", cfg_weight=0.0)
        tc, tpool = ring.encode_text("a dog", cfg_weight=0.0)
        jlat, _ = jp.denoise_latents(jc, jpool, **kw)
        tlat, _ = ring.denoise_latents(tc, tpool, **kw)
        jlat = np.asarray(jlat)
        assert np.abs(jlat).max() > 1.0
        np.testing.assert_allclose(tlat.numpy(), jlat, atol=1e-3, rtol=1e-3)
        jimg, _ = jp.generate_image("a dog", verbose=False, **kw)
        timg, _ = ring.generate_image("a dog", verbose=False, **kw)
    finally:
        jp.sdpa_impl, jp.mesh = None, None
    a, b = np.asarray(jimg).astype(int), np.asarray(timg).astype(int)
    assert a.shape == b.shape == (64, 64, 3) and b.std() > 5
    assert np.abs(a - b).max() <= 1


def test_sd3_pipeline_ring_matches_jax(sd3_pipelines, one_rank, monkeypatch):  # noqa: F811
    """The tiny SD3 DiffusionPipeline with sdpa_impl="ring" on
    local_mesh("cpu") (every joint attention one #14 chunk at d = 64)
    against the JAX pipeline with sdpa_impl="ring" on a 1x1 mesh, CFG 5.0,
    with tests/test_torch_pipeline.py's tolerances."""
    # JAX runs its Pallas mod_ln in interpret mode at the eligible sites.
    monkeypatch.setenv("DIFFUSIONKIT_TPU_FUSED_QUANT", "interpret")
    chunks = []

    def chunk(q, *args):
        chunks.append(tuple(q.shape))
        return flash_attention_stats(q, *args)

    monkeypatch.setattr(sys.modules[ring_attention.__module__], "flash_attention_stats", chunk)
    jp, tp = sd3_pipelines
    ring = DiffusionPipeline(load=False, low_memory_mode=False,
                             shift=3.0, use_t5=False, a16=False, device="cpu", sdpa_impl="ring",
                             mesh=one_rank)
    for name in ("clip_l", "clip_g", "mmdit", "decoder", "tokenizer_l", "tokenizer_g"):
        setattr(ring, name, getattr(tp, name))
    assert ring.mmdit.config.head_dim == 64
    jp.sdpa_impl, jp.mesh = "ring", jax_create_mesh(1, 1, devices=jax.devices()[:1])
    try:
        kw = dict(num_steps=2, cfg_weight=5.0, latent_size=(8, 8), seed=SEED)
        jc, jpool = jp.encode_text(PROMPT, 5.0, NEGATIVE)
        tc, tpool = ring.encode_text(PROMPT, 5.0, NEGATIVE)
        jlat, _ = jp.denoise_latents(jc, jpool, **kw)
        tlat, _ = ring.denoise_latents(tc, tpool, **kw)
        jlat = np.asarray(jlat)
        assert np.abs(jlat).max() > 1.0
        np.testing.assert_allclose(tlat.numpy(), jlat, atol=1e-3, rtol=1e-3)
        jimg, _ = jp.generate_image(PROMPT, negative_text=NEGATIVE, verbose=False, **kw)
        timg, _ = ring.generate_image(PROMPT, negative_text=NEGATIVE, verbose=False, **kw)
    finally:
        jp.sdpa_impl, jp.mesh = None, None
    a, b = np.asarray(jimg).astype(int), np.asarray(timg).astype(int)
    assert a.shape == b.shape == (64, 64, 3) and b.std() > 5
    assert np.abs(a - b).max() <= 1
    # One chunk a joint attention: 2 blocks x 2 steps, twice; the CFG batch
    # of 2, 2 heads, 16 image + 32 text tokens.
    assert chunks == [(2, 2, 48, 64)] * 8
