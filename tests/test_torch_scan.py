"""The port's denoise loop and batch entry points against the JAX
package's: the scan (``use_scan``, on the card a CUDA graph of one step),
``num_images``, the denoise auto-split, the chunked decode and
``generate_images_batched``.

The tiny pipelines of tests/test_torch_pipeline.py (SD3, CFG) and
tests/test_torch_flux.py (FLUX, and FLUX-dev with its guidance embedder)
run on shared weights, fp32 on the CPU. On the CPU the scan is the step
body in a Python loop; the graph itself runs in ``chip_smoke.py`` on the
card, where the capture's launch counting is checked against the loop's.
"""

import contextlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionkit_tpu import pipeline as jax_pipeline
from diffusionkit_tpu_torch import config as tcfg
from diffusionkit_tpu_torch import graphs, pipeline, utils
from diffusionkit_tpu_torch.convert import clip_from_jax, mmdit_from_jax, t5_from_jax
from diffusionkit_tpu_torch.convert import vae_decoder_from_jax
from diffusionkit_tpu_torch.ops import fused_quant, launches, w4a8_matmul
from diffusionkit_tpu_torch.pipeline import DiffusionPipeline, FluxPipeline
from diffusionkit_tpu_torch.tokenizer import CLIPTokenizer

from test_pipeline import TinyT5Tokenizer, build_flux_pipeline, make_tiny_clip_tokenizer
from test_torch_flux import with_unit_qk_scales
from test_torch_models import randomize, torch_config
from test_torch_pipeline import NEGATIVE, PROMPT, SEED, build_pipelines

torch.set_num_threads(1)

SPLIT_ENV = "DIFFUSIONKIT_TPU_DENOISE_BATCH"


@pytest.fixture(scope="module")
def sd3():
    return build_pipelines()


def flux_pipelines(guidance_embed: bool):
    """tests/test_pipeline.py's tiny FLUX pipeline (FLUX-dev with the
    guidance embedder and 512 T5 tokens), its weights redrawn, and the
    port's on the same weights and tokenizers."""
    jp = build_flux_pipeline(guidance_embed=guidance_embed)
    jp.activation_dtype = jnp.float32  # the VAE in fp32 on both sides
    jp.clip_l = randomize(jp.clip_l, 1)
    jp.t5_params = randomize(jp.t5_params, 2)
    jp.mmdit_params = with_unit_qk_scales(randomize(jp.mmdit_params, 3))
    jp.decoder_params = randomize(jp.decoder_params, 4)
    tp = FluxPipeline(load=False, low_memory_mode=False, a16=False, device="cpu", model_version=(
        "argmaxinc/mlx-FLUX.1-dev" if guidance_embed else "argmaxinc/mlx-FLUX.1-schnell"))
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
    tp.t5_tokenizer = TinyT5Tokenizer()
    return jp, tp


def pixels(images):
    return [np.asarray(im).astype(int) for im in images]


def tap_decode(monkeypatch, tp):
    """The latents each ``_decode_batched_u8`` call decodes, in order."""
    seen = []
    decode = tp._decode_batched_u8

    def tapped(latents):
        seen.append(latents.clone())
        return decode(latents)

    monkeypatch.setattr(tp, "_decode_batched_u8", tapped)
    return seen


def test_use_scan_is_the_default():
    off = dict(load=False, low_memory_mode=False, device="cpu")
    assert DiffusionPipeline(**off).use_scan and FluxPipeline(**off).use_scan


def test_scan_matches_the_jax_scan(sd3, monkeypatch):
    # JAX runs its Pallas mod_ln in interpret mode at the eligible sites;
    # its default use_scan runs _denoise_scan, one lax.scan.
    monkeypatch.setenv("DIFFUSIONKIT_TPU_FUSED_QUANT", "interpret")
    jp, tp = sd3
    assert jp.use_scan and tp.use_scan
    jc, jpool = jp.encode_text(PROMPT, 5.0, NEGATIVE)
    tc, tpool = tp.encode_text(PROMPT, 5.0, NEGATIVE)
    kw = dict(num_steps=3, cfg_weight=5.0, latent_size=(8, 8), seed=SEED)
    jlat, jit = jp.denoise_latents(jc, jpool, **kw)
    tlat, tit = tp.denoise_latents(tc, tpool, **kw)
    jlat = np.asarray(jlat)
    assert np.abs(jlat).max() > 1.0
    # test_generate_image_matches_jax's bound: the fp32 MMDiT baseline
    # through CFG-5 Euler steps.
    np.testing.assert_allclose(tlat.numpy(), jlat, atol=1e-3, rtol=1e-3)
    # iter_time is the schedule's time over n, rounded as the reference's.
    assert len(tit) == len(jit) == 3 and len(set(tit)) == 1 and tit[0] == round(tit[0], 4)


@pytest.mark.parametrize("cfg_weight", [5.0, 0.0])
def test_scan_is_the_synced_loop_bit_for_bit(sd3, cfg_weight):
    _, tp = sd3
    cond, pooled = tp.encode_text(PROMPT, cfg_weight, NEGATIVE)
    kw = dict(num_steps=3, cfg_weight=cfg_weight, latent_size=(8, 8), seed=5, num_images=2)
    scan, it_scan = tp.denoise_latents(cond, pooled, **kw)
    tp.use_scan = False
    try:
        loop, it_loop = tp.denoise_latents(cond, pooled, **kw)
    finally:
        tp.use_scan = True
    assert torch.equal(scan, loop) and scan.shape == (2, 8, 8, 16)
    assert len(it_scan) == len(it_loop) == 3


def test_num_images_gives_distinct_images_image_0_the_single_run(sd3):
    jp, tp = sd3
    kw = dict(num_steps=2, cfg_weight=5.0, latent_size=(8, 8), seed=1, verbose=False)
    imgs, log = tp.generate_image("a cat", num_images=2, **kw)
    assert isinstance(imgs, list) and len(imgs) == 2
    assert not np.array_equal(np.asarray(imgs[0]), np.asarray(imgs[1]))
    single, _ = tp.generate_image("a cat", **kw)
    np.testing.assert_array_equal(np.asarray(imgs[0]), np.asarray(single))
    assert len(log["denoising"]["iter_time"]) == 2
    # The batch's noise is drawn in one seeded call: image 0's is the
    # single run's, bit for bit, as in the JAX package.
    x_t = tp.get_empty_latent(8, 8)
    np.testing.assert_array_equal(tp.get_noise(1, np.tile(x_t, (2, 1, 1, 1)))[:1],
                                  tp.get_noise(1, x_t))
    jimgs, _ = jp.generate_image("a cat", num_images=2, **kw)
    for a, b in zip(pixels(jimgs), pixels(imgs)):
        assert np.abs(a - b).max() <= 1  # one uint8 level: fp32 noise at a level boundary


def test_decode_batched_u8_matches_the_whole_decode(sd3):
    _, tp = sd3
    # h*w = 7744 -> 2 images a chunk, so 3 images decode as [0:2] and a
    # ragged [2:3] at its own shape.
    lat = torch.from_numpy(np.random.RandomState(0).randn(3, 88, 88, 16).astype(np.float32))
    whole = tp.decode_latents_to_u8(lat).numpy()
    chunked = tp._decode_batched_u8(lat)
    assert isinstance(chunked, np.ndarray) and chunked.dtype == np.uint8
    assert chunked.shape == whole.shape == (3, 704, 704, 3)
    np.testing.assert_array_equal(chunked, whole)


@pytest.mark.parametrize("entry", ["generate_images_batched", "num_images"])
def test_denoise_autosplit_matches_the_whole_batch(sd3, monkeypatch, entry):
    _, tp = sd3
    seen = tap_decode(monkeypatch, tp)

    def run(per: str):
        monkeypatch.setenv(SPLIT_ENV, per)
        if entry == "num_images":
            return pixels(tp.generate_image("a fox", num_steps=2, cfg_weight=5.0,
                                            latent_size=(8, 8), seed=11, num_images=3,
                                            verbose=False)[0])
        return pixels(tp.generate_images_batched(["a cat", "a dog", "a bird"], num_steps=2,
                                                 cfg_weight=5.0, latent_size=(8, 8),
                                                 seeds=[1, 2, 3]))

    whole, split = run("8"), run("2")
    assert len(whole) == len(split) == 3 and len(seen) == 2
    assert seen[0].shape == seen[1].shape == (3, 8, 8, 16)
    # The chunks run the same step on their rows of the CFG layout; only
    # the GEMMs' row count differs (6 model rows against 4 and 2), and the
    # CPU's fp32 GEMM sums a row in an order that depends on it at small M
    # (1.5e-5 apart at K = 128), which the JAX package's dot does not. A
    # chunk given another image's conditioning rows would move its latents
    # by O(1).
    np.testing.assert_allclose(seen[1].numpy(), seen[0].numpy(), atol=1e-5, rtol=1e-5)
    for w, s in zip(whole, split):
        assert np.abs(w - s).max() <= 1
    # At one image a chunk the shapes are the single runs': bit for bit.
    monkeypatch.setenv(SPLIT_ENV, "1")
    if entry == "num_images":
        lat, _ = tp.denoise_latents(*tp.encode_text("a fox", 5.0), num_steps=2, cfg_weight=5.0,
                                    latent_size=(8, 8), seed=11, num_images=3)
        single, _ = tp.denoise_latents(*tp.encode_text("a fox", 5.0), num_steps=2,
                                       cfg_weight=5.0, latent_size=(8, 8), seed=11)
        assert torch.equal(lat[:1], single)
    else:
        tp.generate_images_batched(["a cat", "a dog", "a bird"], num_steps=2, cfg_weight=5.0,
                                   latent_size=(8, 8), seeds=[1, 2, 3])
        for i, (text, seed) in enumerate((("a cat", 1), ("a dog", 2), ("a bird", 3))):
            single, _ = tp.denoise_latents(*tp.encode_text(text, 5.0), num_steps=2,
                                           cfg_weight=5.0, latent_size=(8, 8), seed=seed)
            assert torch.equal(seen[2][i : i + 1], single)


@pytest.mark.parametrize("model", ["sd3-cfg", "flux-dev-guidance"])
def test_generate_images_batched_matches_jax(sd3, monkeypatch, model):
    monkeypatch.setenv("DIFFUSIONKIT_TPU_FUSED_QUANT", "interpret")
    if model == "sd3-cfg":
        jp, tp = sd3
        kw = dict(num_steps=2, cfg_weight=5.0, negative_texts=["blurry", ""],
                  latent_size=(8, 8), seeds=[4, 9])
    else:
        jp, tp = flux_pipelines(guidance_embed=True)
        kw = dict(num_steps=2, cfg_weight=0.0, latent_size=(8, 8), seeds=[4, 9], guidance=4.0)
    texts = ["a cat on a mat", "a dog"]
    want = pixels(jp.generate_images_batched(texts, **kw))
    got = pixels(tp.generate_images_batched(texts, **kw))
    assert len(got) == 2 and got[0].shape == (64, 64, 3)
    assert got[0].std() > 5 and not np.array_equal(got[0], got[1])
    for a, b in zip(want, got):
        assert np.abs(a - b).max() <= 1  # one uint8 level
    if model != "sd3-cfg":  # the guidance reaches the model
        moved = pixels(tp.generate_images_batched(texts, **{**kw, "guidance": 1.0}))
        assert not np.array_equal(moved[0], got[0])


@pytest.mark.parametrize("cfg_on,num_images", [(True, 1), (True, 3), (False, 1), (False, 3)])
def test_prep_and_chunk_conditioning_match_jax(cfg_on, num_images):
    rs = np.random.RandomState(num_images)
    cond = rs.randn(2 if cfg_on else 1, 5, 8).astype(np.float32)
    pooled = rs.randn(cond.shape[0], 4).astype(np.float32)
    jc, jp = jax_pipeline._prep_conditioning(cond, pooled, cfg_on=cfg_on, num_images=num_images,
                                             dtype=jnp.float32)
    tc, tp = pipeline._prep_conditioning(torch.from_numpy(cond), torch.from_numpy(pooled),
                                         cfg_on, num_images, torch.float32)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    for i, j in ((0, 1), (1, num_images)):
        if i >= j:
            continue
        jcc, jpc = jax_pipeline._chunk_cond(jc, jp, i, j, num_images, cfg_on)
        tcc, tpc = pipeline._chunk_cond(tc, tp, i, j, num_images, cfg_on)
        np.testing.assert_array_equal(tcc.numpy(), np.asarray(jcc))
        np.testing.assert_array_equal(tpc.numpy(), np.asarray(jpc))


def test_schedules_are_cached_by_what_a_capture_bakes_in(sd3, monkeypatch):
    _, tp = sd3
    cond, pooled = tp.encode_text(PROMPT, 5.0, NEGATIVE)
    kw = dict(cfg_weight=5.0, latent_size=(8, 8), seed=3)
    tp.mmdit = tp.mmdit  # the setter drops every cached schedule
    assert not tp._scans
    tp.denoise_latents(cond, pooled, num_steps=2, **kw)
    tp.denoise_latents(cond, pooled, num_steps=1, **kw)  # fewer steps: the same buffers
    assert len(tp._scans) == 1
    # The attention switches the forward reads: a stale graph would run
    # the other kernel.
    monkeypatch.setenv("DIFFUSIONKIT_TPU_ATTN_LAYOUT", "bhsd")
    tp.denoise_latents(cond, pooled, num_steps=2, **kw)
    monkeypatch.setenv("DIFFUSIONKIT_TPU_SDPA", "xla")
    tp.denoise_latents(cond, pooled, num_steps=2, **kw)
    tp.denoise_latents(cond, pooled, num_steps=2, num_images=2, **kw)  # another batch shape
    assert len(tp._scans) == 4
    tp.denoise_latents(cond, pooled, num_steps=5, **kw)  # a longer schedule than the buffers
    assert len(tp._scans) == 4 and max(s.n_sigmas for s in tp._scans.values()) == 6
    tp.mmdit = tp.mmdit
    assert not tp._scans


def test_launch_counts_delta_and_add_follow_the_counters():
    saved = launches.snapshot()
    try:
        before = launches.snapshot()
        fused_quant.mod_ln.launches += 3
        w4a8_matmul.w4a8_matmul.mode_launches["norm_rope"] += 2
        w4a8_matmul.w8_matmul.quantizing_launches += 1
        d = launches.delta(before, launches.snapshot())
        assert d[("mod_ln", "launches")] == 3 and d[("w8_matmul", "quantizing_launches")] == 1
        assert d[("w4a8_matmul", "mode_launches")]["norm_rope"] == 2
        assert d[("flash_attention", "launches")] == 0
        launches.add(d, -1)
        assert launches.snapshot() == before
        # A counter rebound between readings (as chip_smoke's reset does):
        # the live dict is the one moved.
        w4a8_matmul.w4a8_matmul.mode_launches = dict.fromkeys(w4a8_matmul.MODES, 0)
        launches.add(d, 4)
        assert w4a8_matmul.w4a8_matmul.mode_launches["norm_rope"] == 8
        assert fused_quant.mod_ln.launches == before[("mod_ln", "launches")] + 12
    finally:
        launches.add(launches.delta(launches.snapshot(), saved))
    assert launches.snapshot() == saved


def cuda_graph_standins(monkeypatch, replay, enter=lambda: None, leave=lambda: None):
    """CPU stand-ins for the CUDA graph API that StepGraph calls: a graph
    whose ``replay`` calls ``replay`` and a capture context that calls
    ``enter`` and ``leave`` around the captured step."""

    class Graph:
        def replay(self):
            replay()

    @contextlib.contextmanager
    def capture(graph, stream=None):
        enter()
        yield
        leave()

    class Stream:
        def __init__(self, device=None):
            pass

        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", capture)


def test_step_graph_counts_a_replay_as_the_captured_step(monkeypatch):
    """StepGraph on stand-ins: the step (here one that counts as a wrapper
    does, standing in for the kernels it would launch) runs twice, the
    warm-up and the capture; a replay runs no Python. n steps must count n
    steps' launches."""
    calls, replays = [], []
    cuda_graph_standins(monkeypatch, replay=lambda: replays.append(1))

    def step():
        calls.append(1)
        fused_quant.mod_ln.launches += 5
        w4a8_matmul.w4a8_matmul.mode_launches["plain"] += 2

    saved = launches.snapshot()
    try:
        start = launches.snapshot()
        sg = graphs.StepGraph(step, torch.device("cuda"))
        sg.run(4)  # the warm-up is step 0, then 3 replays
        sg.run(6)
        assert len(calls) == 2 and len(replays) == 9
        d = launches.delta(start, launches.snapshot())
        assert d[("mod_ln", "launches")] == 5 * 10
        assert d[("w4a8_matmul", "mode_launches")]["plain"] == 2 * 10
        assert sg.counts[("mod_ln", "launches")] == 5
    finally:
        launches.add(launches.delta(launches.snapshot(), saved))


def test_step_graph_takes_the_schedule_of_the_loop(sd3, monkeypatch):
    """The tiny SD3 pipeline's real scan body under StepGraph, on stand-ins
    that keep a capture's semantics: the capture records the step and
    leaves the buffers as they were, a replay runs the recorded step
    without Python's counting. The warm-up must be the schedule's step 0
    and the replays steps 1 to n - 1: the latents are the synced loop's bit
    for bit, and the counters read n steps."""
    _, tp = sd3
    counting = pipeline._cfg_euler_step

    def counted_step(*args, **kw):  # a wrapper's count where it launches
        fused_quant.mod_ln.launches += 1
        return counting(*args, **kw)

    monkeypatch.setattr(pipeline, "_cfg_euler_step", counted_step)
    cond, pooled = tp.encode_text(PROMPT, 5.0, NEGATIVE)
    cond, pooled = pipeline._prep_conditioning(cond, pooled, True, 1, torch.float32)
    sigmas = tp.get_sigmas(4)
    x0 = torch.from_numpy(np.random.RandomState(8).randn(1, 8, 8, 16).astype(np.float32))
    scan = pipeline._Scan(tp.mmdit, x0, cond, pooled, None, len(sigmas), True, None, None,
                          capture=False)
    state = []

    def replay():
        saved = launches.snapshot()
        scan.step()
        launches.add(launches.delta(launches.snapshot(), saved))

    def enter():
        state[:] = [scan.x.clone(), scan.idx.clone()]

    def leave():
        scan.x.copy_(state[0])
        scan.idx.copy_(state[1])

    cuda_graph_standins(monkeypatch, replay, enter, leave)
    scan.graph = graphs.StepGraph(scan.step, torch.device("cuda"))
    saved = launches.snapshot()
    try:
        with torch.inference_mode():
            scan.load(x0, cond, pooled, 5.0, None, sigmas)
            start = fused_quant.mod_ln.launches
            scan.run(len(sigmas) - 1)
            graph_x = scan.x.clone()
            graph_count = fused_quant.mod_ln.launches - start
            loop_x, _ = tp._denoise_loop(x0, sigmas, cond, pooled, 5.0, None, True)
        assert graph_count == len(sigmas) - 1 == 4
        assert torch.equal(graph_x, loop_x)
        assert scan.idx.tolist() == [4, 5]
    finally:
        launches.add(launches.delta(launches.snapshot(), saved))


def test_hbm_scale_floor_and_override(monkeypatch, sd3):
    monkeypatch.delenv("DIFFUSIONKIT_TPU_HBM_SCALE", raising=False)
    assert utils.hbm_scale("cpu") == 1.0

    class Props:
        total_memory = 0

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device=None: Props)
    Props.total_memory = 8e9  # a card smaller than the reference's 16 GB chip: the floor
    assert utils.hbm_scale("cuda") == 1.0
    Props.total_memory = 85_017_690_112  # an H100 80GB
    assert utils.hbm_scale("cuda") == pytest.approx(5.3136, abs=1e-4)
    monkeypatch.setenv("DIFFUSIONKIT_TPU_HBM_SCALE", "0.5")  # the override is taken as given
    assert utils.hbm_scale("cuda") == 0.5
    monkeypatch.delenv("DIFFUSIONKIT_TPU_HBM_SCALE")

    _, tp = sd3
    card = DiffusionPipeline(load=False, low_memory_mode=False, device="cuda", use_t5=False)
    assert card._denoise_chunk_images((64, 64)) == 21
    assert card._denoise_chunk_images((128, 128)) == 5
    assert tp._denoise_chunk_images((64, 64)) == 4  # the CPU: the reference's 16 GB budget
    monkeypatch.setenv(SPLIT_ENV, "3")
    assert card._denoise_chunk_images((128, 128)) == 3
    monkeypatch.setenv(SPLIT_ENV, "0")
    assert card._denoise_chunk_images((128, 128)) == 1
    monkeypatch.delenv(SPLIT_ENV)
    card.mesh = object()  # under a mesh: no split
    assert card._denoise_chunk_images((128, 128)) == 1 << 30


def test_profile_dir_writes_a_trace(sd3, tmp_path):
    _, tp = sd3
    img, log = tp.generate_image(PROMPT, num_steps=1, cfg_weight=5.0, latent_size=(8, 8), seed=2,
                                 verbose=False, profile_dir=str(tmp_path))
    assert img.size == (64, 64)
    traces = [p for p in os.listdir(tmp_path) if p.endswith(".json")]
    assert traces, os.listdir(tmp_path)
    assert os.path.getsize(tmp_path / traces[0]) > 0
