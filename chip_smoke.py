#!/usr/bin/env python3
"""Smoke test of the PyTorch port (diffusionkit_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):
  1. the card: name and power limit, TF32 off;
  2. build the hand-written kernels from csrc/ (nvcc, sm_90a);
  3. each kernel against its plain torch version at the main path's shapes,
     in bf16, against the plain version run on fp32 upcasts;
  4. each kernel's device time against its plain version's (CUDA graph
     replays timed with CUDA events);
  5. a reduced-depth, full-width MMDiT in bf16 on the card (kernels on)
     against the same weights in fp32 on the CPU (plain path);
  6. the main path: SD3-medium (24 blocks, hidden 1536), CLIP-L, CLIP-G and
     the full VAE decoder in bf16 with random weights from a seed, serving
     two 512² txt2img requests (50 Euler steps, CFG 5.0) through
     DiffusionPipeline.generate_image, then repeating the first through the
     phase methods; the repeat must give the identical image, and both
     kernels' launch counters must have risen by the path's launch count;
  7. two more denoise steps under torch.profiler: device-busy time per step
     by kernel family and the device's idle share.

The last line is {"ok": true, "device": {...}}; the line before it the
kernels' summary as JSON, and before that the card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from diffusionkit_tpu_torch.config import CLIP_G, CLIP_L, SD3_2b, VAEDecoderConfig
from diffusionkit_tpu_torch.flops import device_peak_flops, mmdit_step_flops
from diffusionkit_tpu_torch.models import init_clip, init_mmdit, init_vae_decoder
from diffusionkit_tpu_torch.models.mmdit import MMDiT
from diffusionkit_tpu_torch.ops import kernels
from diffusionkit_tpu_torch.ops.flash_attention import (
    flash_attention_bshd,
    flash_attention_bshd_plain,
)
from diffusionkit_tpu_torch.ops.fused_quant import mod_ln, mod_ln_plain
from diffusionkit_tpu_torch.pipeline import DiffusionPipeline
from diffusionkit_tpu_torch.tokenizer import CLIPTokenizer, synthetic_clip_vocab

STEPS, CFG, LATENT = 50, 5.0, (64, 64)
REQUESTS = [
    ("a photo of an astronaut riding a horse on the moon", 42),
    ("a watercolor painting of a lighthouse at dusk, soft light", 7),
]
MOD_LN_SHAPES = [(2, 1024, 1536), (2, 154, 1536)]  # image / text stream sites
FLASH_SHAPES = [(2, 1178, 24, 64), (1, 4096, 1, 512)]  # joint attn / VAE mid-block
# Checked but not timed: a kv edge 51 keys short of the 64-key tile, where
# an unmasked pad would move the outputs by far more than the bound.
FLASH_RAGGED = [(1, 77, 3, 64)]
# Kernel B against fp32 math, per element: one bf16 ulp of the exact value
# (half for the output rounding, half for crossing a binade) plus 2^-8 of
# the largest |output| for P rounded to bf16 before P.V. The same numerics
# in plain torch on the CPU reach 0.31-0.40 of this bound at these shapes;
# leaving the 38 pad keys of (2, 1178, 24, 64) unmasked reaches 2.
FLASH_SLACK = 2.0**-8
# bf16 activations through two full-width blocks: the plain bf16 path on
# the CPU lands at a relative L2 error of 8.5e-3 on this same check.
REF_RTOL = 3e-2
# Launches per request: 50 steps x 24 joint attentions + 1 VAE mid-block;
# 50 steps x (4 sites x 23 blocks + 3 in the last block + 1 final layer).
FLASH_PER_REQUEST = STEPS * 24 + 1
MOD_LN_PER_REQUEST = STEPS * (4 * 23 + 3 + 1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0**-126))) - 7)


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph and
    replayed between two CUDA events, so no host launch cost sits between
    the launches (a short kernel launched from Python would otherwise be
    timed at the host's pace). Median of 5 replays, divided by ``reps``.
    Inputs stay resident in L2 where they fit, as right after their
    producer in the model."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def kernel_inputs(gen):
    dev = torch.device("cuda")
    mod = []
    for b, s, h in MOD_LN_SHAPES:
        x = (torch.randn(b, s, h, generator=gen, device=dev) * 2 + 0.5).bfloat16()
        vec = torch.randn(b, 6 * h, generator=gen, device=dev).bfloat16()
        # shift/scale as the model passes them: strided views of one vector.
        mod.append((x, vec[:, None, :h], vec[:, None, h : 2 * h]))
    flash = [
        tuple(torch.randn(shape, generator=gen, device=dev).bfloat16() for _ in range(3))
        for shape in FLASH_SHAPES
    ]
    return mod, flash


def check_kernels(mod, flash) -> dict:
    """Phase 3: kernel against plain on fp32 upcasts. Returns errors."""
    errs = {"mod_ln": [], "flash_attention_bshd": []}
    for x, sh, sc in mod:
        got = mod_ln(x, sh, sc)
        torch.cuda.synchronize()
        want = mod_ln_plain(x.float(), sh.float(), sc.float())
        diff = (got.float() - want).abs()
        bound = 0.5 * bf16_ulp(want) + 1e-5
        err = diff.max().item()
        log(f"  mod_ln {tuple(x.shape)}: max_abs_err {err!r}, "
            f"tolerance half a bf16 ulp + 1e-5 per element: "
            f"{'ok' if bool((diff <= bound).all()) else 'FAIL'}")
        if not bool((diff <= bound).all()):
            raise AssertionError(f"mod_ln {tuple(x.shape)} disagrees with its plain version")
        errs["mod_ln"].append(err)
    gen = torch.Generator(device="cuda").manual_seed(1)
    ragged = [
        tuple(torch.randn(shape, generator=gen, device="cuda").bfloat16() for _ in range(3))
        for shape in FLASH_RAGGED
    ]
    for q, k, v in flash + ragged:
        scale = q.shape[-1] ** -0.5
        got = flash_attention_bshd(q, k, v, scale)
        torch.cuda.synchronize()
        want = flash_attention_bshd_plain(q.float(), k.float(), v.float(), scale)
        diff = (got.float() - want).abs()
        bound = bf16_ulp(want) + FLASH_SLACK * want.abs().max()
        err, ratio = diff.max().item(), (diff / bound).max().item()
        ok = ratio <= 1 and bool(torch.isfinite(got).all())
        log(f"  flash_attention_bshd {tuple(q.shape)}: max_abs_err {err!r}, "
            f"max |want| {want.abs().max().item()!r}; tolerance one bf16 ulp + "
            f"2^-8 max|want| per element, worst element at {ratio!r} of it: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention_bshd {tuple(q.shape)} disagrees")
        errs["flash_attention_bshd"].append(err)
    return errs


def time_kernels(mod, flash, tag: str) -> dict:
    """Phase 4: kernel vs plain version on the same bf16 inputs."""
    times = {"mod_ln": [], "flash_attention_bshd": []}
    for x, sh, sc in mod:
        ms = device_ms(lambda: mod_ln(x, sh, sc))
        plain = device_ms(lambda: mod_ln_plain(x, sh, sc))
        moved = 2 * x.numel() * x.element_size()
        log(f"  mod_ln {tuple(x.shape)}: kernel {ms!r} ms ({moved / ms / 1e9!r} TB/s), "
            f"plain {plain!r} ms [{tag}]")
        times["mod_ln"].append((tuple(x.shape), ms, plain))
    for q, k, v in flash:
        scale = q.shape[-1] ** -0.5
        ms = device_ms(lambda: flash_attention_bshd(q, k, v, scale))
        plain = device_ms(lambda: flash_attention_bshd_plain(q, k, v, scale))
        b, s, h, d = q.shape
        tflops = 4 * b * h * s * s * d / (ms / 1e3) / 1e12
        log(f"  flash_attention_bshd {tuple(q.shape)}: kernel {ms!r} ms ({tflops!r} TFLOP/s), "
            f"plain {plain!r} ms [{tag}]")
        times["flash_attention_bshd"].append((tuple(q.shape), ms, plain))
    return times


def reference_check(gen) -> None:
    """Phase 5: full-width, 2-block MMDiT, bf16 with kernels on the card vs
    the same weights in fp32 on the CPU (plain path)."""
    cfg = dataclasses.replace(SD3_2b, depth_multimodal=2, hidden_size_override=1536)
    model = init_mmdit(cfg, gen, "cuda")
    with torch.device("meta"):
        ref = MMDiT(dataclasses.replace(cfg, dtype=torch.float32))
    ref.to_empty(device="cpu")
    ref.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    rs = np.random.RandomState(0)
    inputs = [
        torch.from_numpy(rs.randn(2, *LATENT, 16).astype(np.float32)),
        torch.from_numpy(rs.randn(2, 154, 4096).astype(np.float32)),
        torch.from_numpy(rs.randn(2, 2048).astype(np.float32)),
        torch.tensor([900.0, 900.0]),
    ]
    counts = (mod_ln.launches, flash_attention_bshd.launches)
    with torch.inference_mode():
        got = model(*(t.cuda() for t in inputs)).float().cpu()
        want = ref(*inputs)
    assert mod_ln.launches - counts[0] == 4 + 3 + 1
    assert flash_attention_bshd.launches - counts[1] == 2
    rel = ((got - want).norm() / want.norm()).item()
    log(f"  MMDiT 2 blocks x hidden 1536, 512² CFG batch: bf16+kernels vs fp32 CPU: "
        f"relative L2 error {rel!r} (tolerance {REF_RTOL}), "
        f"finite {bool(torch.isfinite(got).all())}")
    if not (rel < REF_RTOL and torch.isfinite(got).all()):
        raise AssertionError("the bf16 MMDiT on the card disagrees with the fp32 reference")
    del model, ref


def build_pipeline(gen) -> DiffusionPipeline:
    pipe = DiffusionPipeline(device="cuda")
    pipe.mmdit = init_mmdit(SD3_2b, gen, "cuda")
    pipe.clip_l = init_clip(CLIP_L, gen, "cuda", dtype=torch.bfloat16)
    pipe.clip_g = init_clip(CLIP_G, gen, "cuda", dtype=torch.bfloat16)
    pipe.decoder = init_vae_decoder(VAEDecoderConfig(), gen, "cuda", dtype=torch.bfloat16)
    vocab = synthetic_clip_vocab()
    pipe.tokenizer_l = CLIPTokenizer({}, vocab, pad_with_eos=True)
    pipe.tokenizer_g = CLIPTokenizer({}, vocab, pad_with_eos=False)
    return pipe


def serve(pipe: DiffusionPipeline, tag: str):
    """Phase 6: the two requests, then the first again through the phase
    methods. Counters are zeroed right before and read right after."""
    kw = dict(num_steps=STEPS, cfg_weight=CFG, latent_size=LATENT, verbose=False)
    torch.cuda.reset_peak_memory_stats()
    mod_ln.launches = 0
    flash_attention_bshd.launches = 0
    images, logs = [], []
    for text, seed in REQUESTS:
        image, phase_log = pipe.generate_image(text, seed=seed, **kw)
        images.append(np.asarray(image))
        logs.append(phase_log)
    text, seed = REQUESTS[0]
    cond, pooled = pipe.encode_text(text, CFG)
    latents, _ = pipe.denoise_latents(cond, pooled, num_steps=STEPS, cfg_weight=CFG,
                                      latent_size=LATENT, seed=seed)
    repeat = pipe.decode_latents_to_u8(latents).cpu().numpy()[0]
    torch.cuda.synchronize()
    launches = {"mod_ln": mod_ln.launches, "flash_attention_bshd": flash_attention_bshd.launches}
    n = len(REQUESTS) + 1
    need = {"mod_ln": n * MOD_LN_PER_REQUEST, "flash_attention_bshd": n * FLASH_PER_REQUEST}
    log(f"  launches during the main path: {launches} (at least {need})")
    for name in need:
        if launches[name] < need[name]:
            raise AssertionError(f"{name} launched {launches[name]} times, expected >= {need[name]}")

    finite = bool(torch.isfinite(latents).all())
    log(f"  latents {tuple(latents.shape)} finite: {finite}, "
        f"mean {latents.mean().item()!r}, std {latents.std().item()!r}")
    if not finite:
        raise AssertionError("non-finite latents")
    for i, img in enumerate(images):
        log(f"  request {i}: image {img.shape} {img.dtype}, pixel std {img.std()!r}, "
            f"levels {len(np.unique(img))}")
        if img.shape != (512, 512, 3) or img.std() == 0:
            raise AssertionError(f"request {i}: wrong shape or constant image")
    if not np.array_equal(repeat, images[0]):
        raise AssertionError("repeating the first request gave a different image")
    log("  repeat of request 0: bit-identical image")
    if np.array_equal(images[0], images[1]):
        raise AssertionError("two different requests gave the same image")

    flops = mmdit_step_flops(SD3_2b, LATENT, 154, cfg=True)["total"]
    peak = device_peak_flops(torch.cuda.get_device_name(0))
    for i, lg in enumerate(logs):
        it = lg["denoising"]["iter_time"]
        mean_ms = 1e3 * statistics.mean(it)
        median_ms = 1e3 * statistics.median(it)
        tflops = flops / (median_ms / 1e3) / 1e12
        log(f"  request {i}: text_encoding {lg['text_encoding']['time']!r} s, "
            f"denoising {lg['denoising']['time']!r} s, decoding {lg['decoding']['time']!r} s, "
            f"total {lg['total_time']!r} s/image [{tag}]")
        log(f"  request {i}: denoise mean {mean_ms!r} ms/step, median {median_ms!r} ms/step, "
            f"first step {1e3 * it[0]!r} ms; {tflops!r} TFLOP/s at the median "
            f"({flops / 1e12!r} TFLOP/step), {tflops * 1e12 / peak if peak else None!r} of the "
            f"{peak / 1e12!r} TFLOP/s bf16 peak [{tag}]")
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30!r} GiB [{tag}]")
    return launches, 1e3 * statistics.median(logs[1]["denoising"]["iter_time"])


def profile_step(pipe: DiffusionPipeline, step_ms: float, tag: str) -> None:
    """Phase 7: two denoise steps under torch.profiler; device-busy time per
    step by kernel family, the largest kernels outside the named families,
    and the idle share against a step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cond, pooled = pipe.encode_text(REQUESTS[0][0], CFG)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, it = pipe.denoise_latents(cond, pooled, num_steps=2, cfg_weight=CFG,
                                     latent_size=LATENT, seed=1)
        torch.cuda.synchronize()
    families, other = {}, []
    for ev in prof.key_averages():
        # Device-side rows only (kernels, copies, memsets): a CPU op's row
        # repeats the device time of the kernels it launched.
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3 / 2
        name = ev.key
        fam = ("flash_attention_bshd" if "flash_fwd" in name else "mod_ln" if "mod_ln" in name
               else "gemm" if ("nvjet" in name or "gemm" in name) else "other")
        families[fam] = families.get(fam, 0.0) + ms
        if fam == "other":
            other.append((ms, ev.count // 2, name))
    busy = sum(families.values())
    log(f"  device busy {busy!r} ms/step: {dict(sorted(families.items()))} [{tag}]")
    for ms, count, name in sorted(other, reverse=True)[:6]:
        log(f"    other: {ms!r} ms/step in {count} launches/step of {name[:90]}")
    profiled_ms = 1e3 * statistics.mean(it)
    log(f"  idle share: {1 - busy / step_ms!r} at the median step of request 1 "
        f"({step_ms!r} ms, unprofiled); {1 - busy / profiled_ms!r} at the profiled "
        f"steps' own mean ({profiled_ms!r} ms, profiler overhead included) [{tag}]")


def main() -> None:
    log("phase 1: card")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels need one")
    tag = card()
    log(f"  {tag}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    log("phase 2: build")
    t0 = time.perf_counter()
    kernels.library()
    log(f"  {kernels.library_path().name}: built and loaded in {time.perf_counter() - t0!r} s")
    ptxas = kernels.library_path().with_suffix(".log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    mod, flash = kernel_inputs(gen)
    log("phase 3: kernels against their plain versions (bf16 vs fp32 upcasts)")
    errs = check_kernels(mod, flash)
    log("phase 4: kernel device times (20 calls per CUDA graph, median of 5 replays)")
    times = time_kernels(mod, flash, tag)
    del mod, flash

    log("phase 5: reference check")
    reference_check(gen)
    torch.cuda.empty_cache()

    log("phase 6: main path (SD3-medium 512², 50 steps, CFG 5.0, random weights)")
    t0 = time.perf_counter()
    pipe = build_pipeline(gen)
    torch.cuda.synchronize()
    log(f"  random SD3-medium + CLIP-L/G + VAE decoder on the card in {time.perf_counter() - t0!r} s")
    launches, step_ms = serve(pipe, tag)
    log("phase 7: where a denoise step's device time goes (torch.profiler)")
    profile_step(pipe, step_ms, tag)

    sources = {
        "mod_ln": ("diffusionkit_tpu_torch/csrc/mod_ln.cu",
                   "diffusionkit_tpu/ops/fused_quant.py:284"),
        "flash_attention_bshd": ("diffusionkit_tpu_torch/csrc/flash_attention.cu",
                                 "diffusionkit_tpu/ops/flash_attention.py:343"),
    }
    summary = []
    for name, (source, replaces) in sources.items():
        shape, ms, plain = times[name][0]
        summary.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max(errs[name]),
            "ms": ms, "plain_ms": plain, "shape": list(shape),
            "shapes": [{"shape": list(s), "ms": m, "plain_ms": p} for s, m, p in times[name]],
        })
    log(tag)
    log(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
