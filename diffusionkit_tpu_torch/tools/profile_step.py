"""Where one denoise step's device time goes, by kernel category.

The counterpart of the JAX package's ``tools/profile_step.py``: it builds
one configuration's MMDiT with random weights (a seeded
``torch.Generator``, as ``chip_smoke.py`` draws them) behind its pipeline,
runs a warm-up request (on the card it captures the step's CUDA graph),
times ``N_STEPS`` steps of ``denoise_latents`` (the graph's replays, one
synchronise at the end), then runs ``N_STEPS`` more under
``torch.profiler`` and sums the device-side rows by category:

- ``attention``: kernel B, #15 and #14 (bf16 and fp32);
- each quantized GEMM family by its kernel: ``int4_matmul`` (C),
  ``int8_matmul`` (#13), ``w4a8_matmul`` (E), ``w8_matmul`` (#11),
  ``dequant_w8`` (#10), ``int8_dot`` (#16), with their M <= 16 GEMVs
  (``[gemv]``), fp32 tiles (``[f32]``) and fp32 GEMVs (``[f32-gemv]``)
  apart;
- ``cublas_gemm``: the library's GEMMs (nvjet, cutlass, ...);
- ``row``: A, A', D and #4;
- ``elementwise``: torch's elementwise and reduction kernels;
- ``copies``: memcpy, memset and copy kernels;
- ``other``: the rest.

It writes ``wall_ms_per_step`` (unprofiled), ``device_total_ms_per_step``,
``by_category_ms_per_step``, the top kernels and the idle share
(1 - device total / wall) as JSON:

    python -m diffusionkit_tpu_torch.tools.profile_step [sd3|flux-int4|flux-w4a8|sd35-w4a8] [out.json]
        [--steps N] [--device cpu]

On the card by default. ``--device cpu`` (mode ``tiny``, a two-block SD3
in fp32, is meant for it) profiles the CPU's ops instead: the plain
versions, which say nothing of the card. ``chip_smoke.py``'s phase 7 reads
its kernel categories through ``family``, ``device_split`` and
``by_category``.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

N_STEPS = 8
MODES = ("sd3", "flux-int4", "flux-w4a8", "sd35-w4a8", "tiny")
TOP = 25

# The flash kernels as the profiler names them, demangled or not: #14 is
# flash_fwd_sm90_stats<128> and flash_fwd_sm90_stats64 (flash_fwd_bhsd_small
# <64, true> in earlier builds), #15 flash_fwd_sm90<D, true> and at d = 512
# flash_fwd_wide_sm90<true> with flash_wide_merge<true>, kernel B the same
# with false (and the d = 512 kernel of earlier builds, flash_fwd_wide<512, .>).
SCALE_FIRST = re.compile(r"flash_fwd_(?:wide|sm90)(?:<\d+, true>|ILi\d+ELb1E)"
                         r"|flash_(?:fwd_wide_sm90|wide_merge)(?:<true>|ILb1E)")
# The fp32 kernels, flash_fwd_3xtf32_sm90<D, mode> and flash_fwd_3xtf32<mode>
# (and flash_fwd_f32<D, mode> of earlier builds): 0 kernel B, 1 #15, 2 #14;
# #16 is w8_mm_sm90<int, BN> or w8_mm_sm90_k64<int> (M > 16) or
# w8_mm<int, ...>, #11 the same templates with a bf16 or float output.
FP32_MODE = re.compile(r"flash_fwd_(?:f32|3xtf32(?:_sm90)?)"
                       r"(?:<(?:\d+, )?(\d)>|I(?:Li\d+E)?Li(\d)E)")
INT8_DOT_KERNEL = re.compile(r"w8_mm(?:_sm90)?(?:_k64)?(?:<int[,>]|Ii[LE])")
# The M <= 16 GEMVs of C, #13, E and #11: int4_gemv, int8_gemv, w4a8_gemv,
# w8_gemv<XT, OutT>.
GEMV_KERNEL = re.compile(r"(int4|int8|w4a8|w8)_gemv")
# C and #13 on fp32 x: dequant_mm_3xtf32<BITS> above 16 rows (and the
# dequant_mm_f32<BITS> FMA tile of earlier builds at M <= 16), the fp32 GEMV
# dequant_gemv_f32<BITS, MT> at M <= 16.
F32_TILE = re.compile(r"dequant_mm_(?:f32|3xtf32)(?:<|ILi)(\d)")
F32_GEMV = re.compile(r"dequant_gemv_f32(?:<|ILi)(\d)")

ATTENTION = ("flash_attention_bshd", "flash_attention", "flash_attention_stats")
ROW = ("mod_ln", "mod_ln_quantize", "quantize", "gelu_quantize", "gelu_quant[tiles]")
COPY = re.compile(r"^Mem(?:cpy|set)|copy_kernel|CatArrayBatchedCopy|memcpy|memset", re.I)
ELEMENTWISE = re.compile(r"elementwise|reduce_kernel|Reduce|softmax|norm_kernel|index_",
                         re.I)


def family(name: str) -> str:
    """The kernel family of a profiler row's name: a hand-written kernel's
    wrapper name (``[gemv]`` / ``[f32]`` / ``[f32-gemv]`` forms apart),
    ``gemm`` for the library's GEMMs, else ``other``."""
    f32_gemv = F32_GEMV.search(name)
    if f32_gemv:
        return f"int{f32_gemv.group(1)}_matmul[f32-gemv]"
    gemv = GEMV_KERNEL.search(name)
    if gemv:
        return f"{gemv.group(1)}_matmul[gemv]"
    tile = F32_TILE.search(name)
    if tile:
        return f"int{tile.group(1)}_matmul[f32]"
    fp32 = FP32_MODE.search(name)
    if fp32:
        return ATTENTION[int(fp32.group(1) or fp32.group(2))]
    if "dequant_w8" in name:
        return "dequant_w8"
    if INT8_DOT_KERNEL.search(name):
        return "int8_dot"
    if "flash_fwd_sm90_stats" in name or "flash_fwd_bhsd_small" in name:
        return "flash_attention_stats"
    if SCALE_FIRST.search(name):
        return "flash_attention"
    if "flash_fwd" in name or "flash_wide_merge" in name:
        return "flash_attention_bshd"
    if "w4a8_mm" in name:
        return "w4a8_matmul"
    if "w8_mm" in name:
        return "w8_matmul"
    if "int8_mm" in name:
        return "int8_matmul"
    if "tile_absmax_kernel" in name or "tile_quantize_kernel" in name:
        return "gelu_quant[tiles]"
    if "gelu_quantize_kernel" in name:
        return "gelu_quantize"
    if "mod_ln_quant" in name:
        return "mod_ln_quantize"
    if "quantize_kernel" in name:  # before mod_ln: a mangled name holds "mod_ln_cu"
        return "quantize"
    if "mod_ln" in name:
        return "mod_ln"
    if "int4_mm" in name:
        return "int4_matmul"
    if "nvjet" in name or "gemm" in name:
        return "gemm"
    return "other"


def category(name: str) -> str:
    """The category of a profiler row (module docstring)."""
    fam = family(name)
    if fam in ATTENTION:
        return "attention"
    if fam in ROW:
        return "row"
    if fam == "gemm":
        return "cublas_gemm"
    if fam != "other":
        return fam
    if COPY.search(name):
        return "copies"
    if ELEMENTWISE.search(name):
        return "elementwise"
    return "other"


def _rows(prof, device: bool = True) -> List[Tuple[str, float, int]]:
    """(name, self ms, calls) of the profile's device-side rows (kernels,
    copies, memsets; a CPU op's row repeats the device time of the kernels
    it launched), or of its CPU ops with ``device=False``."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.key_averages():
        if device and ev.device_type == DeviceType.CUDA:
            out.append((ev.key, ev.self_device_time_total / 1e3, ev.count))
        elif not device and ev.device_type == DeviceType.CPU:
            out.append((ev.key, ev.self_cpu_time_total / 1e3, ev.count))
    return out


def kernel_counts(prof) -> collections.Counter:
    """The device kernels of a profile by name, with their launches."""
    return collections.Counter({name: count for name, _, count in _rows(prof)})


def device_split(prof, div: int):
    """Device time by kernel family divided by ``div``, and the rows left in
    ``other`` as (ms, launches, name), each divided by ``div``."""
    families, other = {}, []
    for name, ms, count in _rows(prof):
        fam = family(name)
        families[fam] = families.get(fam, 0.0) + ms / div
        if fam == "other":
            other.append((ms / div, count // div, name))
    return families, other


def by_category(prof, div: int, device: bool = True) -> Dict[str, float]:
    """ms by category divided by ``div``, largest first."""
    cats = collections.Counter()
    for name, ms, _ in _rows(prof, device):
        cats[category(name)] += ms / div
    return dict(sorted(cats.items(), key=lambda kv: -kv[1]))


def top_kernels(prof, div: int, device: bool = True, n: int = TOP) -> List[dict]:
    rows = sorted(_rows(prof, device), key=lambda r: -r[1])[:n]
    return [{"name": name[:160], "category": category(name), "ms_per_step": ms / div,
             "launches_per_step": count / div} for name, ms, count in rows]


def build(mode: str, device: str = "cuda", seed: int = 0):
    """The pipeline of ``mode`` with a random MMDiT and no text encoders,
    and its request: (pipe, conditioning, pooled, denoise kwargs)."""
    from .. import config as cfgs
    from ..models.mmdit import init_mmdit
    from ..pipeline import DiffusionPipeline, FluxPipeline

    gen = torch.Generator(device=device).manual_seed(seed)
    base = dict(load=False, low_memory_mode=False, device=device)
    if mode == "tiny":
        cfg = cfgs.MMDiTConfig(depth_multimodal=2, num_heads=2, hidden_size_override=64,
                               max_latent_resolution=16, token_level_text_embed_dim=32,
                               pooled_text_embed_dim=48, dtype=torch.float32)
        pipe = DiffusionPipeline(use_t5=False, a16=False, **base)
        txt, latent, cfg_weight, model = 10, (8, 8), 5.0, init_mmdit(cfg, gen, device)
    elif mode == "sd3":
        pipe = DiffusionPipeline(use_t5=False, **base)
        cfg = cfgs.SD3_2b
        txt, latent, cfg_weight, model = 154, (64, 64), 5.0, init_mmdit(cfg, gen, device)
    elif mode == "sd35-w4a8":
        pipe = DiffusionPipeline(use_t5=False, model_version=cfgs.SD35_LARGE,
                                 quantize_mmdit="w4a8", **base)
        cfg = cfgs.SD3_8b
        txt, latent, cfg_weight = 154, (128, 128), 5.0
        model = init_mmdit(cfg, gen, device, quantize_bits=4)
    elif mode in ("flux-int4", "flux-w4a8"):
        pipe = FluxPipeline(quantize_mmdit="w4a8" if mode == "flux-w4a8" else False, **base)
        cfg = cfgs.FLUX_SCHNELL
        txt, latent, cfg_weight = 256, (128, 128), 0.0
        model = init_mmdit(cfg, gen, device, quantize_bits=4)
    else:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    pipe.mmdit = model  # w4a8: the packed model passes through and gains its wscale
    rows = 2 if cfg_weight > 1 else 1
    cond = torch.randn(rows, txt, cfg.token_level_text_embed_dim, generator=gen, device=device)
    pooled = torch.randn(rows, cfg.pooled_text_embed_dim, generator=gen, device=device)
    kw = dict(cfg_weight=cfg_weight, latent_size=latent, seed=seed)
    return pipe, cond.to(cfg.dtype), pooled.to(cfg.dtype), kw


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(mode: str = "sd3", out_path: Optional[str] = None, n_steps: int = N_STEPS,
        device: str = "cuda", activities=None, built=None) -> dict:
    """Profile ``n_steps`` denoise steps of ``mode`` (module docstring) and
    write the report to ``out_path`` (if given). ``activities`` defaults to
    the CPU and CUDA on the card, the CPU alone elsewhere; without CUDA the
    categories are the CPU ops'. ``built`` is ``build``'s result, to profile
    a pipeline the caller holds."""
    from torch.profiler import ProfilerActivity, profile

    if device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device (pass --device cpu for the plain "
                         "versions)")
    pipe, cond, pooled, kw = built or build(mode, device)
    if activities is None:
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [])
    on_device = ProfilerActivity.CUDA in activities
    pipe.denoise_latents(cond, pooled, num_steps=n_steps, **kw)  # warm-up, the capture
    _sync(device)
    t0 = time.perf_counter()
    pipe.denoise_latents(cond, pooled, num_steps=n_steps, **kw)
    _sync(device)
    wall = 1e3 * (time.perf_counter() - t0) / n_steps
    with profile(activities=activities) as prof:
        pipe.denoise_latents(cond, pooled, num_steps=n_steps, **kw)
        _sync(device)
    cats = by_category(prof, n_steps, on_device)
    total = sum(cats.values())
    report = {
        "mode": mode, "device": (torch.cuda.get_device_name(0) if on_device
                                 else "cpu (host ops; the plain versions)"),
        "events": "device kernels" if on_device else "cpu ops",
        "n_steps": n_steps, "use_scan": pipe.use_scan,
        "wall_ms_per_step": wall,
        "device_total_ms_per_step": total,
        "by_category_ms_per_step": cats,
        "idle_share": 1 - total / wall,
        "top_kernels": top_kernels(prof, n_steps, on_device),
    }
    if on_device:
        report["by_family_ms_per_step"] = device_split(prof, n_steps)[0]
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
    return report


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="sd3", choices=MODES)
    ap.add_argument("out", nargs="?", default=None,
                    help="the report's JSON file (default profile_<mode>.json)")
    ap.add_argument("--steps", type=int, default=N_STEPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    out = args.out or f"profile_{args.mode}.json"
    report = run(args.mode, out, args.steps, args.device)
    print(json.dumps({k: report[k] for k in ("mode", "device", "wall_ms_per_step",
                                             "device_total_ms_per_step",
                                             "by_category_ms_per_step", "idle_share")},
                     indent=1), flush=True)
    print("full report:", out, flush=True)
    return report


if __name__ == "__main__":
    main()
