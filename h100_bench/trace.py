"""Reading the profiler's trace: busy and idle seconds, the breakdown, and
the device time of the linear and attention kernels in each span.

``family`` is a frozen copy of the kernel map of
``diffusionkit_tpu_torch/tools/profile_step.py`` at commit c82efae. A later
PR whose program runs a kernel this map does not know adds its name to
``kernels/<anything>.json`` (``{"family": {"substring": "family name"}}``);
the map reads every such file, for the kernels the frozen map leaves as
"other" alone, so that a data file cannot move a kernel it already sorts.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Tuple

from spans import MARKER_KERNEL

HERE = Path(__file__).resolve().parent

SCALE_FIRST = re.compile(r"flash_fwd_(?:wide|sm90)(?:<\d+, true>|ILi\d+ELb1E)"
                         r"|flash_(?:fwd_wide_sm90|wide_merge)(?:<true>|ILb1E)")
FP32_MODE = re.compile(r"flash_fwd_(?:f32|3xtf32(?:_sm90)?)"
                       r"(?:<(?:\d+, )?(\d)>|I(?:Li\d+E)?Li(\d)E)")
INT8_DOT_KERNEL = re.compile(r"w8_mm(?:_sm90)?(?:_k64)?(?:<int[,>]|Ii[LE])")
GEMV_KERNEL = re.compile(r"(int4|int8|w4a8|w8)_gemv")
F32_TILE = re.compile(r"dequant_mm_(?:f32|3xtf32)(?:<|ILi)(\d)")
F32_GEMV = re.compile(r"dequant_gemv_f32(?:<|ILi)(\d)")
ATTENTION = ("flash_attention_bshd", "flash_attention", "flash_attention_stats")
# The d = 512 flash kernels (the VAE's one-head attention), apart from the
# joint attention's.
WIDE = re.compile(r"flash_fwd_wide|flash_wide_merge")


def _extra_families(folder: Path = HERE / "kernels") -> Dict[str, str]:
    out: Dict[str, str] = {}
    for path in sorted(folder.glob("*.json")) if folder.exists() else []:
        out.update(json.loads(path.read_text())["family"])
    return out


EXTRA = _extra_families()


def family(name: str) -> str:
    """The kernel family of a profiler row: the frozen map's, else the first
    ``kernels/*.json`` substring that the name holds, else "other"."""
    fam = _frozen_family(name)
    if fam != "other":
        return fam
    for sub, extra in EXTRA.items():
        if sub in name:
            return extra
    return fam


def _frozen_family(name: str) -> str:
    """``profile_step.family`` at c82efae."""
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
    if "quantize_kernel" in name:
        return "quantize"
    if "mod_ln" in name:
        return "mod_ln"
    if "int4_mm" in name:
        return "int4_matmul"
    if "nvjet" in name or "gemm" in name:
        return "gemm"
    return "other"


# The kernels that compute the step's linear layers, whatever implements
# them: the library's GEMMs, C, #13, E, #10, #11, #16 and their GEMVs, and
# the quantizers that feed them (A', D, #4).
LINEAR_FAMILIES = ("gemm", "int4_matmul", "int8_matmul", "w4a8_matmul", "w8_matmul",
                   "dequant_w8", "int8_dot", "int4_matmul[gemv]", "int8_matmul[gemv]",
                   "w4a8_matmul[gemv]", "w8_matmul[gemv]", "int4_matmul[f32]",
                   "int8_matmul[f32]", "int4_matmul[f32-gemv]", "int8_matmul[f32-gemv]",
                   "mod_ln_quantize", "quantize", "gelu_quantize", "gelu_quant[tiles]")


def is_linear(name: str) -> bool:
    return family(name) in LINEAR_FAMILIES


def is_joint_attention(name: str) -> bool:
    return family(name) in ATTENTION and not WIDE.search(name)


def device_events(prof) -> List[Tuple[str, float, float]]:
    """(name, start s, end s) of every device-side activity (kernels,
    copies, memsets), in start order."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            out.append((ev.name, ev.time_range.start / 1e6, ev.time_range.end / 1e6))
    out.sort(key=lambda e: e[1])
    return out


def busy_and_gaps(dev: List[Tuple[str, float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """Seconds in which some device activity ran, and the gaps between."""
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for _, s, e in dev:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def breakdown(dev, gaps, markers: List[str], n: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle gaps
    by the span the host was in (the last marker kernel before the gap:
    a text encoder, the denoise, the VAE, or between iterations)."""
    by_name: Dict[str, float] = {}
    for name, s, e in dev:
        if MARKER_KERNEL in name:
            continue
        by_name[name[:120]] = by_name.get(name[:120], 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    edges = [(s, markers[k] if k < len(markers) else "marker")
             for k, (s, _) in enumerate((s, e) for name, s, e in dev if MARKER_KERNEL in name)]
    labelled = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        before = [lab for t, lab in edges if t <= s]
        span = _span_after(before[-1]) if before else None
        where = {None: "between iterations", "iter": "between iterations"}.get(span, span)
        if not markers:
            where = "the open loop"
        labelled.append([f"host, {where} (at +{s - dev[0][1]:.3f} s)", e - s])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": labelled}


def _span_after(label: str):
    """The span a marker opens: its kind at a ``pre`` edge, ``denoise``
    after a text encoder's or the VAE encoder's end, else none."""
    kind, edge = label.rsplit("_", 1)
    if edge == "pre":
        return None if kind == "iter" else kind
    return "denoise" if kind in ("text", "vae_encode") else None


def span_of_kernels(dev, markers: List[str]) -> List[Tuple[str, str, float]]:
    """(span, name, seconds) of every device activity: the span is the
    kind of the last marker kernel before it (``denoise`` after a text or
    VAE-encode span's end). Activities before the first marker are left
    out."""
    out = []
    span = None
    k = 0
    for name, s, e in dev:
        if MARKER_KERNEL in name:
            span = _span_after(markers[k]) if k < len(markers) else None
            k += 1
            continue
        if span is not None:
            out.append((span, name, e - s))
    return out


def summarize(prof, markers: List[str], window_s: float) -> Dict:
    """Everything the per-layer readers take from one profiled window."""
    dev = device_events(prof)
    busy, gaps = busy_and_gaps(dev)
    spans = span_of_kernels(dev, markers)
    n_markers = sum(MARKER_KERNEL in d[0] for d in dev)
    seconds: Dict[str, float] = {}
    for span, name, dt in spans:
        seconds[span] = seconds.get(span, 0.0) + dt
        if span == "denoise":
            if is_linear(name):
                seconds["denoise.linear"] = seconds.get("denoise.linear", 0.0) + dt
            if is_joint_attention(name):
                seconds["denoise.attention"] = seconds.get("denoise.attention", 0.0) + dt
    return {"busy_s": busy, "window_s": window_s, "span_device_s": seconds,
            "markers_seen": n_markers, "markers_sent": len(markers),
            "breakdown": breakdown(dev, gaps, markers) if dev else None}
