"""The kernels' launch counters, read and moved as one.

Every wrapper of a hand-written kernel counts its launches in attributes
of its own function object: ``launches`` and, where a wrapper has more
than one kernel, ``gemv_launches``, ``mat_launches``,
``quantizing_launches`` or the per-mode dict ``mode_launches``, and where
it has an fp32 form, ``f32_launches`` (an fp32-upcast block's calls). The
wrappers count in Python, where they launch, so a CUDA graph's replay,
which launches the captured kernels without running Python, counts
nothing. ``snapshot`` reads every counter, ``delta`` takes the difference
of two readings (what a capture recorded) and ``add`` adds a difference
back, once for each replay: the counters then read what the same steps
would have counted eagerly.

The counters are looked up by name at each call, never held, since a
caller may rebind them (``chip_smoke.reset_counts`` gives
``mode_launches`` a fresh dict).
"""

from __future__ import annotations

from typing import Dict, Tuple

Counts = Dict[Tuple[str, str], object]


def wrappers() -> dict:
    """The counting wrappers, by name."""
    from . import flash_attention, fused_quant, gptq, int4_matmul, w4a8_matmul

    return {
        "flash_attention_bshd": flash_attention.flash_attention_bshd,
        "flash_attention": flash_attention.flash_attention,
        "flash_attention_stats": flash_attention.flash_attention_stats,
        "mod_ln": fused_quant.mod_ln,
        "mod_ln_quantize": fused_quant.mod_ln_quantize,
        "quantize": fused_quant.quantize,
        "gelu_quantize": fused_quant.gelu_quantize,
        "int4_matmul": int4_matmul.int4_matmul,
        "int8_matmul": int4_matmul.int8_matmul,
        "w4a8_matmul": w4a8_matmul.w4a8_matmul,
        "w8_matmul": w4a8_matmul.w8_matmul,
        "dequant_w8": w4a8_matmul.dequant_w8,
        "int8_dot": w4a8_matmul.int8_dot,
        "gptq_group": gptq.gptq_group,
    }


def snapshot() -> Counts:
    """Every counter now: {(wrapper, attribute): int or {key: int}}."""
    out: Counts = {}
    for name, fn in wrappers().items():
        for attr, value in vars(fn).items():
            if attr == "launches" or attr.endswith("_launches"):
                out[(name, attr)] = dict(value) if isinstance(value, dict) else value
    return out


def delta(before: Counts, after: Counts) -> Counts:
    """``after`` less ``before``, counter by counter (and key by key)."""
    out: Counts = {}
    for key, value in after.items():
        old = before.get(key, {} if isinstance(value, dict) else 0)
        if isinstance(value, dict):
            out[key] = {k: v - old.get(k, 0) for k, v in value.items()}
        else:
            out[key] = value - old
    return out


def add(counts: Counts, times: int = 1) -> None:
    """Add ``times`` x ``counts`` (a ``delta``) to the live counters."""
    fns = wrappers()
    for (name, attr), value in counts.items():
        fn = fns[name]
        if isinstance(value, dict):
            live = getattr(fn, attr)
            for k, v in value.items():
                live[k] = live.get(k, 0) + times * v
        else:
            setattr(fn, attr, getattr(fn, attr) + times * value)
