"""Random weights drawn from the run's seed, on the device, in a few large calls.

The initialisation follows the port's random builders at commit c82efae
(``models/mmdit.init_mmdit``, ``models/clip.init_clip``, ``models/t5.init_t5``,
``models/vae._init_random``, ``ops/quantized.random_quantized_linear_``),
the pattern ``chip_smoke.py``'s ``build_sd3`` / ``build_flux_w4a8`` use:

- transformer weights (MMDiT, CLIP, T5, embeddings) ~ N(0, 0.02), biases 0,
  LayerNorm / RMSNorm / GroupNorm weights 1 and biases 0, QK-norm scales 1;
- VAE convolutions and linears ~ N(0, 1 / sqrt(fan_in)), biases 0;
- packed int4 block linears: uniform random 32-bit words, ``scale = 2 *
  0.02 / 15`` and ``zero = -0.02`` everywhere (w uniform on [-0.02, 0.02]).

The values are drawn here, by the benchmark, and not by the program: a
state dict of views into one flat buffer a (dtype, rule), each buffer
filled by one call of a ``torch.Generator`` on the device. The program's
modules take them by ``load_state_dict(assign=True)``; the plain reference
draws the same dict again from the same seed after the window.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

STD = 0.02

Rule = Tuple  # ("normal", std) | ("fill", value) | ("bits32",)


def transformer_rule(name: str, t: torch.Tensor) -> Rule:
    """MMDiT, CLIP and T5 leaves: norms' weights and QK scales 1, biases 0,
    packed int4 words random, their affine constant, the rest N(0, 0.02)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("q_scale", "k_scale"):
        return ("fill", 1.0)
    if leaf == "q4":
        return ("bits32",)
    if leaf == "scales":
        return ("fill", 2 * STD / 15)
    if leaf == "zeros":
        return ("fill", -STD)
    if leaf == "bias":
        return ("fill", 0.0)
    if t.ndim == 1:  # LayerNorm / RMSNorm weights
        return ("fill", 1.0)
    if any(k in name for k in ("embedding", "wte", "pos_embed", "relative_attention_bias")):
        # tables apart from the linears, whose buffer a conversion frees
        return ("normal", STD, "table")
    return ("normal", STD)


def vae_rule(name: str, t: torch.Tensor) -> Rule:
    """VAE leaves: GroupNorm identity, biases 0, convolutions and linears
    N(0, 1 / sqrt(fan_in))."""
    if name.endswith("bias"):
        return ("fill", 0.0)
    if t.ndim == 1:
        return ("fill", 1.0)
    fan_in = t[0].numel()
    return ("normal", fan_in ** -0.5)


def spec_of(meta_state: Dict[str, torch.Tensor]) -> List[Tuple[str, tuple, torch.dtype]]:
    """(name, shape, dtype) of a module's state dict built on the meta
    device: only the structure, no values."""
    return [(n, tuple(t.shape), t.dtype) for n, t in meta_state.items()]


def draw(spec: List[Tuple[str, tuple, torch.dtype]], rule: Callable[[str, torch.Tensor], Rule],
         gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The state dict of ``spec`` drawn from ``gen``: the leaves grouped by
    (dtype, rule) in order of first appearance, each group one flat buffer
    filled by one call, the leaves views into it."""
    groups: Dict[tuple, List[Tuple[str, tuple]]] = {}
    for name, shape, dtype in spec:
        key = (dtype, rule(name, torch.empty(shape, dtype=dtype, device="meta")))
        groups.setdefault(key, []).append((name, shape))
    out: Dict[str, torch.Tensor] = {}
    for (dtype, r), leaves in groups.items():
        total = sum(torch.Size(s).numel() for _, s in leaves)
        flat = torch.empty(total, dtype=dtype, device=device)
        if r[0] == "normal":
            flat.normal_(0.0, r[1], generator=gen)
        elif r[0] == "bits32":
            flat.random_(-(2**31), 2**31, generator=gen)
        else:
            flat.fill_(r[1])
        off = 0
        for name, shape in leaves:
            n = torch.Size(shape).numel()
            out[name] = flat[off:off + n].view(shape)
            off += n
    return out


def generator(seed: int, salt: int, device) -> torch.Generator:
    """The generator of one model of a run: ``seed`` and a fixed salt a
    model, so models draw independent streams."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1009 + salt) % (2**63))
