"""SmoothQuant activation-outlier folding for the w8a8 T5 encoder.

Counterpart of ``diffusionkit_tpu/ops/smoothquant.py``. The w8a8 T5
(``FluxPipeline(quantize_t5=True)``) quantizes activations per token; T5's
residual stream carries a few large channels that would size every row's
scale. The fold (SmoothQuant, arXiv:2211.10438) moves per-channel range from
the activations into the weights by the exact identity ``y @ W = (y / s) @
(s * W)``:

  site   input                    x / s folded into         s * W folded into
  qkv    rms_norm(x, ln1)         ln1.weight                q/k/v input columns
  wi     rms_norm(x, ln2)         ln2.weight                wi_0/wi_1 input columns
  o      attention(v-mix)         value_proj output rows    out_proj input columns
  wo     gelu(wi_0 y) * (wi_1 y)  wi_1 output rows          wo input columns

with ``s_j = amax(x_j)^alpha / amax(W_j)^(1 - alpha)`` (alpha 0.5), scaled to
geometric mean 1 and clipped to [1e-3, 1e3]. The per-channel activation
statistics come from a calibration forward of fixed prompts through a plain
fp32 mirror of the encoder (no quantization, tanh GELU, unscaled scores).

The reference computes all of this in host numpy on a stacked tree, which
for T5-XXL means ~19 GB of fp32 host copies. Here it runs per layer, in
fp32, on the module's own device, and folds into the module in place: the
same math, the same prompts and the same deterministic token fallback.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.t5 import T5Encoder

# The reference's calibration prompts (ops/smoothquant.py:52), unchanged.
CALIBRATION_PROMPTS = [
    "a photo of an astronaut riding a horse on mars",
    "High quality photo of a dog playing chess, 35mm, detailed",
    "3 red cubes stacked on a glass table near the ocean at sunset",
    "an oil painting in the style of the old masters; chiaroscuro!",
    "portrait photography, golden hour, 85mm f/1.4, sharp focus",
    "isometric pixel art of a cozy coffee shop interior",
    "the quick brown fox jumps over the lazy dog 0123456789",
    "a serene japanese garden with koi pond and maple trees",
]


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = (x * x).mean(dim=-1, keepdim=True)
    return x / torch.sqrt(var + eps) * w


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x**3)))


def _colmax(t: torch.Tensor) -> torch.Tensor:
    return t.abs().reshape(-1, t.shape[-1]).amax(dim=0)


@torch.no_grad()
def t5_calibration_stats_host(model: T5Encoder,
                              tokens: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
    """Per-channel absmax of the four quantized-linear input sites of every
    layer, from an fp32 forward of ``tokens`` (B, S) (the reference's
    ``t5_calibration_stats_host``, run on the model's device one layer at a
    time). Returns ``[{"qkv": (d,), "o": (inner,), "wi": (d,), "wo":
    (d_ff,)}] * L``."""
    cfg = model.config
    eps, nh = cfg.layer_norm_epsilon, cfg.num_heads
    b, s = tokens.shape
    x = model.wte.weight[tokens].float()
    bias = model.position_bias(s)[None]  # (1, H, S, S) fp32

    def lin(t, layer):
        return t @ layer.weight.float().t()

    def heads(t):
        return t.reshape(b, s, nh, -1).transpose(1, 2)

    stats = []
    for layer in model.layers:
        y1 = _rms_norm(x, layer.ln1.weight.float(), eps)
        q, k, v = (heads(lin(y1, p)) for p in (layer.query_proj, layer.key_proj,
                                                layer.value_proj))
        scores = q @ k.transpose(-1, -2) + bias  # unscaled (T5)
        scores = scores - scores.amax(dim=-1, keepdim=True)
        p = torch.exp(scores)
        p = p / p.sum(dim=-1, keepdim=True)
        o_in = (p @ v).transpose(1, 2).reshape(b, s, -1)
        x = x + lin(o_in, layer.out_proj)
        y2 = _rms_norm(x, layer.ln2.weight.float(), eps)
        h = _gelu_tanh(lin(y2, layer.wi_0)) * lin(y2, layer.wi_1)
        x = x + lin(h, layer.wo)
        stats.append({"qkv": _colmax(y1), "o": _colmax(o_in), "wi": _colmax(y2),
                      "wo": _colmax(h)})
    return stats


def _scales(act_amax: torch.Tensor, w_rowmax: torch.Tensor, alpha: float) -> torch.Tensor:
    s = act_amax.clamp_min(1e-5) ** alpha / w_rowmax.clamp_min(1e-5) ** (1.0 - alpha)
    # Geometric mean 1: the identity holds for any positive s, and centring
    # keeps the folded weights' and norms' magnitudes in range.
    s = s / torch.exp(torch.log(s).mean())
    return s.clamp(1e-3, 1e3)


@torch.no_grad()
def smoothquant_fold_t5_host(model: T5Encoder, stats: List[Dict[str, torch.Tensor]],
                             alpha: float = 0.5) -> T5Encoder:
    """Fold the calibration scales into ``model`` in place (the reference's
    ``smoothquant_fold_t5_host``, in the same order): each layer's weights
    are folded as fp32 copies and written back in their own dtype. Input
    columns of a torch (out, in) weight are the reference kernel's rows."""
    for layer, st in zip(model.layers, stats):
        ln1, ln2 = layer.ln1.weight.float(), layer.ln2.weight.float()
        q, k, v, o, wi0, wi1, wo = (p.weight.float() for p in (
            layer.query_proj, layer.key_proj, layer.value_proj, layer.out_proj, layer.wi_0,
            layer.wi_1, layer.wo))

        def inmax(w):  # max over the outputs of each input channel
            return w.abs().amax(dim=0)

        s = _scales(st["qkv"], torch.maximum(torch.maximum(inmax(q), inmax(k)), inmax(v)), alpha)
        ln1 = ln1 / s
        q, k, v = q * s[None, :], k * s[None, :], v * s[None, :]
        s = _scales(st["o"], inmax(o), alpha)
        v = v / s[:, None]
        o = o * s[None, :]
        s = _scales(st["wi"], torch.maximum(inmax(wi0), inmax(wi1)), alpha)
        ln2 = ln2 / s
        wi0, wi1 = wi0 * s[None, :], wi1 * s[None, :]
        s = _scales(st["wo"], inmax(wo), alpha)
        wi1 = wi1 / s[:, None]
        wo = wo * s[None, :]
        layer.ln1.weight.copy_(ln1)
        layer.ln2.weight.copy_(ln2)
        for p, w in zip((layer.query_proj, layer.key_proj, layer.value_proj, layer.out_proj,
                         layer.wi_0, layer.wi_1, layer.wo), (q, k, v, o, wi0, wi1, wo)):
            p.weight.copy_(w)
    return model


def calibration_tokens(vocab_size: int, tokenizer=None,
                       prompts: Optional[List[str]] = None) -> np.ndarray:
    """(8, width) int32 calibration batch, as the reference's ``smooth_t5``
    makes it: each prompt's tokens cut to 64, or with no tokenizer 48 draws
    of ``RandomState(0).randint(1, vocab)`` per prompt; rows right-padded
    with repeats of their own tokens."""
    prompts = prompts or CALIBRATION_PROMPTS
    if tokenizer is not None:
        rows = [list(tokenizer.tokenize(p))[:64] for p in prompts]
    else:
        rs = np.random.RandomState(0)
        rows = [list(rs.randint(1, vocab_size, size=48)) for _ in prompts]
    width = max(len(r) for r in rows)
    return np.stack([np.asarray((r * ((width // len(r)) + 1))[:width], np.int32) for r in rows])


def smooth_t5(model: T5Encoder, tokenizer=None, alpha: float = 0.5,
              prompts: Optional[List[str]] = None) -> T5Encoder:
    """Calibrate and fold, in place on the model's device (the reference's
    ``smooth_t5``). ``tokenizer``: anything with ``tokenize(str) ->
    List[int]``, or None for the deterministic token fallback."""
    tokens = calibration_tokens(model.wte.weight.shape[0], tokenizer, prompts)
    tokens = torch.from_numpy(tokens.astype(np.int64)).to(model.wte.weight.device)
    stats = t5_calibration_stats_host(model, tokens)
    return smoothquant_fold_t5_host(model, stats, alpha)
