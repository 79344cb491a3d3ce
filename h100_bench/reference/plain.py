"""The plain reference: SD3 and FLUX text-to-image and image-to-image in
plain PyTorch, float32, no kernels, no cache, no batching tricks.

It imports neither JAX nor anything of the program. It reads the raw
weights the benchmark drew (``weights.draw``: a state dict under the port's
parameter names, the layout of a checkpoint) and works out again whatever
the program derives from them: w4a8's per-channel int8 grid (``wscale``),
the SmoothQuant fold of the w8a8 T5 and its int8 grids. The layer
equations follow the published models (SD3: arXiv:2403.03206; FLUX.1:
black-forest-labs/flux; T5 v1.1; CLIP) as the repository implements them,
with these departures, each shared with the program: the tokenizers are
the character-level stand-ins (no tokenizer files on the card); SD3 runs
without T5 (its 77 rows zero), as the program's main path does.

Every float product is fp32 with TF32 off, unless ``Precision`` says
otherwise. ``Precision`` is also the control: ``"fp8"`` rounds every
product's operands to float8 e4m3 (per-row scales, the step below bf16);
``"fp8a4"`` also quantizes the quantized linears' activations to 4 bits
(the step below int8); a float32 model drops to TF32. Attention is
computed in blocks of heads, so it fits.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

W = Dict[str, torch.Tensor]

SD3_LATENT = (1.5305, 0.0609)
FLUX_LATENT = (0.3611, 0.1159)
EMPTY_LATENT = 0.0609
SCALE_TILE = 512  # the w4a8 FFN hidden's quantisation tile

# The SmoothQuant calibration prompts of the w8a8 T5 (arXiv:2211.10438;
# the repository's ops/smoothquant.py:33).
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


class _TF32:
    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        exact_fp32()


def exact_fp32() -> None:
    """No TF32 anywhere: the reference's products are fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Precision:
    """How the reference rounds: ``"fp32"`` (the reference), ``"fp8"`` (every
    float product's operands on float8 e4m3 with per-row scales: a bf16
    configuration one step down), ``"fp8a4"`` (also the quantized linears'
    activations on a 4-bit grid: bf16 and int8 parts one step down),
    ``"bf16"`` (every float product's operands rounded to bfloat16: the
    configuration's own precision, a reading of how far rounding alone
    carries the images) or ``"tf32"`` (fp32 on TF32 tensor cores: the step
    below a float32 model, ``for_model``)."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8", "fp8a4", "bf16", "tf32"):
            raise ValueError(f"precision {mode!r}")
        self.mode = mode
        self.fp8 = mode in ("fp8", "fp8a4")
        self.bf16 = mode == "bf16"
        self.act_levels = 7.0 if mode == "fp8a4" else 127.0

    def for_model(self, dtype: str) -> "Precision":
        """The precision of a model the configuration states in ``dtype``:
        a control lowers a float32 model one step, to TF32 (``"tf32"``:
        the products on TF32 tensor cores), and a bf16 one by its mode."""
        if dtype == "float32" and self.mode != "fp32":
            return Precision("tf32")
        return self

    def tf32(self):
        """A context in which the products run on TF32 when the mode says so."""
        return _TF32(self.mode == "tf32")

    def op(self, t: torch.Tensor) -> torch.Tensor:
        """An operand of a float product."""
        if self.bf16:
            return t.to(torch.bfloat16).float()
        if not self.fp8:
            return t
        amax = t.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
        s = amax / 448.0
        return (t / s).to(torch.float8_e4m3fn).float() * s

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., K) @ w (N, K)^T."""
        return self.op(x) @ self.op(w).t()


# -- tokenizers (the character-level stand-ins) ------------------------------

def clip_tokens(text: str, pad_with_eos: bool, max_length: int = 77) -> List[int]:
    """The synthetic CLIP vocabulary: printable ASCII then space, each also
    as its end-of-word form, then BOS and EOS; a word tokenizes to its
    characters, the last in its end-of-word form. Prompts of lowercase
    letters and spaces only."""
    chars = [chr(c) for c in range(33, 127)] + [" "]
    idx = {c: i for i, c in enumerate(chars)}
    bos, eos = 2 * len(chars), 2 * len(chars) + 1
    ids = []
    for word in text.lower().split():
        if not word.isalpha() or not word.isascii():
            raise ValueError(f"prompt word {word!r}: lowercase letters only")
        ids += [idx[c] for c in word[:-1]] + [len(chars) + idx[word[-1]]]
    ids = [bos] + ids[: max_length - 2] + [eos]
    return ids + [eos if pad_with_eos else 0] * (max_length - len(ids))


def t5_tokens(text: str, length: int, vocab: int = 32128) -> List[int]:
    """One id a character (3 + code mod (vocab - 3)), EOS 1, padding 0."""
    ids = [3 + ord(c) % (vocab - 3) for c in text[: length - 1]] + [1]
    return ids + [0] * (length - len(ids))


# -- layers -----------------------------------------------------------------

def linear(P: Precision, x, w: W, name: str) -> torch.Tensor:
    y = P.mm(x, w[name + ".weight"].float())
    b = w.get(name + ".bias")
    return y if b is None else y + b.float()


def layer_norm(x, eps: float, weight=None, bias=None) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    xc = x - mean
    y = xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.float() + bias.float()
    return y


def rms_norm(x, weight, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * weight.float()


def fake_quant_rows(x: torch.Tensor, levels: float, tile: Optional[int] = None) -> torch.Tensor:
    """Symmetric per-row (or per row and ``tile`` columns) quantisation to
    ``levels`` a side, returned dequantised: round-half-even of x / (amax /
    levels), clipped."""
    shape = x.shape
    if tile is not None:
        x = x.reshape(*shape[:-1], shape[-1] // tile, tile)
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / levels
    y = torch.round(x / s).clamp_(-levels, levels) * s
    return y.reshape(shape)


def attention(P: Precision, q, k, v, scale: float, heads_per_block: int = 8) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, S, H, D), H in blocks."""
    outs = []
    for h0 in range(0, q.shape[2], heads_per_block):
        sl = slice(h0, h0 + heads_per_block)
        qh, kh, vh = (t[:, :, sl].transpose(1, 2) for t in (q, k, v))
        s = (P.op(qh) @ P.op(kh).transpose(-1, -2)) * scale
        p = torch.softmax(s, dim=-1)
        outs.append((P.op(p) @ P.op(vh.transpose(-1, -2)).transpose(-1, -2)).transpose(1, 2))
    return torch.cat(outs, dim=2)


def gelu(x):
    return F.gelu(x)


def timestep_embedding(t: torch.Tensor, dim: int = 256, max_period: float = 10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# -- CLIP --------------------------------------------------------------------

def clip(P: Precision, w: W, tokens: torch.Tensor, heads: int, act: str):
    """(penultimate hidden state, pooled output) of token ids (B, 77)."""
    b, n = tokens.shape
    x = w["token_embedding.weight"].float()[tokens] + w["position_embedding.weight"].float()[:n]
    mask = torch.full((n, n), float("-inf"), device=x.device).triu(1)
    layers = sorted({int(k.split(".")[1]) for k in w if k.startswith("layers.")})
    hidden = []
    for i in layers:
        p = f"layers.{i}."
        y = layer_norm(x, 1e-5, w[p + "ln1.weight"], w[p + "ln1.bias"])
        c = x.shape[-1]
        d = c // heads
        q, k, v = (linear(P, y, w, p + n_).reshape(b, n, heads, d)
                   for n_ in ("query_proj", "key_proj", "value_proj"))
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        s = (P.op(qh) @ P.op(kh).transpose(-1, -2)) / math.sqrt(d) + mask
        o = (P.op(torch.softmax(s, dim=-1)) @ P.op(vh.transpose(-1, -2)).transpose(-1, -2))
        x = x + linear(P, o.transpose(1, 2).reshape(b, n, c), w, p + "out_proj")
        y = layer_norm(x, 1e-5, w[p + "ln2.weight"], w[p + "ln2.bias"])
        h = linear(P, y, w, p + "linear1")
        h = h * torch.sigmoid(1.702 * h) if act == "quick_gelu" else gelu(h)
        x = x + linear(P, h, w, p + "linear2")
        hidden.append(x)
    x = layer_norm(x, 1e-5, w["final_layer_norm.weight"], w["final_layer_norm.bias"])
    pooled = x[torch.arange(b, device=x.device), tokens.argmax(dim=-1)]
    if "text_projection.weight" in w:
        pooled = linear(P, pooled, w, "text_projection")
    return hidden[-2], pooled


# -- T5-XXL, w8a8 after the SmoothQuant fold ------------------------------------

def _t5_bias(w: W, s: int, heads: int, device) -> torch.Tensor:
    """(heads, S, S) relative-position bias: bidirectional buckets (32,
    max distance 128), as HF T5 computes them (numpy, fp32 logs)."""
    rel = np.arange(s)[None, :] - np.arange(s)[:, None]
    nb, exact = 16, 8
    bucket = (rel > 0).astype(np.int32) * nb
    rel = np.abs(rel)
    scale = (nb - exact) / np.log(128 / exact)
    large = exact + (np.log(np.maximum(rel, 1).astype(np.float32) / exact)
                     * scale).astype(np.int32)
    bucket = bucket + np.where(rel < exact, rel, np.minimum(large, nb - 1))
    table = w["relative_attention_bias.weight"].float()
    idx = torch.from_numpy(bucket.astype(np.int64)).to(device)
    return table[idx].permute(2, 0, 1)


def _t5_layer_float(w: W, i: int) -> Dict[str, torch.Tensor]:
    p = f"layers.{i}."
    names = ("query_proj", "key_proj", "value_proj", "out_proj", "wi_0", "wi_1", "wo")
    out = {n: w[p + n + ".weight"].float() for n in names}
    out["ln1"], out["ln2"] = w[p + "ln1.weight"].float(), w[p + "ln2.weight"].float()
    return out


def _t5_forward_layer(P: Precision, L: Dict[str, torch.Tensor], x, bias, heads: int,
                      quant: bool, stats: Optional[dict] = None):
    """One T5 layer on the fp32 residual stream. ``quant``: the w8a8 forms
    (the quantized linears' activations on their int8 grids per row);
    ``stats``: record each quantized site's per-channel input absmax."""
    b, s, _ = x.shape
    lv = P.act_levels

    def q_in(t, site):
        if stats is not None:
            stats[site] = t.abs().reshape(-1, t.shape[-1]).amax(dim=0)
        return fake_quant_rows(t, lv) if quant else t

    y = q_in(rms_norm(x, L["ln1"]), "qkv")
    q, k, v = (P.mm(y, L[n]).reshape(b, s, heads, -1).transpose(1, 2)
               for n in ("query_proj", "key_proj", "value_proj"))
    scores = P.op(q) @ P.op(k).transpose(-1, -2) + bias[None]
    o = P.op(torch.softmax(scores, dim=-1)) @ P.op(v.transpose(-1, -2)).transpose(-1, -2)
    o = q_in(o.transpose(1, 2).reshape(b, s, -1), "o")
    x = x + P.mm(o, L["out_proj"])
    y = q_in(rms_norm(x, L["ln2"]), "wi")
    h = F.gelu(P.mm(y, L["wi_0"]), approximate="tanh") * P.mm(y, L["wi_1"])
    h = q_in(h, "wo")
    return x + P.mm(h, L["wo"])


def _smooth_scales(act: torch.Tensor, wmax: torch.Tensor) -> torch.Tensor:
    s = act.clamp_min(1e-5) ** 0.5 / wmax.clamp_min(1e-5) ** 0.5
    s = s / torch.exp(torch.log(s).mean())
    return s.clamp(1e-3, 1e3)


def _w8_grid(wt: torch.Tensor) -> torch.Tensor:
    """An (out, in) weight on its per-output-channel int8 grid,
    dequantised."""
    s = wt.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.round(wt / s).clamp_(-127, 127) * s


def t5_w8a8(P: Precision, w: W, tokens: torch.Tensor, heads: int = 64) -> torch.Tensor:
    """The w8a8 T5 encoder's output (B, S, d) for ``tokens``: the
    SmoothQuant fold (alpha 0.5, calibrated on ``CALIBRATION_PROMPTS``
    through the float encoder), every linear on its int8 grid, the
    activations quantized per row."""
    dev = tokens.device
    layers = sorted({int(k.split(".")[1]) for k in w if k.startswith("layers.")})
    emb = w["wte.weight"]
    rows = [([3 + ord(ch) % 32125 for ch in p[:255]] + [1])[:64] for p in CALIBRATION_PROMPTS]
    width = max(len(r) for r in rows)
    cal = torch.tensor([(r * (width // len(r) + 1))[:width] for r in rows], device=dev)
    xc = emb[cal].float()
    bias_c = _t5_bias(w, width, heads, dev)
    x = emb[tokens].float()
    bias = _t5_bias(w, tokens.shape[1], heads, dev)
    exact = Precision("fp32")
    for i in layers:
        L = _t5_layer_float(w, i)
        st: Dict[str, torch.Tensor] = {}
        xc_next = _t5_forward_layer(exact, L, xc, bias_c, heads, quant=False, stats=st)
        inmax = lambda t: t.abs().amax(dim=0)  # noqa: E731
        s = _smooth_scales(st["qkv"], torch.maximum(torch.maximum(
            inmax(L["query_proj"]), inmax(L["key_proj"])), inmax(L["value_proj"])))
        L["ln1"] = L["ln1"] / s
        for n in ("query_proj", "key_proj", "value_proj"):
            L[n] = L[n] * s[None, :]
        s = _smooth_scales(st["o"], inmax(L["out_proj"]))
        L["value_proj"] = L["value_proj"] / s[:, None]
        L["out_proj"] = L["out_proj"] * s[None, :]
        s = _smooth_scales(st["wi"], torch.maximum(inmax(L["wi_0"]), inmax(L["wi_1"])))
        L["ln2"] = L["ln2"] / s
        L["wi_0"], L["wi_1"] = L["wi_0"] * s[None, :], L["wi_1"] * s[None, :]
        s = _smooth_scales(st["wo"], inmax(L["wo"]))
        L["wi_1"] = L["wi_1"] / s[:, None]
        L["wo"] = L["wo"] * s[None, :]
        for n in ("query_proj", "key_proj", "value_proj", "out_proj", "wi_0", "wi_1", "wo"):
            L[n] = _w8_grid(L[n])
        x = _t5_forward_layer(P, L, x, bias, heads, quant=True)
        xc = xc_next
    return rms_norm(x, w["final_ln.weight"].float())


# -- the MMDiT ---------------------------------------------------------------

def _w4a8_weight(w: W, name: str) -> torch.Tensor:
    """A packed int4 linear's (N, K) weight on its w4a8 int8 grid,
    dequantised: w = q * scale + zero (fp32), wscale = max_k |w| / 127, the
    affine scaled by 1 / wscale, rounded half to even, clipped to 127."""
    q4 = w[name + ".q4"]
    k8, n = q4.shape
    shifts = torch.arange(0, 32, 4, dtype=torch.int32, device=q4.device)
    q = ((q4[:, None, :] >> shifts[None, :, None]) & 0xF).reshape(k8 * 8, n).float()
    scales, zeros = w[name + ".scales"].float(), w[name + ".zeros"].float()
    g = q.shape[0] // scales.shape[0]
    deq = q * scales.repeat_interleave(g, 0) + zeros.repeat_interleave(g, 0)
    wscale = deq.abs().amax(dim=0).clamp_min(1e-8) / 127.0
    rws = 1.0 / wscale
    grid = torch.round(q * (scales * rws).repeat_interleave(g, 0)
                       + (zeros * rws).repeat_interleave(g, 0)).clamp_(-127, 127)
    return (grid * wscale).t().contiguous()


class MMDiTRef:
    """The MMDiT of a configuration's ``mmdit`` group over the raw weights;
    ``quant`` "w4a8" takes the block linears as w4a8 (their weights on the
    int8 grid, their activations quantized per row, the FFN hidden per row
    and 512-column tile), else float."""

    def __init__(self, P: Precision, w: W, m: dict, quant: Optional[str]):
        self.P, self.w, self.m, self.quant = P, w, m, quant
        self._grid: Dict[str, torch.Tensor] = {}

    def lin(self, x, name: str, quantized: bool = True, tile: bool = False) -> torch.Tensor:
        w = self.w
        if self.quant == "w4a8" and quantized and name + ".q4" in w:
            if name not in self._grid:
                self._grid[name] = _w4a8_weight(w, name)
            xq = fake_quant_rows(x, self.P.act_levels, SCALE_TILE if tile else None)
            y = xq @ self._grid[name].t()
            b = w.get(name + ".bias")
            return y if b is None else y + b.float()
        return linear(self.P, x, w, name)

    def drop_grids(self) -> None:
        self._grid.clear()

    def mlp_silu(self, x, name):
        return self.lin(F.silu(self.lin(x, name + ".fc1", False)), name + ".fc2", False)

    def ffn(self, x, p):
        if self.quant == "w4a8":
            return self.lin(gelu(self.lin(x, p + "fc1")), p + "fc2", tile=True)
        return self.lin(gelu(self.lin(x, p + "fc1")), p + "fc2")

    def mods(self, c, p, n):
        return [t[:, None, :] for t in self.lin(F.silu(c), p + "ada").chunk(n, dim=-1)]

    def qkv(self, h, p, rope):
        m = self.m
        b, s, _ = h.shape
        d = m["hidden_size"] // m["num_heads"]
        q, k, v = (self.lin(h, p + n).reshape(b, s, -1, d) for n in ("q", "k", "v"))
        if p + "qk_norm.q_scale" in self.w:
            q = rms_norm(q, self.w[p + "qk_norm.q_scale"])
            k = rms_norm(k, self.w[p + "qk_norm.k_scale"])
        if rope is not None:
            cos, sin = (t[:, None, :] for t in rope)
            q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
        return q, k, v

    def forward(self, latent, ctx, pooled, timestep):
        m, w = self.m, self.w
        b, lh, lw, _ = latent.shape
        p = m["patch_size"]
        H = m["hidden_size"]
        d = H // m["num_heads"]
        flux = m["depth_unified"] > 0
        txt = self.lin(ctx, "context_embedder", False)
        x = self.lin(_patchify(latent, p), "x_embedder", False)
        h, wd = lh // p, lw // p
        rope = None
        if not flux:
            maxhw = int(round(w["pos_embed"].shape[0] ** 0.5))
            y0, x0 = (maxhw - h) // 2, (maxhw - wd) // 2
            pos = w["pos_embed"].float().reshape(maxhw, maxhw, H)
            x = x + pos[y0:y0 + h, x0:x0 + wd].reshape(1, h * wd, H)
        else:
            rope = _rope((h, wd), txt.shape[1], m["rope_axes_dim"], x.device)
        c = self.mlp_silu(timestep_embedding(timestep), "t_embedder") + \
            self.mlp_silu(pooled, "y_embedder")
        eps, scale = m["layer_norm_eps"], 1.0 / math.sqrt(d)
        n_mm = m["depth_multimodal"]
        for i in range(n_mm):
            final = not flux and i == n_mm - 1
            pre = "mm_final." if final else f"mm_blocks.{i}."
            im, tm = self.mods(c, pre + "img.", 6), self.mods(c, pre + "txt.", 2 if final else 6)
            ih = layer_norm(x, eps) * (1 + im[1]) + im[0]
            th = layer_norm(txt, eps) * (1 + tm[1]) + tm[0]
            lt = txt.shape[1]
            rope_img = None if rope is None else (rope[0][lt:], rope[1][lt:])
            qi, ki, vi = self.qkv(ih, pre + "img.", rope_img)
            qt, kt, vt = self.qkv(th, pre + "txt.", None)
            cat = (lambda a, b_: torch.cat([b_, a], 1)) if flux else \
                (lambda a, b_: torch.cat([a, b_], 1))
            o = attention(self.P, cat(qi, qt), cat(ki, kt), cat(vi, vt), scale).flatten(2)
            o_img, o_txt = (o[:, lt:], o[:, :lt]) if flux else (o[:, :x.shape[1]],
                                                                o[:, x.shape[1]:])
            x = x + im[2] * self.lin(o_img, pre + "img.o")
            x = x + im[5] * self.ffn(layer_norm(x, eps) * (1 + im[4]) + im[3], pre + "img.")
            if not final:
                txt = txt + tm[2] * self.lin(o_txt, pre + "txt.o")
                txt = txt + tm[5] * self.ffn(layer_norm(txt, eps) * (1 + tm[4]) + tm[3],
                                             pre + "txt.")
        if flux:
            u = torch.cat([txt, x], 1)
            for i in range(m["depth_unified"]):
                pre = f"uni_blocks.{i}."
                mo = self.mods(c, pre, 3)
                hh = layer_norm(u, eps) * (1 + mo[1]) + mo[0]
                q, k, v = self.qkv(hh, pre, rope)
                o = attention(self.P, q, k, v, scale).flatten(2)
                u = u + mo[2] * (self.lin(o, pre + "o") + self.ffn(hh, pre))
            x = u[:, txt.shape[1]:]
        shift, sc = (t[:, None, :] for t in self.lin(F.silu(c), "final_layer.ada",
                                                      False).chunk(2, dim=-1))
        x = self.lin(layer_norm(x, eps) * (1 + sc) + shift, "final_layer.linear", False)
        if flux:
            return _unpack_flux(x, (lh, lw), p)
        return _unpatchify_sd3(x, (lh, lw), p, m["vae_latent_dim"])


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([cos * x1 - sin * x2, sin * x1 + cos * x2], dim=-1)


def _rope(hw, txt_len: int, axes: Sequence[int], device):
    """(cos, sin) (S, head_dim / 2): text rows at position 0, then the
    image rows in row-major (y, x) order; axis i rotates its own slice."""
    h, w = hw
    pos = np.zeros((h, w, 3), np.float32)
    pos[..., 1] = np.arange(h, dtype=np.float32)[:, None]
    pos[..., 2] = np.arange(w, dtype=np.float32)[None, :]
    pos = np.concatenate([np.zeros((txt_len, 3), np.float32), pos.reshape(-1, 3)])
    ang = np.concatenate([pos[:, i:i + 1] * (1.0 / 10000.0 ** (np.arange(0, d, 2, dtype=np.float32)
                                                             / d))[None]
                          for i, d in enumerate(axes)], axis=-1)
    return torch.from_numpy(np.cos(ang)).to(device), torch.from_numpy(np.sin(ang)).to(device)


def _patchify(x, p):
    b, h, w, c = x.shape
    x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, (h // p) * (w // p), c * p * p)


def _unpack_flux(x, hw, p):
    b, _, f = x.shape
    h, w = hw[0] // p, hw[1] // p
    c = f // (p * p)
    return x.reshape(b, h, w, c, p, p).permute(0, 1, 4, 2, 5, 3).reshape(b, h * p, w * p, c)


def _unpatchify_sd3(x, hw, p, c):
    b = x.shape[0]
    h, w = hw[0] // p, hw[1] // p
    return x.reshape(b, h, w, p, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hw[0], hw[1], c)


# -- the VAE ------------------------------------------------------------------

def _gn(x, w: W, name: str, groups: int = 32):
    b, c, h, wd = x.shape
    x3 = x.reshape(b, groups, -1)
    mean = x3.mean(dim=-1, keepdim=True)
    var = ((x3 - mean) ** 2).mean(dim=-1, keepdim=True)
    y = ((x3 - mean) * torch.rsqrt(var + 1e-6)).reshape(b, c, h, wd)
    return y * w[name + ".weight"].float()[:, None, None] + w[name + ".bias"].float()[:, None, None]


def _conv(P: Precision, x, w: W, name: str, stride: int = 1, padding: int = 1):
    wt = w[name + ".weight"].float()
    if P.fp8 or P.bf16:
        x = P.op(x.transpose(1, -1)).transpose(1, -1)
        wt = P.op(wt.reshape(wt.shape[0], -1)).reshape(wt.shape)
    return F.conv2d(x, wt, w[name + ".bias"].float(), stride=stride, padding=padding)


def _resnet(P, x, w: W, p: str):
    y = _conv(P, F.silu(_gn(x, w, p + "norm1")), w, p + "conv1")
    y = _conv(P, F.silu(_gn(y, w, p + "norm2")), w, p + "conv2")
    if p + "conv_shortcut.weight" in w:
        x = linear(P, x.permute(0, 2, 3, 1), w, p + "conv_shortcut").permute(0, 3, 1, 2)
    return x + y


def _vae_attn(P, x, w: W, p: str):
    b, c, h, wd = x.shape
    y = _gn(x, w, p + "group_norm").permute(0, 2, 3, 1).reshape(b, h * wd, c)
    q, k, v = (linear(P, y, w, p + n).reshape(b, h * wd, 1, c)
               for n in ("query_proj", "key_proj", "value_proj"))
    o = torch.cat([attention(P, q[i:i + 1], k[i:i + 1], v[i:i + 1], 1.0 / math.sqrt(c))
                   for i in range(b)])
    o = linear(P, o.reshape(b, h, wd, c), w, p + "out_proj")
    return x + o.permute(0, 3, 1, 2)


def _blocks(w: W, prefix: str) -> List[int]:
    return sorted({int(k[len(prefix):].split(".")[0]) for k in w if k.startswith(prefix)})


def _mid(P, x, w: W):
    x = _resnet(P, x, w, "mid_blocks.0.")
    x = _vae_attn(P, x, w, "mid_blocks.1.")
    return _resnet(P, x, w, "mid_blocks.2.")


def vae_decode(P: Precision, w: W, z: torch.Tensor) -> torch.Tensor:
    """Latents NHWC -> RGB NHWC in about [-1, 1]."""
    x = _conv(P, z.permute(0, 3, 1, 2), w, "conv_in")
    x = _mid(P, x, w)
    for i in reversed(_blocks(w, "up_blocks.")):
        p = f"up_blocks.{i}."
        for j in _blocks(w, p + "resnets."):
            x = _resnet(P, x, w, f"{p}resnets.{j}.")
        if p + "upsample.weight" in w:
            x = _conv(P, F.interpolate(x, scale_factor=2, mode="nearest"), w, p + "upsample")
    x = _conv(P, F.silu(_gn(x, w, "conv_norm_out")), w, "conv_out")
    return x.permute(0, 2, 3, 1)


def vae_encode(P: Precision, w: W, img: torch.Tensor) -> torch.Tensor:
    """RGB NHWC in [-1, 1] -> (mean, logvar) NHWC at an eighth of the side."""
    x = _conv(P, img.permute(0, 3, 1, 2), w, "conv_in")
    for i in _blocks(w, "down_blocks."):
        p = f"down_blocks.{i}."
        for j in _blocks(w, p + "resnets."):
            x = _resnet(P, x, w, f"{p}resnets.{j}.")
        if p + "downsample.weight" in w:
            x = _conv(P, F.pad(x, (0, 1, 0, 1)), w, p + "downsample", stride=2, padding=0)
    x = _mid(P, x, w)
    x = _conv(P, F.silu(_gn(x, w, "conv_norm_out")), w, "conv_out")
    return x.permute(0, 2, 3, 1)


# -- sampling -------------------------------------------------------------------

def sigmas(num_steps: int, shift: float, flux: bool) -> np.ndarray:
    """The discrete-flow schedule: sigma(t) = shift t / (1 + (shift - 1) t)
    in fp32; SD3 takes ``num_steps`` timesteps from sigma(1000) down to
    sigma(1) and a final 0, FLUX ``num_steps + 1`` from sigma(1000) to 0."""
    def sig(ts):
        t = np.asarray(ts, dtype=np.float32) / 1000
        if shift == 1.0:
            return t
        return np.asarray(shift * t / (1 + (shift - 1) * t), dtype=np.float32)

    start = np.asarray(sig(1000), np.float32) * 1000
    end = np.asarray(sig(0 if flux else 1), np.float32) * 1000
    ts = np.linspace(start, end, num_steps + 1 if flux else num_steps, dtype=np.float32)
    out = [float(sig(t)) for t in ts]
    if not flux:
        out.append(0.0)
    return np.asarray(out, dtype=np.float32)


def noise(seed: int, shape_nhwc: Tuple[int, int, int, int]) -> np.ndarray:
    """numpy's legacy Gaussian stream of ``seed``, drawn NCHW, returned NHWC."""
    rs = np.random.RandomState(seed)
    b, h, w, c = shape_nhwc
    return rs.randn(b, c, h, w).transpose(0, 2, 3, 1).astype(np.float32)


def denoise(model: MMDiTRef, x: torch.Tensor, sig: np.ndarray, cond, pooled,
            cfg: float) -> torch.Tensor:
    """Euler over ``sig`` with classifier-free guidance when cfg > 1 (the
    model batch [x, x] against [positive rows, negative rows])."""
    n = x.shape[0]
    cfg_on = cfg > 1
    dev = x.device
    for i in range(len(sig) - 1):
        s, s_next = (torch.tensor(float(v), dtype=torch.float32, device=dev)
                     for v in (sig[i], sig[i + 1]))
        xin = torch.cat([x, x]) if cfg_on else x
        out = model.forward(xin, cond, pooled, (s * 1000.0).expand(xin.shape[0]))
        den = xin - out * s
        if cfg_on:
            den = den[n:] + cfg * (den[:n] - den[n:])
        x = x + (x - den) / s * (s_next - s)
    return x


def to_u8(rgb: torch.Tensor) -> np.ndarray:
    return torch.floor(torch.clamp(rgb / 2 + 0.5, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
