"""GPTQ and the ALS grid: the reference's quantize-at-load of the MMDiT, run
on the model's own device.

Counterpart of ``diffusionkit_tpu/ops/gptq.py`` and of the ALS half of
``diffusionkit_tpu/ops/quantized.py`` (``_als_refine_host``). GPTQ
(arXiv:2210.17323) quantizes an (in, out) kernel row by row along the
contraction and pushes each row's rounding error onto the rows not yet
quantized through U, the upper Cholesky factor of the inverse input Hessian
H = X^T X, so it minimises the layer's output error under the calibration
inputs X; the ALS grid fits each group alone.

  gptq_group          the group step (the reference's scan body ``gbody``):
                      the ALS fit of a group of rows, then its in-group
                      recursion. Kernel ``csrc/gptq.cu`` on the card,
                      ``gptq_group_plain`` on the CPU; counted in
                      ``gptq_group.launches``.
  als_grid            the data-free ALS grid, int4: ``gptq_group`` over all
                      groups at once with U = I (``_als_refine_host``)
  gptq_quantize       one kernel: dead rows, damping, U by a flip-Cholesky
                      and one triangular solve, then per group
                      ``gptq_group`` and the tail GEMM onto the later rows
  calib_batch         the reference's self-contained calibration batch
                      (numpy ``RandomState``), copied
  mirror_*            the float MMDiT forward over the port's modules with
                      every quantized site's input observable, in fp32
  gptq_quantize_mmdit the streaming tree quantizer, in place, layer by
                      layer

Storage is the reference's: scales and zeros on the f16 grid (held here in
fp32, where an f16 value is exact), codes packed as ``ops/quantized``.
"""

from __future__ import annotations

import gc
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import MMDiTConfig
from ..utils import get_logger
from . import kernels
from .attention import xla_sdpa
from .common import linear, patchify, timestep_embedding, unpack_flux, unpatchify_sd3
from .norms import modulated_layer_norm
from .quantized import QuantizedLinear, packed_linear, quantize_weight

logger = get_logger(__name__)

# The tree quantizer's eligibility rules, those of ops/quantized.quantize_linear.
MIN_SIZE = 1 << 16
MIN_DIM = 256
# The best-of-both guard (GPTQ against the data-free grid, by H-weighted
# error) runs for contraction dims up to this: the embedders' fc1.
GUARD_MAX_IN = 512
# Group sizes the kernel takes.
GROUP_SIZES = (32, 64, 128)
ALS_ITERS = 8
DAMP = 0.01

# Seconds by phase ("mirror", "cholesky", "group", "tail") of the GPTQ runs
# made while this is a dict (None: not timed). On the card each phase is
# timed by CUDA events around its launches, read at the end of each kernel;
# "loop" is the group loops' wall on the host clock, from the first launch
# to the end of the last on the device (the events' own cost included).
PHASE_SECONDS: Optional[Dict[str, float]] = None


# -- the group step ---------------------------------------------------------------


def _seq_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over dim -2 from its first row on, one row at a time (numpy's
    order for a sum over a non-innermost axis)."""
    acc = t[..., 0, :]
    for i in range(1, t.shape[-2]):
        acc = acc + t[..., i, :]
    return acc


def _grid_code(w, s, z, qmax: float) -> torch.Tensor:
    return torch.clamp(torch.round((w - z) / s), 0, qmax)


def gptq_group_plain(w: torch.Tensor, u: torch.Tensor, qmax: int, out=None):
    """Plain torch ``gptq_group``: op for op the kernel's arithmetic, each
    product, sum and quotient its own rounded op, every sum over the rows
    from row 0 in order; each division by a tensor (the card computes a
    division by a Python scalar as a product with its reciprocal)."""
    gs = w.shape[1]
    codes, s_out, z_out, err = out if out is not None else _outputs(w)
    r = w.clone()
    wmin, wmax = r.amin(dim=1), r.amax(dim=1)
    sw = _seq_sum(r)
    n = torch.full_like(sw, float(gs))
    s = torch.clamp_min((wmax - wmin) / torch.full_like(sw, float(qmax)), 1e-8)
    z = wmin
    best_s, best_z, best_e = s, z, torch.full_like(s, float("inf"))
    for it in range(ALS_ITERS + 1):
        sb, zb = s[:, None, :], z[:, None, :]
        q = _grid_code(r, sb, zb, qmax)
        d = sb * q + zb - r
        e, sq, sqq, swq = _seq_sum(torch.stack([d * d, q, q * q, r * q], dim=1)).unbind(1)
        better = e < best_e
        best_s, best_z = torch.where(better, s, best_s), torch.where(better, z, best_z)
        best_e = torch.where(better, e, best_e)
        if it == ALS_ITERS:
            break
        denom = n * sqq - sq * sq
        ok = denom > 1e-10
        s_new = (n * swq - sq * sw) / torch.where(ok, denom, torch.ones_like(denom))
        accept = ok & (s_new > 1e-8)
        z = torch.where(accept, (sw - s_new * sq) / n, z)
        s = torch.where(accept, s_new, s)
    s = torch.clamp_min(best_s.half().float(), 6.1e-8)
    z = best_z.half().float()
    s_out.copy_(s.half().float())
    z_out.copy_(z)
    sb, zb = s[:, None, :], z[:, None, :]
    for i in range(gs):
        q = _grid_code(r[:, i : i + 1], sb, zb, qmax)
        codes[:, i : i + 1] = q.to(torch.uint8)
        e = (r[:, i : i + 1] - (sb * q + zb)) / u[:, i, i, None, None]
        err[:, i : i + 1] = e
        if i + 1 < gs:
            r[:, i + 1 :] -= u[:, i, i + 1 :, None] * e
    return codes, s_out, z_out, err


def _outputs(w: torch.Tensor):
    G, gs, N = w.shape
    return (torch.empty((G, gs, N), dtype=torch.uint8, device=w.device),
            torch.empty((G, N), dtype=torch.float32, device=w.device),
            torch.empty((G, N), dtype=torch.float32, device=w.device),
            torch.empty((G, gs, N), dtype=torch.float32, device=w.device))


def gptq_group(w: torch.Tensor, u: torch.Tensor, qmax: int, out=None):
    """The group step over G groups: w (G, gs, N) fp32 contiguous, each
    group's rows after the compensation of the groups before it; u (G, gs,
    gs) fp32, each group's diagonal block of U (its rows contiguous, any
    group stride: 0 repeats one block). Returns (codes (G, gs, N) uint8,
    scales (G, N), zeros (G, N) fp32 holding f16 values, err (G, gs, N)),
    written into ``out`` (those four tensors) when given.

    For a CUDA tensor, kernel ``csrc/gptq.cu``: gs 32, 64 or 128, qmax 15
    or 255, or it raises; a CPU tensor goes to ``gptq_group_plain``."""
    if w.device.type == "cpu":
        return gptq_group_plain(w, u, qmax, out)
    G, gs, N = w.shape
    if gs not in GROUP_SIZES:
        raise ValueError(f"gptq_group: group size {gs}; the kernel takes {GROUP_SIZES}")
    if qmax not in (15, 255):
        raise ValueError(f"gptq_group: qmax {qmax}; the kernel takes 15 and 255")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError("gptq_group: w and u must be fp32")
    if not w.is_contiguous() or u.shape != (G, gs, gs) or u.stride(2) != 1 or u.device != w.device:
        raise ValueError("gptq_group: w (G, gs, N) contiguous, u (G, gs, gs) with unit last stride")
    outs = out if out is not None else _outputs(w)
    for t, dt in zip(outs, (torch.uint8, torch.float32, torch.float32, torch.float32)):
        if t.dtype != dt or not t.is_contiguous() or t.device != w.device:
            raise ValueError("gptq_group: outputs must be contiguous codes, scales, zeros, err")
    codes, s, z, err = outs
    if N and G:
        err_code = kernels.library().dk_gptq_group(
            w.data_ptr(), u.data_ptr(), u.stride(0), u.stride(1), codes.data_ptr(), s.data_ptr(),
            z.data_ptr(), err.data_ptr(), G, gs, N, float(qmax), kernels.stream_ptr(w.device))
        kernels.check(err_code, "gptq_group")
        gptq_group.launches += 1
    return outs


gptq_group.launches = 0


def als_grid(w: torch.Tensor, group_size: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's ALS int4 grid (``_als_refine_host``) of an (in, out)
    kernel on its device: ``gptq_group`` over every group at once with U =
    I, which leaves the rows as they are. Returns (codes (in, out) uint8,
    scales, zeros (in/g, out) fp32 on the f16 grid)."""
    k, n = w.shape
    wg = w.float().reshape(k // group_size, group_size, n).contiguous()
    eye = torch.eye(group_size, dtype=torch.float32, device=w.device)
    codes, s, z, _ = gptq_group(wg, eye.expand(wg.shape[0], group_size, group_size), 15)
    return codes.reshape(k, n), s, z


# -- the GPTQ core ------------------------------------------------------------------


class _Timer:
    """Seconds by phase into ``PHASE_SECONDS`` while it is a dict: CUDA
    events on the card, read at ``flush``; the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.on = PHASE_SECONDS is not None
        self.cuda = device.type == "cuda"
        self.spans: List[tuple] = []

    def mark(self):
        if not self.on:
            return None
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def span(self, phase: str, start, end) -> None:
        if self.on:
            self.spans.append((phase, start, end))

    def flush(self) -> None:
        if not self.on or not self.spans:
            return
        if self.cuda:
            self.spans[-1][2].synchronize()
        for phase, a, b in self.spans:
            sec = a.elapsed_time(b) / 1e3 if self.cuda else b - a
            if PHASE_SECONDS is not None:
                PHASE_SECONDS[phase] = PHASE_SECONDS.get(phase, 0.0) + sec
        self.spans.clear()


def _inverse_factor(H: torch.Tensor, damp: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(U, dead): U upper with H^-1 = U^T U for H with its dead inputs
    (a diagonal entry <= 0) set to 1 and damp * mean(diag) added to the
    diagonal, by the Cholesky factor of the flipped H and one triangular
    solve (as the reference builds it, with no inverse); the identity where
    the factorisation fails or U is not finite."""
    k = H.shape[0]
    H = H.float()
    diag = H.diagonal()
    dead = diag <= 0
    eye = torch.eye(k, dtype=torch.float32, device=H.device)
    H = H + torch.diag(torch.where(dead, 1.0 - diag, torch.zeros_like(diag)))
    H = H + (damp * torch.clamp_min(diag.mean(), 1e-12)) * eye
    L, info = torch.linalg.cholesky_ex(H.flip(0, 1))
    # Row-major: the group step reads rows of U's diagonal blocks.
    U = torch.linalg.solve_triangular(L.flip(0, 1), eye, upper=True).contiguous()
    if not bool(((info == 0) & torch.isfinite(U).all()).item()):
        U = eye
    return U, dead


def gptq_quantize(w: torch.Tensor, H: torch.Tensor, bits: int = 4, group_size: int = 32,
                  damp: float = DAMP, timer: Optional[_Timer] = None, group_step=None):
    """GPTQ of one (in, out) kernel with its input Hessian H (in, in), on
    their device, in fp32 (TF32 off): the reference's ``_gptq_core``.
    ``group_step`` replaces ``gptq_group`` (a check may run both forms).
    Returns (codes (in, out) uint8, scales, zeros (in/g, out) fp32 on the
    f16 grid)."""
    k, n = w.shape
    if k % group_size:
        raise ValueError(f"gptq_quantize: {k} rows, group {group_size}")
    qmax = 2**bits - 1
    timer = timer or _Timer(w.device)
    group_step = group_step or gptq_group
    with _no_tf32():
        t0 = timer.mark()
        U, dead = _inverse_factor(H, damp)
        t1 = timer.mark()
        timer.span("cholesky", t0, t1)
        w = w.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
        w.masked_fill_(dead[:, None], 0.0)
        groups = k // group_size
        codes = torch.empty((groups, group_size, n), dtype=torch.uint8, device=w.device)
        s = torch.empty((groups, n), dtype=torch.float32, device=w.device)
        z = torch.empty_like(s)
        err = torch.empty((1, group_size, n), dtype=torch.float32, device=w.device)
        loop_start = time.perf_counter()
        for g in range(groups):
            g0, g1 = g * group_size, (g + 1) * group_size
            group_step(w[g0:g1].view(1, group_size, n), U[g0:g1, g0:g1].unsqueeze(0), qmax,
                       out=(codes[g : g + 1], s[g : g + 1], z[g : g + 1], err))
            t2 = timer.mark()
            timer.span("group", t1, t2)
            if g1 < k:
                w[g1:].addmm_(U[g0:g1, g1:].t(), err[0], alpha=-1.0)
            t1 = timer.mark()
            timer.span("tail", t2, t1)
    timer.flush()
    if timer.on and PHASE_SECONDS is not None:  # flush waited for the device
        PHASE_SECONDS["loop"] = PHASE_SECONDS.get("loop", 0.0) + time.perf_counter() - loop_start
    return codes.reshape(k, n), s, z


class _no_tf32:
    """TF32 off for the fp32 GEMMs inside, restored after."""

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.saved


def dequant(codes: torch.Tensor, s: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``q * scale + zero`` (in, out) fp32, the group affine repeated along
    the rows."""
    g = codes.shape[0] // s.shape[0]
    return codes.float() * s.repeat_interleave(g, dim=0) + z.repeat_interleave(g, dim=0)


def h_weighted_err(w: torch.Tensor, codes, s, z, H: torch.Tensor) -> torch.Tensor:
    """sum((w - dequant) * (H @ (w - dequant))), fp32 on the device (the
    reference's ``_h_weighted_err``)."""
    d = w.float() - dequant(codes, s, z)
    with _no_tf32():
        return (d * (H.float() @ d)).sum()


# -- calibration --------------------------------------------------------------------


def calib_batch(config: MMDiTConfig, batch: int = 48, latent_hw: Tuple[int, int] = (32, 32),
                seed: int = 0) -> Dict[str, np.ndarray]:
    """The reference's self-contained calibration batch (host numpy, fp32,
    the same draws): latents as sigma-scaled NCHW noise transposed to NHWC
    on the sampler's sigma ladder; SD3 conditioning rows as 77 CLIP rows
    (features past 2048 zero) and 77 zero T5 rows, FLUX's as 256 dense
    rows; pooled vectors; the timesteps sigma * 1000."""
    rs = np.random.RandomState(seed)
    h, w = latent_hw
    sigmas = np.array([1.0, 0.85, 0.66, 0.45, 0.25, 0.08], np.float32)
    sig = sigmas[np.arange(batch) % len(sigmas)]
    noise = rs.randn(batch, config.vae_latent_dim, h, w).astype(np.float32)
    latent = sig[:, None, None, None] * noise.transpose(0, 2, 3, 1)
    d_txt = config.token_level_text_embed_dim
    if config.depth_unified > 0:
        cond = rs.randn(batch, 256, d_txt).astype(np.float32)
    else:
        cond = np.zeros((batch, 154, d_txt), np.float32)
        cond[:, :77, : min(2048, d_txt)] = rs.randn(batch, 77, min(2048, d_txt))
    pooled = rs.randn(batch, config.pooled_text_embed_dim).astype(np.float32)
    return {"latent": latent, "cond": cond, "pooled": pooled,
            "t": (sig * 1000.0).astype(np.float32)}


# -- the float mirror -----------------------------------------------------------------


def site_h(x: torch.Tensor) -> torch.Tensor:
    """X^T X of one site's activations (rows flattened), fp32."""
    x = x.float().reshape(-1, x.shape[-1])
    return x.t() @ x


def _attention(q, k, v, config: MMDiTConfig) -> torch.Tensor:
    return xla_sdpa(q, k, v, 1.0 / (config.head_dim**0.5), layout="bshd").flatten(2)


def mirror_prologue(model: nn.Module, latent, cond, pooled, t, guidance=None):
    """The embedding prologue in fp32 (``MMDiT.forward``'s, with the
    activations kept in fp32): (x, txt, c, the x_embedder's Hessian)."""
    cfg = model.config
    p = cfg.patch_size
    patch = patchify(latent, p)
    x = linear(model.x_embedder, patch)
    if model.pos_embed is not None:
        lh, lw = latent.shape[1] // p, latent.shape[2] // p
        maxhw = int(round(model.pos_embed.shape[0] ** 0.5))
        y0, x0 = (maxhw - lh) // 2, (maxhw - lw) // 2
        pos = model.pos_embed.reshape(maxhw, maxhw, cfg.hidden_size)
        x = x + pos[y0 : y0 + lh, x0 : x0 + lw].reshape(1, lh * lw, -1).to(x.dtype)
    txt = linear(model.context_embedder, cond)
    c = model.t_embedder(timestep_embedding(t, cfg.frequency_embed_dim, cfg.max_period))
    c = c + model.y_embedder(pooled)
    if model.guidance_embedder is not None:
        if guidance is None:
            guidance = torch.full((latent.shape[0],), 3.5, dtype=torch.float32,
                                  device=latent.device)
        c = c + model.guidance_embedder(
            timestep_embedding(guidance, cfg.frequency_embed_dim, cfg.max_period))
    return x, txt, c, site_h(patch)


def mirror_mm_layer(block: nn.Module, img, txt, c, rope, config: MMDiTConfig):
    """One dual-stream block (``MMBlock.forward``) in fp32 with the input of
    every quantized site kept: (img', txt', {site: Hessian}); the final SD3
    block (``block.final``) keeps its text stream."""
    eps = config.layer_norm_eps
    img_mods = block.img.modulation(c)
    txt_mods = block.txt.modulation(c)
    img_h = modulated_layer_norm(img, img_mods[0], img_mods[1], eps)
    txt_h = modulated_layer_norm(txt, txt_mods[0], txt_mods[1], eps)
    img_len, txt_len = img.shape[1], txt.shape[1]
    flux = config.depth_unified > 0
    rope_img = None if rope is None else (rope[0][txt_len:], rope[1][txt_len:])
    q_i, k_i, v_i = block.img.qkv(img_h, config.num_heads, rope_img if flux else None)
    q_t, k_t, v_t = block.txt.qkv(txt_h, config.num_heads)
    if flux:
        q, k, v = (torch.cat(p, dim=1) for p in ((q_t, q_i), (k_t, k_i), (v_t, v_i)))
    else:
        q, k, v = (torch.cat(p, dim=1) for p in ((q_i, q_t), (k_i, k_t), (v_i, v_t)))
    o = _attention(q, k, v, config)
    o_txt, o_img = (o[:, :txt_len], o[:, txt_len:]) if flux else (o[:, img_len:], o[:, :img_len])
    img2 = img + img_mods[2] * linear(block.img.o, o_img)
    h2_img = modulated_layer_norm(img2, img_mods[3], img_mods[4], eps)
    g_img = linear(block.img.fc1, h2_img, act="gelu")
    img3 = img2 + img_mods[5] * linear(block.img.fc2, g_img)
    sites = {"img_qkv": site_h(img_h), "txt_qkv": site_h(txt_h), "img_o": site_h(o_img),
             "img_fc1": site_h(h2_img), "img_fc2": site_h(g_img)}
    if block.final:
        return img3, txt, sites
    txt2 = txt + txt_mods[2] * linear(block.txt.o, o_txt)
    h2_txt = modulated_layer_norm(txt2, txt_mods[3], txt_mods[4], eps)
    g_txt = linear(block.txt.fc1, h2_txt, act="gelu")
    txt3 = txt2 + txt_mods[5] * linear(block.txt.fc2, g_txt)
    sites.update({"txt_o": site_h(o_txt), "txt_fc1": site_h(h2_txt), "txt_fc2": site_h(g_txt)})
    return img3, txt3, sites


def mirror_uni_layer(block: nn.Module, u, c, rope, config: MMDiTConfig):
    """One single-stream parallel-MLP block (``UnifiedBlock.forward``) in
    fp32: (u', {site: Hessian}); fc1 reads q/k/v's site."""
    if not config.parallel_mlp_for_unified_blocks:
        raise NotImplementedError("GPTQ mirror: single-stream blocks without the parallel MLP")
    mods = block.modulation(c)
    h = modulated_layer_norm(u, mods[0], mods[1], config.layer_norm_eps)
    q, k, v = block.qkv(h, config.num_heads, rope)
    o = _attention(q, k, v, config)
    g = linear(block.fc1, h, act="gelu")
    out = u + mods[2] * (linear(block.o, o) + linear(block.fc2, g))
    return out, {"qkv": site_h(h), "o": site_h(o), "fc2": site_h(g)}


def mirror_epilogue(model: nn.Module, x, c, latent_hw):
    """The final layer in fp32: (output NHWC, its linear's Hessian)."""
    cfg = model.config
    fl = model.final_layer
    shift, scale = (m[:, None, :] for m in linear(fl.ada, F.silu(c)).chunk(2, dim=-1))
    xh = modulated_layer_norm(x, shift, scale, cfg.layer_norm_eps)
    out = linear(fl.linear, xh)
    if cfg.patchify_via_reshape:
        out = unpack_flux(out, latent_hw, cfg.patch_size)
    else:
        out = unpatchify_sd3(out, latent_hw, cfg.patch_size, cfg.vae_latent_dim)
    return out, site_h(xh)


def _rope(model: nn.Module, latent, txt_len: int):
    cfg = model.config
    if model.pos_embed is not None:
        return None
    p = cfg.patch_size
    return model.rope_tables((latent.shape[1] // p, latent.shape[2] // p), txt_len, latent.device)


@torch.no_grad()
def mirror_forward(model: nn.Module, latent, cond, pooled, t, guidance=None) -> torch.Tensor:
    """The whole mirror (no quantization), fp32 inputs on the model's
    device: the surface the tests hold against ``MMDiT.forward`` in fp32
    and the reference's ``mirror_forward``."""
    cfg = model.config
    x, txt, c, _ = mirror_prologue(model, latent, cond, pooled, t, guidance)
    rope = _rope(model, latent, txt.shape[1])
    for block in model.mm_blocks:
        x, txt, _ = mirror_mm_layer(block, x, txt, c, rope, cfg)
    if model.mm_final is not None:
        x, _, _ = mirror_mm_layer(model.mm_final, x, txt, c, rope, cfg)
    else:
        u = torch.cat([txt, x], dim=1)
        for block in model.uni_blocks:
            u, _ = mirror_uni_layer(block, u, c, rope, cfg)
        x = u[:, txt.shape[1]:]
    return mirror_epilogue(model, x, c, (latent.shape[1], latent.shape[2]))[0]


@torch.no_grad()
def dense_c_hessians(model: nn.Module, pooled: np.ndarray, n_t: int = 64,
                     seed: int = 17) -> Dict[str, torch.Tensor]:
    """The conditioning-vector sites' Hessians (the reference's
    ``_dense_c_hessians``): the t / y / guidance embedders' and the shared
    AdaLN input silu(c) over a (timestep x pooled) ladder; y's fc1 topped
    up past full rank with ``RandomState(seed)`` rows."""
    cfg = model.config
    dev = model.x_embedder.weight.device
    H: Dict[str, torch.Tensor] = {}
    ts = torch.from_numpy(np.linspace(10.0, 1000.0, n_t).astype(np.float32)).to(dev)
    femb = timestep_embedding(ts, cfg.frequency_embed_dim, cfg.max_period)
    h1_t = F.silu(linear(model.t_embedder.fc1, femb))
    temb = linear(model.t_embedder.fc2, h1_t)
    d_pool = pooled.shape[-1]
    extra = np.random.RandomState(seed).randn(d_pool + 128, d_pool).astype(np.float32)
    pooled_all = torch.from_numpy(np.concatenate([np.asarray(pooled, np.float32), extra])).to(dev)
    h1_y = F.silu(linear(model.y_embedder.fc1, pooled_all))
    yemb = linear(model.y_embedder.fc2, h1_y)
    yemb_sub = yemb[:: max(1, yemb.shape[0] // 48)][:48]
    c_all = (temb[:, None, :] + yemb_sub[None, :, :]).reshape(-1, temb.shape[-1])
    if model.guidance_embedder is not None:
        gs = torch.from_numpy(np.linspace(1.0, 8.0, 8).astype(np.float32)).to(dev)
        gf = timestep_embedding(gs, cfg.frequency_embed_dim, cfg.max_period)
        h1_g = F.silu(linear(model.guidance_embedder.fc1, gf))
        gemb = linear(model.guidance_embedder.fc2, h1_g)
        c_all = (c_all[:, None, :] + gemb[None, :2, :]).reshape(-1, temb.shape[-1])
        H["g_fc1"], H["g_fc2"] = site_h(gf), site_h(h1_g)
    H["t_fc1"], H["t_fc2"] = site_h(femb), site_h(h1_t)
    H["y_fc1"], H["y_fc2"] = site_h(pooled_all), site_h(h1_y)
    H["ada"] = site_h(F.silu(c_all))
    return H


def context_hessian(cond: torch.Tensor, config: MMDiTConfig, seed: int = 23) -> torch.Tensor:
    """The context embedder's Hessian: the calibration rows plus a top-up
    past full rank over the active features (``RandomState(seed)``)."""
    d_txt = config.token_level_text_embed_dim
    active = d_txt if config.depth_unified > 0 else min(2048, d_txt)
    extra = np.zeros((active + 128, d_txt), np.float32)
    extra[:, :active] = np.random.RandomState(seed).randn(active + 128, active)
    return site_h(cond) + site_h(torch.from_numpy(extra).to(cond.device))


# -- the tree quantizer -------------------------------------------------------------


def eligible(layer: nn.Module, group_size: int) -> bool:
    """A float linear the quantizer packs: at least ``MIN_SIZE`` weights,
    both dims at least ``MIN_DIM``, rows a multiple of the group."""
    if not isinstance(layer, nn.Linear):
        return False
    out_dim, in_dim = layer.weight.shape
    return (layer.weight.numel() >= MIN_SIZE and min(in_dim, out_dim) >= MIN_DIM
            and in_dim % group_size == 0)


@torch.no_grad()
def quantize_mat(layer: nn.Module, H: Optional[torch.Tensor], bits: int, group_size: int,
                 timer: Optional[_Timer] = None) -> nn.Module:
    """One linear (the reference's ``_quantize_mat``): GPTQ with ``H``, or
    the data-free grid without one; a layer the rules leave float comes
    back as it is. Up to ``GUARD_MAX_IN`` inputs the data-free grid is
    taken instead where its H-weighted error is lower."""
    if not eligible(layer, group_size):
        return layer
    w = layer.weight.t()
    if H is None:
        return packed_linear(layer, *quantize_weight(w, group_size, bits), bits, group_size)
    got = gptq_quantize(w, H, bits, group_size, timer=timer)
    if w.shape[0] <= GUARD_MAX_IN:
        free = quantize_weight(w, group_size, bits)
        if h_weighted_err(w, *free, H) < h_weighted_err(w, *got, H):
            got = free
    return packed_linear(layer, *got, bits, group_size)


@torch.no_grad()
def quantize_mats_shared_h(layers: List[nn.Linear], H: torch.Tensor, bits: int, group_size: int,
                           timer: Optional[_Timer] = None) -> List[QuantizedLinear]:
    """Linears that read one site, GPTQ'd as one kernel of their columns
    side by side: the recursion treats columns independently given H, so
    each comes out as a call of its own would give it, in one group loop."""
    widths = [layer.out_features for layer in layers]
    w = torch.cat([layer.weight for layer in layers], dim=0).t()
    codes, s, z = gptq_quantize(w, H, bits, group_size, timer=timer)
    out, c0 = [], 0
    for layer, n in zip(layers, widths):
        sl = slice(c0, c0 + n)
        out.append(packed_linear(layer, codes[:, sl], s[:, sl], z[:, sl], bits, group_size))
        c0 += n
    return out


def _mem_trace(tag: str, device: torch.device) -> None:
    """Allocated and peak device memory after a layer
    (``DIFFUSIONKIT_TPU_GPTQ_DEBUG=1``)."""
    if os.environ.get("DIFFUSIONKIT_TPU_GPTQ_DEBUG", "0") != "1" or device.type != "cuda":
        return
    logger.info("gptq[%s] allocated=%.2fGB peak=%.2fGB", tag,
                torch.cuda.memory_allocated(device) / 2**30,
                torch.cuda.max_memory_allocated(device) / 2**30)


def check_supported(model: nn.Module) -> None:
    """Raise NotImplementedError for a model the mirror does not cover,
    before anything is changed."""
    if model.config.depth_unified > 0 and not model.config.parallel_mlp_for_unified_blocks:
        raise NotImplementedError("GPTQ: single-stream blocks without the parallel MLP")


@torch.no_grad()
def gptq_quantize_mmdit(model: nn.Module, bits: int = 4, group_size: int = 32,
                        overrides: Optional[Dict[str, Optional[int]]] = None, batch: int = 48,
                        latent_hw: Tuple[int, int] = (32, 32), seed: int = 0) -> nn.Module:
    """GPTQ every eligible float linear of an ``MMDiT``, in place, on its
    device: the reference's ``gptq_quantize_mmdit``, the same calibration,
    eligibility rules, shared-site concatenation (q/k/v, plus fc1 in the
    single-stream blocks) and ``overrides`` (an attribute name to its bits,
    or None to keep it float; ``final_layer: None`` keeps the whole final
    layer float). One pass: a layer's mirror step runs on its float weights,
    then its linears become ``QuantizedLinear``s; the float activations go
    on to the next layer. Peak memory: the model and one layer's work.
    Returns ``model``."""
    check_supported(model)
    cfg = model.config
    dev = model.x_embedder.weight.device
    overrides = overrides or {}
    timer = _Timer(dev)

    def bits_of(name: str) -> Optional[int]:
        return overrides[name] if name in overrides else bits

    def q(parent: nn.Module, attr: str, H, name: str) -> None:
        b = bits_of(name)
        layer = getattr(parent, attr, None)
        if b is not None and isinstance(layer, nn.Linear):
            setattr(parent, attr, quantize_mat(layer, H, b, group_size, timer))

    def q_branch(p: nn.Module, Hs: Dict[str, torch.Tensor], with_mlp: bool) -> None:
        H_qkv = Hs.get("qkv")
        shared = ["q", "k", "v"]
        fc1_shared = with_mlp and hasattr(p, "fc1") and "fc1" not in Hs
        if fc1_shared:
            shared.append("fc1")

        def concat_ok(name: str) -> bool:
            layer = getattr(p, name, None)
            return (bits_of(name) == bits and eligible(layer, group_size)
                    and layer.in_features > GUARD_MAX_IN)

        if H_qkv is not None and all(concat_ok(n) for n in shared):
            for n, layer in zip(shared, quantize_mats_shared_h(
                    [getattr(p, n) for n in shared], H_qkv, bits, group_size, timer)):
                setattr(p, n, layer)
        else:
            for n in shared:
                q(p, n, H_qkv, n)
        q(p, "ada", H_ada, "ada")
        if with_mlp and hasattr(p, "o"):
            q(p, "o", Hs.get("o"), "o")
            if not fc1_shared:
                q(p, "fc1", Hs.get("fc1", H_qkv), "fc1")
            q(p, "fc2", Hs.get("fc2"), "fc2")

    def split(Hs: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
        return {k[len(prefix):]: v for k, v in Hs.items() if k.startswith(prefix)}

    data = calib_batch(cfg, batch=batch, latent_hw=latent_hw, seed=seed)
    latent, cond, pooled, t = (torch.from_numpy(data[k]).to(dev)
                               for k in ("latent", "cond", "pooled", "t"))
    with _no_tf32():
        t0 = timer.mark()
        x, txt, c, H_patch = mirror_prologue(model, latent, cond, pooled, t)
        H_ctx = context_hessian(cond, cfg)
        Hc = dense_c_hessians(model, data["pooled"])
        timer.span("mirror", t0, timer.mark())
        q(model, "x_embedder", H_patch, "x_embedder")
        q(model, "context_embedder", H_ctx, "context_embedder")
        for emb, pre in (("t_embedder", "t"), ("y_embedder", "y"), ("guidance_embedder", "g")):
            mlp = getattr(model, emb)
            if mlp is not None:
                q(mlp, "fc1", Hc.get(f"{pre}_fc1"), emb)
                q(mlp, "fc2", Hc.get(f"{pre}_fc2"), emb)
        H_ada = Hc["ada"]
        del H_patch, H_ctx, cond
        rope = _rope(model, latent, txt.shape[1])

        blocks = [(f"mm{i}", b) for i, b in enumerate(model.mm_blocks)]
        if model.mm_final is not None:
            blocks.append(("mm_final", model.mm_final))
        for tag, block in blocks:
            t0 = timer.mark()
            x, txt, Hs = mirror_mm_layer(block, x, txt, c, rope, cfg)
            timer.span("mirror", t0, timer.mark())
            q_branch(block.img, split(Hs, "img_"), True)
            q_branch(block.txt, split(Hs, "txt_"), not block.final)
            del Hs
            timer.flush()
            gc.collect()
            _mem_trace(tag, dev)
        if model.mm_final is None:
            u = torch.cat([txt, x], dim=1)
            for i, block in enumerate(model.uni_blocks):
                t0 = timer.mark()
                u, Hs = mirror_uni_layer(block, u, c, rope, cfg)
                timer.span("mirror", t0, timer.mark())
                q_branch(block, Hs, True)
                del Hs
                timer.flush()
                gc.collect()
                _mem_trace(f"uni{i}", dev)
            x = u[:, txt.shape[1]:]
        if not ("final_layer" in overrides and overrides["final_layer"] is None):
            t0 = timer.mark()
            _, H_final = mirror_epilogue(model, x, c, (latent.shape[1], latent.shape[2]))
            timer.span("mirror", t0, timer.mark())
            q(model.final_layer, "ada", H_ada, "ada")
            q(model.final_layer, "linear", H_final, "final_layer")
    timer.flush()
    return model
