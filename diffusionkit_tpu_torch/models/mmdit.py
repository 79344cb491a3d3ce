"""Multi-modal Diffusion Transformer (MMDiT): SD3 and FLUX, as ``nn.Module``s.

Counterpart of ``diffusionkit_tpu/models/mmdit.py``: the stacked block
parameters and ``lax.scan`` become ``nn.ModuleList``s walked by a Python
loop. Same math and sequence order:

- SD3 concatenates [image, text] for the joint attention, adds a learned,
  centre-cropped position table, and its last dual-stream block's text
  branch is K/V-only (``final=True``).
- FLUX concatenates [text, image] in both block families, rotates q/k with
  RoPE after the QK-RMSNorm (image rows only in the dual-stream blocks: the
  text rows' rotation is the identity), runs 38 single-stream
  ``UnifiedBlock``s with a parallel MLP, and unpacks with ``unpack_flux``.
  FLUX-dev adds a guidance embedding to the modulation input.

The AdaLN LayerNorm sites go to kernel A (``ops/fused_quant.mod_ln``), the
joint attention to kernel B through ``ops/attention.sdpa`` (to #14 under
``sdpa_impl="ring"``, to #15 under ``DIFFUSIONKIT_TPU_ATTN_LAYOUT=bhsd``), and the block
linears of an int4 or int8 model (``QuantizedLinear``) to kernels C and #13
through ``ops/common.linear``.

SD3.5-large's fp32-upcast blocks (``config.upcast_multimodal_blocks``, and
``upcast_unified_blocks`` likewise) are the reference's ``_segments``: such
a block holds every float leaf in fp32 (its linears' weights and biases,
QK-norm scales; quantized scales and zeros are fp32 anyway, packed integer
leaves are untouched), the reference's per-forward ``_upcast_leaf`` done
once at build time (bf16 to fp32 is exact). The stream runs through it in
fp32 and back to the model dtype after it; the modulation input c stays in
the model dtype, so its ``ada`` projection returns the model dtype, as the
reference's promotion does. Its linears take the fp32 forms of kernels C,
#13 and E, its attention kernel B's fp32 kernel, and on the card its AdaLN
sites take the (model-dtype) modulation upcast to fp32, as the reference's
kernels read it.

A w4a8 model (``QuantizedLinear``s carrying ``wscale``) takes the
reference's w4a8 dispatch: each AdaLN site whose consumers quantize runs
kernel A' (``mod_ln_quantize``) and hands one ``ActQuant`` to q/k/v and
fc1; the image-stream and single-stream q/k take kernel E's norm_rope
epilogue (``w4a8_qk_linear``); every FFN keeps its hidden in int8
(``w4a8_ffn_gelu``); the other linears take kernel E's plain mode, after
kernel D where their input is float. The dispatch is not gated on the
device: on the CPU the same route runs through the plain versions. (The JAX
package on a CPU backend quietly computes a w4a8 model as int4
weight-only, since ``quantized.py:_quant_kernel_eligible`` gates on
``jax.default_backend()``; the port does not copy that.)

A w8a8 model (``W8A8Linear``s) takes the same dispatch with kernel #11 for
every product: A' at each AdaLN site (the final layer's too, when its
linear is w8a8), D before a float input, and kernel #4 (``gelu_quantize``)
between fc1 and fc2.

Sharded over a mesh's ``model`` axis (``parallel/sharding.shard_module_``,
the reference's Megatron plan), each rank holds its columns of q/k/v, fc1
and ``ada`` and its rows of o and fc2 (``ops/common.linear`` sums the row
products over the group). The attention and the QK norm and RoPE run on
the rank's heads; where the heads are not a whole number a rank (38 heads
over 4), q/k/v are gathered whole first and the attention output is cut
back to the rank's columns for o. The ``ada`` outputs are gathered back to
every rank before they are split into the modulation vectors (the
reference's ``_ada``): (B, n_mod H / n) a rank. The embedders' MLPs are
split by the same rules; the rest (the patch and context embedders, the
norms, the final linear) is whole on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..config import MMDiTConfig, PositionalEncoding
from ..ops.attention import sdpa
from ..ops.common import (
    MLPSiLU,
    ffn_gelu,
    gather_output,
    linear,
    patchify,
    timestep_embedding,
    unpack_flux,
    unpatchify_sd3,
)
from ..ops.fused_quant import mod_ln, mod_ln_quantize
from ..ops.norms import modulated_layer_norm, rms_norm
from ..ops.quantized import QuantizedLinear, random_quantized_linear_
from ..ops.rope import apply_rope, rms_norm_rope, rope_frequencies
from ..ops.w4a8_matmul import w4a8_qk_eligible, w4a8_qk_linear
from ..ops.w8a8 import W8A8Linear, needs_act_quant, quantize_shared, random_w8a8_linear_
from ..parallel.collectives import all_gather

QuantBits = Optional[Union[int, str]]  # None (float), 4, 8 or "w8a8"

Rope = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _mod_ln_maybe_fused(
    x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor, eps: float
) -> torch.Tensor:
    """AdaLN LayerNorm site: kernel A where the reference's fused Pallas
    ``mod_ln`` is eligible (hidden a multiple of 128, a (B, S, H) tensor)
    and the tensor is on the card; else the plain ``modulated_layer_norm``.
    (The float branch of the reference's ``_mod_ln_maybe_quant``.)"""
    if x.is_cuda and x.ndim == 3 and x.shape[-1] % 128 == 0:
        return mod_ln(x, shift.to(x.dtype), scale.to(x.dtype), eps)
    return modulated_layer_norm(x, shift, scale, eps)


def _mod_ln_maybe_quant(consumer: nn.Module, x: torch.Tensor, shift: torch.Tensor,
                        scale: torch.Tensor, eps: float):
    """AdaLN LayerNorm site, quantized once for its quantized consumers (the
    reference's ``_mod_ln_maybe_quant``): when ``consumer`` (q, or fc1)
    quantizes its activations, kernel A' (``mod_ln_quantize``) for a
    (B, S, H) x with H a multiple of 128, else the plain modulated LN
    quantized by ``quantize_shared``; an ``ActQuant`` either way. Float
    consumers get ``_mod_ln_maybe_fused``."""
    if needs_act_quant(consumer):
        if x.ndim == 3 and x.shape[-1] % 128 == 0:
            return mod_ln_quantize(x, shift.to(x.dtype), scale.to(x.dtype), eps)
        return quantize_shared(modulated_layer_norm(x, shift, scale, eps))
    return _mod_ln_maybe_fused(x, shift, scale, eps)


class QKNorm(nn.Module):
    """Per-head-dim RMSNorm scales of q and k."""

    def __init__(self, head_dim: int, dtype: torch.dtype):
        super().__init__()
        self.q_scale = nn.Parameter(torch.empty(head_dim, dtype=dtype))
        self.k_scale = nn.Parameter(torch.empty(head_dim, dtype=dtype))


class Projections(nn.Module):
    """The linears of one stream: q, k (no bias: redundant under softmax
    shift invariance), v, ada and, with the MLP, o, fc1, fc2; plus the QK
    norm. Block linears are packed ``QuantizedLinear``s at group 64 for
    ``quantize_bits`` 4 or 8 and ``W8A8Linear``s for "w8a8", as the
    reference's ``init_mmdit_params(quantize_bits=...)`` builds them."""

    def __init__(self, config: MMDiTConfig, num_mod: int, with_mlp: bool = True,
                 quantize_bits: QuantBits = None):
        super().__init__()
        H, dt = config.hidden_size, config.dtype
        self.num_mod = num_mod

        def lin(d_in, d_out, bias=True):
            if quantize_bits == "w8a8":
                return W8A8Linear(d_in, d_out, bias=bias, dtype=dt)
            if quantize_bits:
                return QuantizedLinear(d_in, d_out, 64, bias=bias, dtype=dt, bits=quantize_bits)
            return nn.Linear(d_in, d_out, bias=bias, dtype=dt)

        self.q = lin(H, H)
        self.k = lin(H, H, bias=False)
        self.v = lin(H, H)
        self.ada = lin(H, num_mod * H)
        if with_mlp:
            self.o = lin(H, H)
            self.fc1 = lin(H, H * config.mlp_ratio)
            self.fc2 = lin(H * config.mlp_ratio, H)
        self.qk_norm = QKNorm(config.head_dim, dt) if config.use_qk_norm else None

    def modulation(self, c: torch.Tensor) -> List[torch.Tensor]:
        """adaLN_modulation: SiLU -> Linear -> split into (B, 1, H) views;
        a column-parallel ``ada``'s output gathered whole first."""
        y = gather_output(self.ada, linear(self.ada, F.silu(c)))
        return [p[:, None, :] for p in y.chunk(self.num_mod, dim=-1)]

    def holds_heads(self, head_dim: int) -> bool:
        """Whether q/k/v hold whole heads: unsplit, or split into a whole
        number of heads a rank; else the attention gathers them."""
        return getattr(self.q, "tp", None) is None or self.q.out_features % head_dim == 0

    def head_group(self, head_dim: int):
        """The group over which q/k/v hold this rank's heads, or None where
        they hold every head (no split, or gathered: ``holds_heads``)."""
        tp = getattr(self.q, "tp", None)
        return tp.group if tp is not None and self.holds_heads(head_dim) else None

    def attn_input(self, o: torch.Tensor, head_dim: int) -> torch.Tensor:
        """o's input from the attention output (B, S, features): where the
        heads were gathered whole, this rank's columns of it."""
        tp = getattr(self.q, "tp", None)
        if self.holds_heads(head_dim):
            return o
        w = o.shape[-1] // tp.n
        return o.narrow(-1, tp.index * w, w)

    def qkv(self, x, num_heads: int, rope: Rope = None):
        """Per-head q, k, v (B, S, heads, d) from x (a tensor or a shared
        ``ActQuant``); QK-RMSNorm and RoPE when configured, fused in fp32
        with one rounding when both apply: in kernel E's epilogue when q
        and k are w4a8 with 128-wide heads (``w4a8_qk_linear``). Under
        tensor parallelism the heads are this rank's (``head_group``), or
        all of them gathered."""
        b, s, h = x.shape
        d = h // num_heads
        if rope is not None and self.qk_norm is not None and all(
                w4a8_qk_eligible(layer, d) for layer in (self.q, self.k)):
            cos, sin = rope
            q = w4a8_qk_linear(self.q, x, self.qk_norm.q_scale, cos, sin)
            k = w4a8_qk_linear(self.k, x, self.qk_norm.k_scale, cos, sin)
            return tuple(t.reshape(b, s, -1, d) for t in (q, k, linear(self.v, x)))
        tp = getattr(self.q, "tp", None)
        gather = not self.holds_heads(d)
        q, k, v = ((all_gather(y, -1, tp.group) if gather else y).reshape(b, s, -1, d)
                   for y in (linear(layer, x) for layer in (self.q, self.k, self.v)))
        if rope is not None:
            cos, sin = (t[:, None, :] for t in rope)  # broadcast over heads
        if self.qk_norm is not None:
            if rope is not None:
                q = rms_norm_rope(q, self.qk_norm.q_scale, cos, sin)
                k = rms_norm_rope(k, self.qk_norm.k_scale, cos, sin)
            else:
                q = rms_norm(q, self.qk_norm.q_scale)
                k = rms_norm(k, self.qk_norm.k_scale)
        elif rope is not None:
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        return q, k, v


class MMBlock(nn.Module):
    """Dual-stream block with joint attention: [image, text] for SD3,
    [text, image] for FLUX (``config.depth_unified > 0``)."""

    def __init__(self, config: MMDiTConfig, final: bool = False,
                 quantize_bits: QuantBits = None):
        super().__init__()
        self.config = config
        self.final = final
        self.img = Projections(config, 6, quantize_bits=quantize_bits)
        self.txt = Projections(config, 2 if final else 6, with_mlp=not final,
                               quantize_bits=quantize_bits)

    def forward(
        self, img: torch.Tensor, txt: torch.Tensor, c: torch.Tensor, rope: Rope = None,
        sdpa_impl: Optional[str] = None, mesh=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        eps = cfg.layer_norm_eps
        img_mods = self.img.modulation(c)
        txt_mods = self.txt.modulation(c)

        img_h = _mod_ln_maybe_quant(self.img.q, img, img_mods[0], img_mods[1], eps)
        txt_h = _mod_ln_maybe_quant(self.txt.q, txt, txt_mods[0], txt_mods[1], eps)
        img_len, txt_len = img.shape[1], txt.shape[1]
        flux = cfg.depth_unified > 0
        rope_img = None if rope is None else (rope[0][txt_len:], rope[1][txt_len:])
        q_i, k_i, v_i = self.img.qkv(img_h, cfg.num_heads, rope_img if flux else None)
        q_t, k_t, v_t = self.txt.qkv(txt_h, cfg.num_heads)
        if flux:
            q, k, v = (torch.cat(p, dim=1) for p in ((q_t, q_i), (k_t, k_i), (v_t, v_i)))
        else:
            q, k, v = (torch.cat(p, dim=1) for p in ((q_i, q_t), (k_i, k_t), (v_i, v_t)))
            if rope is not None:
                cos, sin = (t[:, None, :] for t in rope)
                q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        o = sdpa(q, k, v, scale=1.0 / (cfg.head_dim**0.5), impl=sdpa_impl, mesh=mesh,
                 layout="bshd", head_group=self.img.head_group(cfg.head_dim)).flatten(2)
        o = self.img.attn_input(o, cfg.head_dim)
        if flux:
            o_txt, o_img = o[:, :txt_len], o[:, txt_len:]
        else:
            o_img, o_txt = o[:, :img_len], o[:, img_len:]

        img = img + img_mods[2] * linear(self.img.o, o_img)
        img = img + img_mods[5] * ffn_gelu(
            self.img.fc1, self.img.fc2,
            _mod_ln_maybe_quant(self.img.fc1, img, img_mods[3], img_mods[4], eps),
        )
        if self.final:
            return img, txt
        txt = txt + txt_mods[2] * linear(self.txt.o, o_txt)
        txt = txt + txt_mods[5] * ffn_gelu(
            self.txt.fc1, self.txt.fc2,
            _mod_ln_maybe_quant(self.txt.fc1, txt, txt_mods[3], txt_mods[4], eps),
        )
        return img, txt


class UnifiedBlock(Projections):
    """FLUX single-stream block over [text, image]: one AdaLN site feeds both
    the attention and, with the parallel MLP, the MLP (3 modulation vectors:
    shift, scale, gate); else a sequential MLP with its own site (6)."""

    def __init__(self, config: MMDiTConfig, quantize_bits: QuantBits = None):
        n_mod = 3 if config.parallel_mlp_for_unified_blocks else 6
        super().__init__(config, n_mod, quantize_bits=quantize_bits)
        self.config = config

    def forward(self, x: torch.Tensor, c: torch.Tensor, rope: Rope,
                sdpa_impl: Optional[str] = None, mesh=None) -> torch.Tensor:
        cfg = self.config
        eps = cfg.layer_norm_eps
        mods = self.modulation(c)
        h = _mod_ln_maybe_quant(self.q, x, mods[0], mods[1], eps)
        q, k, v = self.qkv(h, cfg.num_heads, rope)
        o = sdpa(q, k, v, scale=1.0 / (cfg.head_dim**0.5), impl=sdpa_impl, mesh=mesh,
                 layout="bshd", head_group=self.head_group(cfg.head_dim)).flatten(2)
        o = self.attn_input(o, cfg.head_dim)
        if cfg.parallel_mlp_for_unified_blocks:
            return x + mods[2] * (linear(self.o, o) + ffn_gelu(self.fc1, self.fc2, h))
        x = x + mods[2] * linear(self.o, o)
        return x + mods[5] * ffn_gelu(
            self.fc1, self.fc2, _mod_ln_maybe_quant(self.fc1, x, mods[3], mods[4], eps)
        )


class FinalLayer(nn.Module):
    """2-vector AdaLN + linear to patch features."""

    def __init__(self, config: MMDiTConfig):
        super().__init__()
        H, dt = config.hidden_size, config.dtype
        self.ada = nn.Linear(H, 2 * H, dtype=dt)
        self.linear = nn.Linear(H, config.patch_size**2 * config.vae_latent_dim, dtype=dt)


class MMDiT(nn.Module):
    """forward(latent NHWC, token embeddings, pooled, timestep[, guidance])
    -> velocity prediction NHWC.

    ``quantize_bits``: build the block linears packed (4 or 8 bits, group
    64) or as w8a8 ("w8a8"); the embedders and the final layer stay float,
    as in the reference's random quantized init."""

    def __init__(self, config: MMDiTConfig, quantize_bits: QuantBits = None):
        super().__init__()
        if quantize_bits not in (None, 4, 8, "w8a8"):
            raise ValueError(f"quantize_bits={quantize_bits!r}: None, 4, 8 or 'w8a8'")
        self.config = config
        H, dt, g = config.hidden_size, config.dtype, quantize_bits
        patch_in = config.vae_latent_dim * config.patch_size**2
        self.x_embedder = nn.Linear(patch_in, H, dtype=dt)
        self.context_embedder = nn.Linear(config.token_level_text_embed_dim, H, dtype=dt)
        self.y_embedder = MLPSiLU(config.pooled_text_embed_dim, H, dtype=dt)
        self.t_embedder = MLPSiLU(config.frequency_embed_dim, H, dtype=dt)
        self.guidance_embedder = (
            MLPSiLU(config.frequency_embed_dim, H, dtype=dt) if config.guidance_embed else None
        )
        learned = config.pos_embed_type == PositionalEncoding.LearnedInputEmbedding
        self.pos_embed = (
            nn.Parameter(torch.empty(config.max_latent_resolution**2, H, dtype=dt))
            if learned else None
        )
        flux = config.depth_unified > 0
        n_uniform = config.depth_multimodal - (0 if flux else 1)
        # The fp32-upcast blocks are built from an fp32 copy of the config.
        up_mm, up_uni = set(config.upcast_multimodal_blocks), set(config.upcast_unified_blocks)
        cfg32 = dataclasses.replace(config, dtype=torch.float32)
        self.mm_blocks = nn.ModuleList(
            MMBlock(cfg32 if i in up_mm else config, quantize_bits=g) for i in range(n_uniform))
        self.mm_final = None if flux else MMBlock(config, final=True, quantize_bits=g)
        self.uni_blocks = nn.ModuleList(
            UnifiedBlock(cfg32 if i in up_uni else config, quantize_bits=g)
            for i in range(config.depth_unified)
        )
        self.final_layer = FinalLayer(config)
        self._rope: Dict[tuple, Rope] = {}

    def rope_tables(self, hw: Tuple[int, int], txt_len: int, device) -> Rope:
        """The RoPE (cos, sin) tables of a sequence, made once per shape:
        they are host numpy copied to the device, a copy that a CUDA graph
        capture cannot take, so a captured forward finds them here."""
        key = (hw, txt_len, torch.device(device))
        if key not in self._rope:
            with torch.inference_mode(False):
                self._rope[key] = rope_frequencies(hw, txt_len, self.config.rope_axes_dim,
                                                   device=device)
        return self._rope[key]

    def forward(
        self,
        latent: torch.Tensor,
        token_level_text_embeddings: torch.Tensor,
        pooled_text_embeddings: torch.Tensor,
        timestep: torch.Tensor,
        guidance: Optional[torch.Tensor] = None,
        sdpa_impl: Optional[str] = None,
        mesh=None,
    ) -> torch.Tensor:
        """``sdpa_impl`` and ``mesh`` go to every joint attention's ``sdpa``
        (``ops/attention.py``): ``sdpa_impl="ring"`` with a mesh from
        ``parallel`` runs context-parallel ring attention. A model sharded
        over the mesh's ``model`` axis (``parallel/sharding``) runs its
        split linears and its attention on this rank's part (module
        docstring); the reference's ``fused_quant.disable_scope``, a GSPMD
        workaround, has no counterpart: the quantize kernels run under a
        mesh too, with the two-pass D and #4 where a row is split."""
        cfg = self.config
        b, lh, lw, _ = latent.shape
        dt, p = cfg.dtype, cfg.patch_size

        txt = linear(self.context_embedder, token_level_text_embeddings.to(dt))
        x = linear(self.x_embedder, patchify(latent.to(dt), p))

        h, w = lh // p, lw // p
        rope = None
        if self.pos_embed is not None:
            # Center-cropped learned position table; its size comes from the
            # weights (SD3-medium and SD3.5 ship different table sizes).
            maxhw = int(round(self.pos_embed.shape[0] ** 0.5))
            y0, x0 = (maxhw - h) // 2, (maxhw - w) // 2
            pos = self.pos_embed.reshape(maxhw, maxhw, cfg.hidden_size)
            x = x + pos[y0 : y0 + h, x0 : x0 + w].reshape(1, h * w, -1).to(dt)
        else:
            rope = self.rope_tables((h, w), txt.shape[1], x.device)

        c = self.t_embedder(
            timestep_embedding(timestep, cfg.frequency_embed_dim, cfg.max_period).to(dt)
        ) + self.y_embedder(pooled_text_embeddings.to(dt))
        if self.guidance_embedder is not None:
            if guidance is None:
                guidance = torch.full((b,), 3.5, dtype=torch.float32, device=x.device)
            c = c + self.guidance_embedder(
                timestep_embedding(guidance, cfg.frequency_embed_dim, cfg.max_period).to(dt)
            )

        attn = dict(sdpa_impl=sdpa_impl, mesh=mesh)
        for block in self.mm_blocks:
            if block.config.dtype != dt:  # an fp32-upcast block: the streams in fp32
                x, txt = (t.to(dt) for t in block(x.float(), txt.float(), c, rope, **attn))
            else:
                x, txt = block(x, txt, c, rope, **attn)
        if self.mm_final is not None:
            x, _ = self.mm_final(x, txt, c, rope, **attn)
        else:
            u = torch.cat([txt, x], dim=1)
            for block in self.uni_blocks:
                if block.config.dtype != dt:
                    u = block(u.float(), c, rope, **attn).to(dt)
                else:
                    u = block(u, c, rope, **attn)
            x = u[:, txt.shape[1]:].contiguous()

        fl = self.final_layer
        shift, scale = (m[:, None, :] for m in
                        gather_output(fl.ada, linear(fl.ada, F.silu(c))).chunk(2, dim=-1))
        x = _mod_ln_maybe_quant(fl.linear, x, shift, scale, cfg.layer_norm_eps)
        x = linear(fl.linear, x)
        if cfg.patchify_via_reshape:
            return unpack_flux(x, (lh, lw), p)
        return unpatchify_sd3(x, (lh, lw), p, cfg.vae_latent_dim)


@torch.no_grad()
def init_mmdit(
    config: MMDiTConfig, generator: torch.Generator, device="cuda", std: float = 0.02,
    quantize_bits: QuantBits = None,
) -> MMDiT:
    """Random MMDiT with checkpoint-compatible shapes, built directly on
    ``device`` from ``generator`` (which must live on that device): float
    weights ~ N(0, std), biases zero, QK-norm scales one; an fp32-upcast
    block's float weights are drawn in the model dtype and held in fp32, as
    the reference draws them in the model dtype and upcasts them. With
    ``quantize_bits`` 4 or 8 the block linears are drawn directly in the
    packed format at group 64 (``random_quantized_linear_``), with "w8a8" in
    the w8a8 format (``random_w8a8_linear_``), as the reference's
    ``init_mmdit_params(quantize_bits=...)`` does, so a 12B model never
    exists in float."""
    with torch.device("meta"):
        model = MMDiT(config, quantize_bits=quantize_bits)
    model.to_empty(device=device)
    for module in model.modules():
        if isinstance(module, QuantizedLinear):
            random_quantized_linear_(module, generator, std)
        elif isinstance(module, W8A8Linear):
            random_w8a8_linear_(module, generator, std)
        elif isinstance(module, QKNorm):
            module.q_scale.fill_(1.0)
            module.k_scale.fill_(1.0)
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif not name.endswith(("q_scale", "k_scale")):
            p.normal_(0.0, std, generator=generator)
            if p.dtype != config.dtype:  # an upcast block: the model dtype's values
                p.copy_(p.to(config.dtype))
    return model.eval()
