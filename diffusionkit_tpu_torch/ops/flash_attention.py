"""Non-causal flash attention: kernel B and kernels #14 and #15.

Replace the Pallas kernels of ``diffusionkit_tpu/ops/flash_attention.py``:

- kernel B, ``flash_attention_bshd``: (B, S, H, D), the row max unscaled
  with the scale folded into the exponent. It runs the SD3 joint attention
  (24 heads of d=64 over 1024 + 154 tokens at 512²), FLUX's joint attention
  (24 heads of d=128 over 256 + 4096 tokens at 1024²) and the VAE
  mid-block attention (one head of d=512);
- #15, ``flash_attention``: (B, H, S, D) with ``_flash_kernel``'s numerics
  (the scale before the max); ``ops/attention.sdpa`` reaches it for
  ``layout="bhsd"`` and under ``DIFFUSIONKIT_TPU_ATTN_LAYOUT=bhsd``;
- #14, ``flash_attention_stats``: #15 against a key chunk with ``vlen``
  valid leading keys, returning fp32 o, m and l for the ring attention's
  combiner (``parallel/ring_attention.py``).

bf16 inputs are compute-bound and run on the tensor cores with an
in-register online softmax, any strides read in place. Kernel B and #15 at
d=64 and 128, and #14 at d=128, run ``csrc/flash_attention_sm90.cu``, one
Hopper design: TMA loads into a ring of shared-memory stages fed by a
producer warp, and two consumer warpgroups issuing ``wgmma``. #14 at d=64
runs the same file's kernel for short ring chunks: 64-row blocks of one
consumer warpgroup, two blocks an SM, a chunk's keys fetched at once, o
stored by TMA. Kernel B and #15 at d=512 run
``csrc/flash_attention_wide_sm90.cu``: TMA and ``wgmma`` too, two consumer
warpgroups sharing 64 query rows, and the keys split into chunks
(``wide_split``) whose fp32 partials a merge kernel combines, from scratch
this module allocates. The note in each source has the details. fp32
inputs run ``csrc/flash_attention_f32.cu``, what the reference computes in
fp32 (fp32 scores, softmax and P.V, P not rounded): 3xTF32 products on the
tensor cores at every head dim, within 2^-16 of the largest |output| of the
fp32 plain version.

Each wrapper launches its kernel for a CUDA tensor and raises on what the
kernel does not take (bf16 or fp32, one dtype for q, k and v; d in
``SUPPORTED_HEAD_DIMS``, 64 and 128 for #14; a contiguous head dim and
16-byte aligned rows); a CPU tensor goes to its plain version, the same
numerics in plain torch with the score matrix materialised.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernels

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (64, 128, 512)
STATS_HEAD_DIMS = (64, 128)
# The d=512 bf16 kernel's head dim and its query / key tile.
WIDE_HEAD_DIM = 512
WIDE_TILE = 64


def flash_attention_bshd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """Plain torch version of kernel B's math: fp32 scores, the row max
    unscaled with ``scale`` folded into the exponent, P rounded to v's dtype
    before P.V with fp32 accumulation, divided by the fp32 row sum and
    rounded once."""
    if not scale > 0:
        raise ValueError(f"flash_attention_bshd requires scale > 0, got {scale}")
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp((s - m) * scale)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    return (pv / l).permute(0, 2, 1, 3).to(q.dtype).contiguous()


def flash_attention_stats_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, vlen: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of #14, and the ring's chunk body (the
    reference's ``_chunk_stats_xla``): s = (q k^T) * scale in fp32, keys at
    or past ``vlen`` at -1e30, m = max s, p = exp(s - m) zeroed on masked
    keys (a fully masked chunk has s == m there), l = sum p, and
    o = (p in v's dtype) . v / max(l, 1e-30) in fp32. Returns (o, m, l)
    with m and l (B, H, Sq, 1)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    valid = torch.arange(k.shape[-2], device=q.device) < vlen
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return o / l.clamp_min(1e-30), m, l


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """Plain torch version of #15: #14's math with every key valid, rounded
    once to q's dtype; a contiguous (B, H, S, D) tensor."""
    o, _, _ = flash_attention_stats_plain(q, k, v, scale, k.shape[-2])
    return o.to(q.dtype).contiguous()


def wide_chunk(s: int, n_split: int) -> int:
    """Keys a chunk when ``s`` keys are split ``n_split`` ways in whole
    WIDE_TILE-key tiles: the first chunks take this many, the last the
    rest."""
    tiles = -(-s // WIDE_TILE)
    return -(-tiles // n_split) * WIDE_TILE


def wide_split(b: int, h: int, s: int, sms: int) -> Tuple[int, int]:
    """(n_split, chunk) of the d=512 kernel: enough key chunks that the
    b * h * ceil(s / 64) query tiles fill ``sms`` SMs at least once (two
    chunks at the VAE's 4096 positions on 132 SMs, one at 16384), at least
    two key tiles a chunk, every chunk holding a key."""
    tiles = -(-s // WIDE_TILE)
    n = max(1, min(sms // (b * h * tiles), tiles // 2))
    chunk = wide_chunk(s, n)
    return -(-s // chunk), chunk


def flash_wide_partials_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, scale_first: bool,
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of the d=512 kernel's split-KV blocks on (B, H,
    S, D) inputs: for each chunk of ``chunk`` keys, kernel B's (or with
    ``scale_first`` #15's) numerics over the chunk alone. Returns the
    unnormalised fp32 accumulators (n, B, H, S, D), the row maxima in the
    exponent's units, m * scale (B) or m (#15), and the row sums l (n, B,
    H, S)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    c = 1.0
    if scale_first:
        s = s * scale
    else:
        c = scale
    outs, ms, ls = [], [], []
    for k0 in range(0, k.shape[-2], chunk):
        si = s[..., k0:k0 + chunk]
        m = si.amax(dim=-1, keepdim=True)
        p = torch.exp((si - m) * c)
        ls.append(p.sum(dim=-1))
        ms.append(m[..., 0] * c)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                                 v[..., k0:k0 + chunk, :].float()))
    return torch.stack(outs), torch.stack(ms), torch.stack(ls)


def flash_wide_merge_plain(
    o: torch.Tensor, m: torch.Tensor, l: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """Plain torch version of the merge kernel: chunk i weighted by
    exp(m_i - max m), the weighted accumulators over the weighted l, rounded
    once to ``dtype``; (n, B, H, S, D) partials -> (B, H, S, D)."""
    w = torch.exp(m - m.amax(dim=0))
    out = (w[..., None] * o).sum(dim=0) / (w * l).sum(dim=0)[..., None]
    return out.to(dtype)


# The C entry points of each wrapper by input dtype.
_ENTRIES = {
    "flash_attention_bshd": {torch.bfloat16: "dk_flash_attn_bf16",
                             torch.float32: "dk_flash_attn_f32"},
    "flash_attention": {torch.bfloat16: "dk_flash_attn_bhsd_bf16",
                        torch.float32: "dk_flash_attn_bhsd_f32"},
    "flash_attention_stats": {torch.bfloat16: "dk_flash_attn_stats_bf16",
                              torch.float32: "dk_flash_attn_stats_f32"},
}


def _check_inputs(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, head_dims) -> str:
    """What the CUDA kernels take: 4-d bf16 or fp32 tensors of one dtype on
    q's device, a head dim in ``head_dims``, a contiguous head dim and
    16-byte aligned rows (strides in elements a multiple of 16 bytes).
    Returns the C entry point for the dtype."""
    if not scale > 0:
        raise ValueError(f"{name} requires scale > 0, got {scale}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"{name}: q, k, v must be 4-d, got {q.ndim}, {k.ndim}, {v.ndim}")
    if q.shape[-1] not in head_dims:
        raise ValueError(f"{name}: head dim {q.shape[-1]} not in {head_dims}")
    entries = _ENTRIES[name]
    if q.dtype not in entries:
        raise TypeError(f"{name}: q must be bf16 or fp32, got {q.dtype}")
    per_row = 16 // q.element_size()
    for label, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name}: {label} must be {q.dtype} on {q.device}, got {t.dtype} "
                            f"on {t.device}")
        if t.stride(3) != 1 or any(st % per_row for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"{name}: {label} needs a contiguous head dim and 16-byte "
                f"aligned rows, got strides {t.stride()}"
            )
    return entries[q.dtype]


def _on_cuda(name: str, q: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one (the plain version);
    raises on any other device."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    return q.device.type == "cuda"


def _bshd_strides(t: torch.Tensor, layout: str):
    """(batch, sequence, head) strides of a (B, S, H, D) or (B, H, S, D)
    tensor, the order the C entry points take."""
    st = t.stride()
    return (st[0], st[1], st[2]) if layout == "bshd" else (st[0], st[2], st[1])


def _launch_wide(q, k, v, out, layout: str, scale: float,
                 n_split: Optional[int] = None) -> None:
    """Kernel B ("bshd") or #15 ("bhsd") at d=512 in bf16: the split-KV
    kernel, then (with more than one chunk) the merge kernel, from one C
    entry, into ``out``.
    The chunks' fp32 scratch is allocated here; ``n_split`` defaults to
    ``wide_split`` for the card's SM count."""
    b, s = q.shape[0], q.shape[1 if layout == "bshd" else 2]
    h = q.shape[2 if layout == "bshd" else 1]
    if n_split is None:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        n_split, chunk = wide_split(b, h, s, sms)
    else:
        chunk = wide_chunk(s, n_split)
        if -(-s // chunk) != n_split:
            raise ValueError(f"{s} keys do not split into {n_split} chunks of whole tiles")
    scratch = [None, None, None]
    if n_split > 1:
        scratch = [torch.empty((n_split, b, h, s, WIDE_HEAD_DIM), dtype=torch.float32,
                               device=q.device),
                   *(torch.empty((n_split, b, h, s), dtype=torch.float32, device=q.device)
                     for _ in range(2))]
    strides = [st for t in (q, k, v, out) for st in _bshd_strides(t, layout)]
    err = kernels.library().dk_flash_attn_wide_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *(t.data_ptr() if t is not None else None for t in scratch), b, s, h, *strides,
        float(scale), int(layout == "bhsd"), n_split, chunk, kernels.stream_ptr(q.device),
    )
    kernels.check(err, "flash_attention_bshd" if layout == "bshd" else "flash_attention")


def flash_attention_bshd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, S, H, D) inputs; returns a
    contiguous (B, S, H, D) tensor in q's dtype.

    On CUDA: bf16 or fp32, D in SUPPORTED_HEAD_DIMS, a contiguous head dim
    and 16-byte aligned rows; other strides are read in place.
    """
    if not _on_cuda("flash_attention_bshd", q):
        return flash_attention_bshd_plain(q, k, v, scale)
    entry = _check_inputs("flash_attention_bshd", q, k, v, scale, SUPPORTED_HEAD_DIMS)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_attention_bshd: q, k, v must share one (B, S, H, D) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if q.dtype == torch.bfloat16 and d == WIDE_HEAD_DIM:
        _launch_wide(q, k, v, out, "bshd", scale)
    else:
        strides = [st for t in (q, k, v, out) for st in _bshd_strides(t, "bshd")]
        err = getattr(kernels.library(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d,
            *strides, float(scale), kernels.stream_ptr(q.device),
        )
        kernels.check(err, "flash_attention_bshd")
    flash_attention_bshd.launches += 1
    flash_attention_bshd.f32_launches += q.dtype == torch.float32
    return out


flash_attention_bshd.launches = 0
flash_attention_bshd.f32_launches = 0  # of them, on fp32 inputs


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """#15: softmax((q k^T) * scale) v over (B, H, S, D) inputs, the scale
    applied before the row max; returns a contiguous (B, H, S, D) tensor in
    q's dtype.

    On CUDA: bf16 or fp32, D in SUPPORTED_HEAD_DIMS, a contiguous head dim
    and 16-byte aligned rows; other strides (a transposed (B, S, H, D) view)
    are read in place.
    """
    if not _on_cuda("flash_attention", q):
        return flash_attention_plain(q, k, v, scale)
    entry = _check_inputs("flash_attention", q, k, v, scale, SUPPORTED_HEAD_DIMS)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_attention: q, k, v must share one (B, H, S, D) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, s, d = q.shape
    out = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    if q.dtype == torch.bfloat16 and d == WIDE_HEAD_DIM:
        _launch_wide(q, k, v, out, "bhsd", scale)
    else:
        strides = [st for t in (q, k, v, out) for st in _bshd_strides(t, "bhsd")]
        err = getattr(kernels.library(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d,
            *strides, float(scale), kernels.stream_ptr(q.device),
        )
        kernels.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_stats(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, vlen: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """#14: q (B, H, Sq, D) against a key chunk k/v (B, H, Skv, D) whose
    first ``vlen`` keys are valid (a host int, clamped to [0, Skv]).

    Returns (o, m, l): o fp32 (B, H, Sq, D) normalised over the chunk, m the
    row max of the scaled scores and l the row sum, fp32 (B, H, Sq, 1). A
    fully masked chunk gives o = 0, l = 0 and m = -1e30.

    On CUDA: bf16 or fp32, D in STATS_HEAD_DIMS (the MMDiT head dims), a
    contiguous head dim and 16-byte aligned rows; other strides are read in
    place.
    """
    vlen = max(0, min(int(vlen), k.shape[-2]))
    if not _on_cuda("flash_attention_stats", q):
        return flash_attention_stats_plain(q, k, v, scale, vlen)
    entry = _check_inputs("flash_attention_stats", q, k, v, scale, STATS_HEAD_DIMS)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if k.shape != (b, h, skv, d) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention_stats: q (B, H, Sq, D) and k, v (B, H, Skv, D) must agree, "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    o = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h, sq, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h, sq, 1), dtype=torch.float32, device=q.device)
    strides = [st for t in (q, k, v, o) for st in _bshd_strides(t, "bhsd")]
    err = getattr(kernels.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(),
        b, h, sq, skv, d, vlen, *strides, float(scale), kernels.stream_ptr(q.device),
    )
    kernels.check(err, "flash_attention_stats")
    flash_attention_stats.launches += 1
    return o, m, l


flash_attention_stats.launches = 0
