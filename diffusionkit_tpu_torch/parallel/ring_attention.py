"""Ring attention: context-parallel SDPA over a mesh axis.

Counterpart of ``diffusionkit_tpu/parallel/ring_attention.py``. Each rank
holds seq/N queries, keys and values; the K/V chunks rotate around the ring
of the mesh's ``model`` group (``dist.batch_isend_irecv`` to rank
``me + 1``) while an online-softmax accumulator builds the exact
full-attention result. Each ring step runs #14
(``ops/flash_attention.flash_attention_stats``) over the visiting chunk and
merges its (o, m, l) into the accumulator (``merge_chunk_stats``): the
multi-rank composition of the same online softmax the kernel runs over key
tiles. The next chunk's exchange is issued before the current chunk's
kernel and waited for after it.

The caller gives every rank the whole (B, H, S, D) tensors; S is padded to
a multiple of N and the padded keys are masked (``vlen``), each rank takes
its sequence slice (and its batch slice where the mesh's data axis divides
B), and the output is all-gathered back to every rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention_stats, flash_attention_stats_plain
from .mesh import axis_size

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def merge_chunk_stats(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                      o_i: torch.Tensor, m_i: torch.Tensor, l_i: torch.Tensor) -> Stats:
    """Merge one chunk's (o_i, m_i, l_i) into the running (m, l, acc), all
    fp32. The chunk output is normalised by l_i, so its unnormalised
    numerator is o_i * l_i; a fully masked chunk has l_i == 0 and drops
    out. Returns the new (m, l, acc)."""
    m_new = torch.maximum(m, m_i)
    c_old = torch.exp(m - m_new)
    c_new = l_i * torch.exp(m_i - m_new)
    return m_new, l * c_old + c_new, acc * c_old + o_i.float() * c_new


def _exchange(group, me: int, n: int, tensors):
    """Send ``tensors`` to ring neighbour me + 1 and receive the matching
    chunks of me - 1 into fresh contiguous buffers; returns (requests,
    buffers)."""
    send_to = dist.get_global_rank(group, (me + 1) % n)
    recv_from = dist.get_global_rank(group, (me - 1) % n)
    bufs = [torch.empty_like(t, memory_format=torch.contiguous_format) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, send_to, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, b, recv_from, group) for b in bufs]
    return dist.batch_isend_irecv(ops), bufs


def _ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, vlen: int,
                          scale: float, group, use_flash: bool) -> torch.Tensor:
    """The per-rank ring over ``group``: q/k/v (b, h, s_local, d) this
    rank's slices, ``vlen`` the number of valid (unpadded) global keys."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    s_local = q.shape[2]
    chunk = flash_attention_stats if use_flash else flash_attention_stats_plain
    # The collectives send contiguous tensors; a ring of one sends nothing
    # and the kernel reads the strided views in place.
    k_blk, v_blk = (k.contiguous(), v.contiguous()) if n > 1 else (k, v)
    for step in range(n):
        # The chunk held now came from rank (me - step) % n; its global keys
        # are [src * s_local, (src + 1) * s_local).
        src = (me - step) % n
        vlen_local = min(max(vlen - src * s_local, 0), s_local)
        pending = _exchange(group, me, n, (k_blk, v_blk)) if step < n - 1 else None
        o_i, m_i, l_i = chunk(q, k_blk, v_blk, scale, vlen_local)
        if step == 0:  # the first chunk seeds the accumulator
            m, l, acc = m_i, l_i, o_i * l_i
        else:
            m, l, acc = merge_chunk_stats(m, l, acc, o_i, m_i, l_i)
        if pending is not None:
            reqs, (k_blk, v_blk) = pending
            for req in reqs:
                req.wait()
    # Padded q rows attend to real keys, so l > 0 everywhere; guard anyway.
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather ``x`` over ``group`` and concatenate along ``dim``."""
    if dist.get_world_size(group) == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                   mesh, axis: str = "model", use_flash: Optional[bool] = None) -> torch.Tensor:
    """Exact full attention with the sequence split over the mesh axis
    ``axis``; every rank passes the whole q/k/v (B, H, S, D), any S, and
    gets the whole output.

    ``use_flash`` None or True: #14 per chunk (its plain version for a CPU
    tensor); False: the plain chunk body on any device, the reference's
    ``use_flash=False``. Both merge the same (o, m, l).
    """
    use_flash = True if use_flash is None else use_flash
    group = mesh.get_group(axis)
    n, me = dist.get_world_size(group), dist.get_rank(group)
    b, h, s, d = q.shape
    pad = (-s) % n
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
    s_local = (s + pad) // n
    # Keep the batch data-parallel where the data axis divides it.
    data_group = None
    if "data" in mesh.mesh_dim_names and b % axis_size(mesh, "data") == 0:
        data_group = mesh.get_group("data")
        per = b // dist.get_world_size(data_group)
        rows = slice(dist.get_rank(data_group) * per, (dist.get_rank(data_group) + 1) * per)
        q, k, v = (x[rows] for x in (q, k, v))
    seq = slice(me * s_local, (me + 1) * s_local)
    q, k, v = (x[:, :, seq] for x in (q, k, v))
    out = _ring_attention_local(q, k, v, s, scale, group, use_flash)
    out = _gather(out, 2, group)
    if data_group is not None:
        out = _gather(out, 0, data_group)
    return out[:, :, :s] if pad else out
