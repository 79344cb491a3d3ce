"""The collectives of tensor and data parallelism, counted.

Counterpart of the collectives XLA inserts under the reference's GSPMD
plan (``diffusionkit_tpu/parallel/sharding.py``): the sum all-reduce of a
row-parallel linear's partial products over ``model``, the max all-reduce
of a row scale across shards (the two-pass quantizers,
``ops/fused_quant.py``), and the all-gathers of the modulation vectors
over ``model`` and of the denoised latents over ``data``.

Every function takes the process group of one mesh axis
(``mesh.group(mesh, name)``); a group of None or of one rank is the
identity and issues nothing, so a one-rank mesh runs, and captures, as no
mesh does. A gloo group carries CUDA tensors as they are when several
ranks share a card: gloo (torch 2.11) takes all three collectives on CUDA
tensors, staging them through the host itself, so nothing is staged here;
its point-to-point ``send`` / ``recv`` (the split w4a8 FFN's chain of fp32
partial sums, ``ops/common``) go through host copies, and ``broadcast``
hands the chain's end to every rank. A failed collective raises; nothing
here catches it.

``stats`` counts each call issued, its elements and its host seconds, by
kind, and how many calls of each size (a small fixed set: the activation,
modulation and row-scale shapes), so it stays bounded however long a
process runs: ``stats.reset()`` before a window, ``stats.snapshot()``
after.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Dict

import torch
import torch.distributed as dist


class Stats:
    """Calls, elements and host seconds of the collectives issued, by kind;
    ``sizes[kind]`` counts the calls of each element count."""

    KINDS = ("all_reduce_sum", "all_reduce_max", "all_gather", "send", "broadcast")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls: Dict[str, int] = dict.fromkeys(self.KINDS, 0)
        self.elements: Dict[str, int] = dict.fromkeys(self.KINDS, 0)
        self.seconds: Dict[str, float] = dict.fromkeys(self.KINDS, 0.0)
        self.sizes: Dict[str, Counter] = {k: Counter() for k in self.KINDS}

    def record(self, kind: str, numel: int, seconds: float) -> None:
        self.calls[kind] += 1
        self.elements[kind] += numel
        self.seconds[kind] += seconds
        self.sizes[kind][numel] += 1

    def snapshot(self) -> dict:
        return {k: {"calls": self.calls[k], "elements": self.elements[k],
                    "seconds": self.seconds[k]} for k in self.KINDS}


stats = Stats()


def group_size(group) -> int:
    """Ranks in ``group``; 1 for None."""
    return 1 if group is None else dist.get_world_size(group)


def _all_reduce(t: torch.Tensor, group, op, kind: str) -> torch.Tensor:
    if group_size(group) == 1:
        return t
    t0 = time.perf_counter()
    if not t.is_contiguous():
        raise ValueError(f"{kind}: the tensor must be contiguous")
    dist.all_reduce(t, op=op, group=group)
    stats.record(kind, t.numel(), time.perf_counter() - t0)
    return t


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """t summed over ``group``, in place (every rank gets the same sum);
    returns t."""
    return _all_reduce(t, group, dist.ReduceOp.SUM, "all_reduce_sum")


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of t over ``group``, in place; returns t."""
    return _all_reduce(t, group, dist.ReduceOp.MAX, "all_reduce_max")


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's t concatenated along ``dim`` in the group's rank order
    (each rank's t of the same shape)."""
    n = group_size(group)
    if n == 1:
        return t
    t0 = time.perf_counter()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    out = torch.cat(parts, dim=dim)
    stats.record("all_gather", out.numel(), time.perf_counter() - t0)
    return out


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """The group's rank ``src``'s t on every rank, in place; returns t."""
    if group_size(group) == 1:
        return t
    t0 = time.perf_counter()
    if not t.is_contiguous():
        raise ValueError("broadcast: the tensor must be contiguous")
    dist.broadcast(t, dist.get_global_rank(group, src), group=group)
    stats.record("broadcast", t.numel(), time.perf_counter() - t0)
    return t


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """t as this group's point-to-point calls take it: on the host for a
    gloo group."""
    return t.cpu() if t.is_cuda and dist.get_backend(group) == "gloo" else t


def send(t: torch.Tensor, dst: int, group) -> None:
    """t to the group's rank ``dst``; returns when it is sent."""
    t0 = time.perf_counter()
    dist.send(_staged(t.contiguous(), group), dist.get_global_rank(group, dst), group=group)
    stats.record("send", t.numel(), time.perf_counter() - t0)


def recv(shape, dtype: torch.dtype, device, src: int, group) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` from the group's rank ``src``, on
    ``device``."""
    buf = _staged(torch.empty(shape, dtype=dtype, device=device), group)
    dist.recv(buf, dist.get_global_rank(group, src), group=group)
    return buf.to(device)
