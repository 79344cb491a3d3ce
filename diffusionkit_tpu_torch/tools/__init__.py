"""On-chip A/B tools of the port, and what they share.

Counterparts of the reference's ``tools/bench_w4a8_mat.py`` and
``tools/microbench_pallas_int8.py``:

    python -m diffusionkit_tpu_torch.tools.bench_w4a8_mat [M K N [iters]]
    python -m diffusionkit_tpu_torch.tools.microbench_int8 [M K N [iters]]

``bench_flash`` (the flash kernels beside the library's attention, timed
by ``device_ms``), ``bench_gemv`` (the M <= 16 GEMVs of kernels C, #13, E
and #11, timed warm by ``device_ms`` and cold by ``device_ms_cold``) and
``bench_rows`` (the row kernels A', D and #4, timed the same way):

    python -m diffusionkit_tpu_torch.tools.bench_flash [B,S,H,D ...]
    python -m diffusionkit_tpu_torch.tools.bench_gemv [M,K,N[,group] ...]
    python -m diffusionkit_tpu_torch.tools.bench_rows [name:d0,d1[,d2] ...]

``quant_quality`` (the counterpart of the JAX repo's ``tools/quant_quality.py``:
SD3-medium from ``DIFFUSIONKIT_TPU_CKPT_DIR`` once in bf16 and once per
quantize mode, each image's PSNR against the bf16 one; on the card unless
given ``--device cpu``):

    python -m diffusionkit_tpu_torch.tools.quant_quality [--steps 10] [--size 512] [--modes ...]

``profile_step`` and ``t5_outlier_ab`` (the counterparts of the JAX repo's
``tools/profile_step.py`` and ``tools/t5_outlier_ab.py``: one denoise
step's device time by kernel category, and the SmoothQuant fold's A/B at
the T5 encoder's output):

    python -m diffusionkit_tpu_torch.tools.profile_step [sd3|flux-int4|flux-w4a8|sd35-w4a8] [out.json]
    python -m diffusionkit_tpu_torch.tools.t5_outlier_ab [out.json]

The first two have ``run(M, K, N, iters, device="cuda")``, which returns its rows,
and ``main``, which prints them. A row is timed as the reference times it:
a chain of ``iters`` calls, each fed the previous call's output through
the tool's ``feed`` (clipped to int8), after one untimed call. On the card
the chain sits between two CUDA events; with ``device="cpu"`` (the tests)
the host clock times the plain versions, which says nothing of the card.
A row that fails raises.
"""

from __future__ import annotations

import statistics
import sys
import time
from typing import Callable, List, Optional, Tuple

import torch

DEFAULT_SHAPE = (4352, 3072, 12288)  # FLUX.1-schnell 1024²'s unified fc1 (M, K, N)
DEFAULT_ITERS = 16


def widen(y: torch.Tensor, k: int) -> torch.Tensor:
    """The first ``k`` columns of y, tiled along columns first where y has
    fewer (the reference's ``feed``: the next call's (M, K) input)."""
    if y.shape[1] < k:
        y = y.repeat(1, -(-k // y.shape[1]))
    return y[:, :k]


def chain(step: Callable, x0: torch.Tensor, iters: int,
          feed: Callable) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """``step(x0)`` once, untimed, then ``iters`` calls in a chain, call
    i + 1 on ``feed`` of call i's output. Returns (the first output, the
    last output, ms per call): CUDA events on the card, the host clock on
    the CPU."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    y0 = step(x0)
    x, y = x0, y0
    if x0.device.type == "cuda":
        torch.cuda.synchronize(x0.device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            y = step(x)
            x = feed(y)
        end.record()
        end.synchronize()
        return y0, y, start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        y = step(x)
        x = feed(y)
    return y0, y, 1e3 * (time.perf_counter() - t0) / iters


def row(name: str, step: Callable, x0: torch.Tensor, iters: int, feed: Callable,
        ops: float, unit: str) -> dict:
    """One timed row: its name, ms per call, rate in ``unit`` (TOP/s or
    TFLOP/s of ``ops`` per call), the first and last outputs."""
    y0, y, ms = chain(step, x0, iters, feed)
    return {"name": name, "ms": ms, "rate": ops / (ms / 1e3) / 1e12, "unit": unit,
            "y0": y0, "y": y}


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph and
    replayed between two CUDA events, so no host launch cost sits between
    the launches (a short kernel launched from Python would otherwise be
    timed at the host's pace). Median of 5 replays, divided by ``reps``.
    Inputs stay resident in L2 where they fit, as right after their
    producer in the model."""
    return _graph_ms([fn], reps, warmups=3)


def device_ms_cold(fns: List[Callable], rounds: int = 2) -> float:
    """Device time of one call with its inputs cold in L2: ``fns`` call one
    function on distinct copies of its inputs, more bytes together than the
    card's 50 MB L2 (callers give over 100 MB), so that the calls between
    two calls of one copy evict it, as the 38-77 ``ada`` weights of a
    denoise step are each read once. ``rounds`` passes over ``fns`` in one
    CUDA graph, timed as ``device_ms``'s."""
    return _graph_ms(fns, rounds, warmups=1)


def _graph_ms(fns: List[Callable], rounds: int, warmups: int) -> float:
    """``warmups`` eager passes over ``fns``, then ``rounds`` passes captured
    in one CUDA graph; the median of 5 timed replays over the calls."""
    for _ in range(warmups):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            for fn in fns:
                fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / (rounds * len(fns)))
    return statistics.median(times)


def device_label(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu (host clock; the plain versions)"


def parse_args(argv: Optional[List[str]]) -> Tuple[int, int, int, int]:
    """``M K N [iters]`` from ``argv`` (sys.argv[1:] by default), with the
    reference's defaults."""
    argv = sys.argv[1:] if argv is None else argv
    m, k, n = (int(a) for a in argv[:3]) if len(argv) >= 3 else DEFAULT_SHAPE
    iters = int(argv[3]) if len(argv) > 3 else DEFAULT_ITERS
    return m, k, n, iters


def print_rows(rows: List[dict], device: torch.device, shape) -> None:
    print(f"(M, K, N) {tuple(shape)} on {device_label(device)}", flush=True)
    for r in rows:
        print(f"{r['name']:10s} {r['ms']:10.4f} ms  {r['rate']:8.1f} {r['unit']}", flush=True)
