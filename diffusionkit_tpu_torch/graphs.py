"""One denoise step as a CUDA graph, replayed once a step.

The reference runs its whole schedule as one compiled program
(``diffusionkit_tpu/pipeline.py`` ``_denoise_scan``, a ``lax.scan`` over
the CFG + Euler step). On the card its counterpart is a CUDA graph of one
step: the step reads its sigmas from a device buffer at a device step
index that it advances itself, so a replay takes the next step, and the
host launches the whole schedule as n replays with no synchronisation in
between.

``StepGraph`` holds the capture. Its first ``run`` runs the step once
eagerly on a side stream (the warm-up, and the schedule's real first
step: it builds the kernel library at first use, makes cuBLAS's handle
and workspace for that stream, and fills what the forward makes lazily,
such as the RoPE tables), then captures the step on the same stream and
replays it for the remaining steps. Every kernel launches on the current
stream (``ops/kernels.stream_ptr``), so the hand-written kernels land in
the graph with the library's. What a capture cannot take raises: there is
no silent fallback to the eager loop.

The wrappers count launches in Python, which a replay does not run, so
the counters' delta over the capture (``ops/launches``) is taken back
after it (nothing ran) and added once for each replay.

``StepGraph.capture_s`` sums the seconds of every warm-up and capture in
the process (the capture's start waits for the warm-up), so a caller reads
its change over a call: the pipelines' ``capture_time``; ``captures``
counts the captures.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from .ops import launches


class StepGraph:
    """``step``, a function of no arguments that works in place on static
    tensors of one CUDA device, captured once and replayed."""

    capture_s = 0.0  # every StepGraph's warm-ups and captures, in seconds
    captures = 0  # every StepGraph's captures

    def __init__(self, step: Callable[[], None], device: torch.device):
        self.step = step
        self.device = device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.counts: Optional[launches.Counts] = None

    def _capture(self) -> None:
        t0 = time.perf_counter()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self.step()  # the warm-up: eager, counted as it launches
        graph = torch.cuda.CUDAGraph()
        before = launches.snapshot()
        with torch.cuda.graph(graph, stream=stream):
            self.step()
        self.counts = launches.delta(before, launches.snapshot())
        launches.add(self.counts, -1)  # the capture launched nothing
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self.graph = graph
        StepGraph.capture_s += time.perf_counter() - t0
        StepGraph.captures += 1

    def run(self, steps: int) -> None:
        """Take ``steps`` steps: on the first call the eager warm-up is the
        first of them, the rest are replays. The host does not wait."""
        if steps < 1:
            return
        if self.graph is None:
            self._capture()
            steps -= 1
        for _ in range(steps):
            self.graph.replay()
            launches.add(self.counts)
