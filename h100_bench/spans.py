"""The benchmark's own spans: forward hooks on the pipeline's text
encoders, VAE decoder and VAE encoder, each recording a CUDA event, and in
the profiled iterations a marker kernel, so that the profiler's kernels can
be told apart by the span they ran in. Nothing in the program is edited.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

# module attribute -> span kind
HOOKED = {"clip_l": "text", "clip_g": "text", "t5": "text", "decoder": "decode",
          "encoder": "vae_encode"}
MARKER_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel


class HostEvent:
    """A CUDA event's interface on the host clock, for runs without a card
    (the CPU tests)."""

    def __init__(self, enable_timing: bool = True):
        self.t = None

    def record(self) -> None:
        self.t = time.perf_counter()

    def elapsed_time(self, other: "HostEvent") -> float:
        return 1e3 * (other.t - self.t)


class Spans:
    """Per iteration, the events of each hooked forward, in order."""

    def __init__(self, pipe):
        self.cuda = pipe.device.type == "cuda"
        self.iters: List[List[Tuple[str, str, torch.cuda.Event]]] = []
        self.markers: List[str] = []  # labels of the marker kernels, in launch order
        self.marking = False
        self.recording = False
        self._handles = []
        for attr, kind in HOOKED.items():
            module = getattr(pipe, attr, None)
            if module is None:
                continue
            self._handles.append(module.register_forward_pre_hook(self._hook(kind, "pre")))
            self._handles.append(module.register_forward_hook(self._hook(kind, "post")))

    def _event(self, label: str) -> torch.cuda.Event:
        if self.marking and self.cuda:
            torch.cuda._sleep(1)
            self.markers.append(label)
        ev = (torch.cuda.Event if self.cuda else HostEvent)(enable_timing=True)
        ev.record()
        return ev

    def _hook(self, kind: str, edge: str):
        def hook(*_args):
            if self.recording and self.iters:
                self.iters[-1].append((kind, edge, self._event(f"{kind}_{edge}")))
        return hook

    def begin(self, marking: bool = False) -> None:
        """A new iteration; ``marking``: launch marker kernels in it."""
        self.marking = marking
        self.recording = True
        self.iters.append([("iter", "pre", self._event("iter_pre"))])

    def end(self) -> None:
        self.iters[-1].append(("iter", "post", self._event("iter_post")))
        self.recording = False
        self.marking = False

    def close(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []

    def seconds(self, skip: int = 0) -> Dict[str, float]:
        """Seconds in each kind of span, summed over the iterations after the
        first ``skip``, with ``denoise``: from the last text encoder's end
        to the decoder's first start, less any VAE encode between. Call
        after a synchronise."""
        out = {"text": 0.0, "decode": 0.0, "vae_encode": 0.0, "denoise": 0.0,
               "text_calls": 0, "decode_calls": 0, "vae_encode_calls": 0, "iterations": 0}
        for evs in self.iters[skip:]:
            open_: Dict[str, torch.cuda.Event] = {}
            last_text: Optional[torch.cuda.Event] = None
            first_dec: Optional[torch.cuda.Event] = None
            enc_between = 0.0
            for kind, edge, ev in evs:
                if kind == "iter":
                    continue
                if edge == "pre":
                    open_[kind] = ev
                    if kind == "decode" and first_dec is None:
                        first_dec = ev
                    continue
                dt = open_.pop(kind).elapsed_time(ev) / 1e3
                out[kind] += dt
                out[kind + "_calls"] += 1
                if kind == "text":
                    last_text = ev
                elif kind == "vae_encode" and first_dec is None:
                    enc_between += dt
            if last_text is not None and first_dec is not None:
                out["denoise"] += last_text.elapsed_time(first_dec) / 1e3 - enc_between
            out["iterations"] += 1
        return out
