"""The entries a cell drives, by the cell file's ``entry``:

- ``batched``: a closed loop of one client calling
  ``generate_images_batched`` with ``batch`` prompts, back to back;
- ``img2img``: a closed loop of one client calling ``generate_image`` with
  an ``image_path`` and ``denoise``;
- ``serve``: an open loop of client threads calling
  ``GenerationServer.generate`` in this process, each when it is due.

Each entry warms up the shapes its traffic uses (set-up), then measures
for ``seconds``. In a traced run the profiler covers ``trace.iterations``
more iterations after the window (closed loops), or the window's last
``trace.seconds`` (open loop). It returns the outputs due in the window,
for the check, and what the metrics read.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import spans as spans_mod
import traffic
import trace as trace_mod


def _profiler(device):
    """The device's activities only: recording the host's ops would slow the
    eager parts (text encoders, VAE) and read as device idle time. (The
    host's, on a machine without a card: the CPU tests.)"""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    return profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _u8(images) -> List[np.ndarray]:
    return [np.asarray(im) for im in (images if isinstance(images, list) else [images])]


class Result:
    def __init__(self):
        self.outputs: List[Dict] = []  # {"request": ..., "image": uint8 array}
        self.attempted = 0
        self.failed = 0
        self.e2e: Dict[str, float] = {}
        self.trace: Optional[Dict] = None
        self.spans: Optional[Dict] = None
        self.server: Optional[Dict] = None
        self.notes: List[str] = []
        self.latency_by_due: List = []  # (due s, latency s) of each completed request


def _shape(t: Dict):
    return (t["height"] // 8, t["width"] // 8)


def _closed(pipe, cell: Dict, seed: int, seconds: float, traced: bool, device,
            setup_done, call, unit_images: int, requests) -> Result:
    """A closed loop: ``call(reqs)`` -> images, on ``requests`` batches."""
    res = Result()
    for _ in range(cell.get("warm_calls", 1)):
        call(next(requests["warm"]))
    _sync(device)
    sp = spans_mod.Spans(pipe)
    setup_done()
    t0 = time.perf_counter()
    it, times = 0, []
    while time.perf_counter() - t0 < seconds:
        reqs = next(requests["window"])
        sp.begin()
        ts = time.perf_counter()
        try:
            images = call(reqs)
        except Exception as e:  # a request that fails counts as failed
            res.failed += len(reqs)
            res.notes.append(f"iteration {it}: {type(e).__name__}: {e}")
            images = []
        sp.end()
        res.attempted += len(reqs)
        for r, im in zip(reqs, images):
            res.outputs.append({"request": r, "image": im})
        times.append(time.perf_counter() - ts)
        it += 1
    _sync(device)
    wall = time.perf_counter() - t0
    res.e2e["images_per_min"] = len(res.outputs) * 60.0 / wall
    res.spans = sp.seconds()
    res.spans["steps_per_iteration"] = cell["steps_run"]
    res.notes.append(f"{it} iterations of {unit_images} images in {wall!r} s; first "
                     f"{times[0]!r} s, median {float(np.median(times))!r} s, last {times[-1]!r} s")
    n_trace = cell.get("trace", {}).get("iterations", 0) if traced else 0
    if n_trace:
        # The traced window: the same traffic's next iterations, after the
        # measured one, with marker kernels at the spans' edges.
        prof = _profiler(device)
        prof.start()
        tt = time.perf_counter()
        for _ in range(n_trace):
            sp.begin(marking=True)
            call(next(requests["window"]))
            sp.end()
        _sync(device)
        window = time.perf_counter() - tt
        prof.stop()
        res.trace = trace_mod.summarize(prof, sp.markers, window)
        res.trace["iterations"] = n_trace
    sp.close()
    return res


def batched(pipe, cell: Dict, seed: int, seconds: float, traced: bool, device,
            setup_done) -> Result:
    t = cell["traffic"]
    b = t["batch"]

    def call(reqs):
        return _u8(pipe.generate_images_batched(
            [r["prompt"] for r in reqs], num_steps=t["steps"], cfg_weight=t["cfg"],
            latent_size=_shape(t), seeds=[r["seed"] for r in reqs]))

    reqs = {"warm": traffic.batches(t, seed + 1, b), "window": traffic.batches(t, seed, b)}
    return _closed(pipe, cell, seed, seconds, traced, device, setup_done, call, b, reqs)


def img2img(pipe, cell: Dict, seed: int, seconds: float, traced: bool, device,
            setup_done) -> Result:
    from PIL import Image

    t = cell["traffic"]
    folder = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"h100bench-src-{os.getpid()}")
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i in range(t["sources"]):
        p = os.path.join(folder, f"source{i}.png")
        Image.fromarray(traffic.source_image(seed, i, t["height"], t["width"])).save(p)
        paths.append(p)

    def call(reqs):
        out = []
        for r in reqs:
            image, _ = pipe.generate_image(
                r["prompt"], num_steps=t["steps"], cfg_weight=t["cfg"], latent_size=_shape(t),
                seed=r["seed"], verbose=False, image_path=paths[r["source"]],
                denoise=t["denoise"])
            out += _u8(image)
        return out

    reqs = {"warm": traffic.batches(t, seed + 1, 1), "window": traffic.batches(t, seed, 1)}
    try:
        return _closed(pipe, cell, seed, seconds, traced, device, setup_done, call, 1, reqs)
    finally:
        cell["_cleanup"] = folder


def rank(lats: List[float], q: float) -> float:
    """The ``q`` quantile of sorted latencies by rank: the smallest value
    with at least ``q`` of them at or below it."""
    return lats[max(0, int(np.ceil(q * len(lats))) - 1)]


def serve(pipe, cell: Dict, seed: int, seconds: float, traced: bool, device,
          setup_done, rate: Optional[float] = None) -> Result:
    from diffusionkit_tpu_torch.serve import GenerationServer

    t = dict(cell["traffic"])
    if rate is not None:
        t["rate"] = rate
    server = cell.get("_server")
    if server is None:
        server = GenerationServer(pipe, default_steps=t["steps"], default_cfg=t["cfg"],
                                  max_batch=t["max_batch"], max_queue=t["max_queue"],
                                  request_timeout_s=t["timeout_s"])
        server.warmup({"steps": t["steps"], "cfg": t["cfg"], "height": t["height"],
                       "width": t["width"], "batch": t["max_batch"]})
        cell["_server"] = server
    _sync(device)
    before = server.metrics()
    occ_before = len(server._occupancy)
    schedule = traffic.arrivals(t, seed, seconds)
    res = Result()
    lock = threading.Lock()
    done: Dict[int, float] = {}
    lateness = []

    def client(i, req, due_abs):
        body = {"prompt": req["prompt"], "seed": req["seed"], "steps": t["steps"],
                "cfg": t["cfg"], "height": t["height"], "width": t["width"]}
        try:
            images = server.generate(body)
            end = time.perf_counter()
            with lock:
                done[i] = end - due_abs
                res.outputs.append({"request": req, "image": np.asarray(images[0])})
        except Exception as e:  # refused, timed out or failed: misses every limit
            with lock:
                res.notes.append(f"request {i}: {type(e).__name__}: {e}")

    # traced runs: the profiler covers the window's last ``trace.seconds``
    trace_s = cell.get("trace", {}).get("seconds", 0) if traced else 0
    prof, traced_window, trace_t0 = None, None, None
    setup_done()
    t0 = time.perf_counter()
    threads = []
    for i, (due, req) in enumerate(schedule):
        now = time.perf_counter()
        if trace_s and prof is None and now - t0 >= seconds - trace_s:
            prof = _profiler(device)
            prof.start()
            trace_t0 = time.perf_counter()
        if t0 + due > now:
            time.sleep(t0 + due - now)
        lateness.append(time.perf_counter() - (t0 + due))
        th = threading.Thread(target=client, args=(i, req, t0 + due), daemon=True)
        th.start()
        threads.append(th)
    close = t0 + seconds
    while time.perf_counter() < close:
        time.sleep(0.01)
    if prof is not None:
        _sync(device)
        traced_window = time.perf_counter() - trace_t0
        prof.stop()
    for th in threads:  # a minute past the close at most
        th.join(timeout=max(0.0, close + 60.0 - time.perf_counter()))
    if prof is not None:  # read after the window, off the dispatcher's path
        res.trace = trace_mod.summarize(prof, [], traced_window)
    res.attempted = len(schedule)
    res.latency_by_due = sorted((schedule[i][0], lat) for i, lat in done.items())
    lats = sorted(done.values()) + [float("inf")] * (len(schedule) - len(done))
    res.failed = len(schedule) - len(done)
    for p in t["latency_percentiles"]:
        res.e2e[f"latency_p{p}_s"] = rank(lats, p / 100)
    after = server.metrics()
    batches = after["batches"] - before["batches"]
    served = after["served"] - before["served"]
    # the occupancy of the window's batches alone (the server keeps the last 512)
    occ = list(server._occupancy)[occ_before:] if occ_before + batches <= 512 else []
    res.server = {"batches": batches, "served": served,
                  "batch_occupancy": sum(occ) / len(occ) if occ else None}
    res.notes.append(f"{len(schedule)} requests due at {t['rate']!r}/s over {seconds} s, "
                     f"{len(done)} completed, {res.failed} failed; generator late by at most "
                     f"{max(lateness) if lateness else 0.0!r} s (median "
                     f"{float(np.median(lateness)) if lateness else 0.0!r} s); {batches} batches")
    return res


ENTRIES = {"batched": batched, "img2img": img2img, "serve": serve}
