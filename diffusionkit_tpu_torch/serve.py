"""Image-generation server with request batching, on the card.

The counterpart of ``diffusionkit_tpu/serve.py``, with the same HTTP
surface. Stdlib-only HTTP server over DiffusionPipeline/FluxPipeline.
Concurrent requests with the same shape bucket (height, width, steps, cfg,
guidance) are MERGED into one batched denoise
(pipeline.generate_images_batched): one schedule for N prompts instead of N
sequential schedules. Batches are padded up to power-of-two buckets, so the
pipeline captures the CUDA graph of a denoise step once per bucket shape
(``graphs.StepGraph``, cached in the pipeline), not once per queue length.

POST /generate  {"prompt": str, "steps": int, "cfg": float, "seed": int?,
                 "negative_prompt": str?, "height": int?, "width": int?,
                 "num_images": int?, "guidance": float?}
  -> image/png (single) or JSON with base64 images (num_images > 1)
  -> 503 when the bounded queue is full or the server is draining;
     504 when a request exceeds the per-request timeout
POST /warmup    {"steps", "cfg", "height", "width", "batch"}
  -> captures the step graphs of the buckets up to "batch" (default
     max_batch); the reply's ``compiled_buckets`` lists the buckets run
GET /healthz -> {"status": "ok", ...inference_context of the pipeline's device}
GET /metrics -> {"queue_depth", "served", "errors", "timeouts", "rejected",
                 "latency_p50_s", "latency_p95_s", "batches",
                 "batch_occupancy", "draining"}

Production guards: bounded queue with load-shedding, per-request timeout,
graceful drain on SIGTERM/SIGINT (stop accepting, let in-flight batches
finish), and a latency/occupancy metrics endpoint.

Threads and the card: the worker thread and /warmup's handler thread call
the pipeline under one lock, so a graph capture can run on either. A CUDA
call from another thread during a capture can break it, so /healthz and
/metrics make none: the device report is taken once, when the server is
built. PNG encoding on the handler threads is host work.
"""

from __future__ import annotations

import base64
import collections
import io
import json
import queue
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from .graphs import StepGraph
from .utils import bytes2gigabytes, device_memory_stats, get_logger, inference_context

logger = get_logger(__name__)


class Overloaded(RuntimeError):
    """Queue full or server draining — clients should back off (HTTP 503)."""


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


class _Job:
    __slots__ = ("req", "event", "images", "error", "t_enqueue", "abandoned")

    def __init__(self, req):
        self.req = req
        self.event = threading.Event()
        self.images = None
        self.error = None
        self.t_enqueue = time.perf_counter()
        # Set by the handler thread when its client timed out: the worker
        # drops the job instead of spending card time on an absent client.
        self.abandoned = False


class GenerationServer:
    """Batching front-end: one worker thread owns the card; requests queue
    and compatible neighbours ride the same denoise."""

    def __init__(
        self,
        pipeline,
        default_steps: int = 4,
        default_cfg: float = 0.0,
        max_batch: int = 8,
        batch_window_s: float = 0.05,
        max_queue: int = 64,
        request_timeout_s: float = 600.0,
    ):
        self.pipeline = pipeline
        self.default_steps = default_steps
        self.default_cfg = default_cfg
        self.max_batch = max_batch
        self.batch_window_s = batch_window_s
        self.request_timeout_s = request_timeout_s
        # The device the pipeline runs on, reported by /healthz; taken here
        # because the handlers make no CUDA call.
        self.device = getattr(pipeline, "device", None)
        self.context = inference_context(self.device)
        # Bounded: a wedged card must surface as fast 503s, not an unbounded
        # queue of clients waiting forever.
        self.queue: "queue.Queue[_Job]" = queue.Queue(maxsize=max_queue)
        self._draining = False
        # different-bucket jobs the worker holds locally between rounds
        self._worker_pending = 0
        # Serialises every pipeline call: the worker holds it per batch and
        # /warmup (which runs on a handler thread) takes it per bucket, so
        # warmup can never race an in-flight batch on the card.
        self._pipeline_lock = threading.Lock()
        self._metrics_lock = threading.Lock()
        self._latencies = collections.deque(maxlen=512)  # seconds
        self._occupancy = collections.deque(maxlen=512)  # jobs / bucket
        self._counters = {
            "served": 0, "errors": 0, "timeouts": 0, "rejected": 0,
            "batches": 0,
        }
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- request normalisation ------------------------------------------------

    def _key(self, req: dict):
        return (
            int(req.get("height", 512)), int(req.get("width", 512)),
            int(req.get("steps", self.default_steps)),
            float(req.get("cfg", self.default_cfg)),
            req.get("guidance"),
            int(req.get("num_images", 1)),
            bool(req.get("image_path")),
        )

    def generate(self, req: dict):
        # Validate ALL numeric fields on the handler thread: a malformed
        # request must 400 here, never raise inside the worker loop (an
        # uncaught worker exception would kill the batching thread and hang
        # every queued client forever).
        key = self._key(req)
        height, width = key[0], key[1]
        if height % 16 or width % 16:
            raise ValueError("height/width must be divisible by 16")
        if not isinstance(req.get("prompt"), str):
            raise ValueError("prompt must be a string")
        if self._draining:
            self._count("rejected")
            raise Overloaded("server is draining")
        job = _Job(req)
        try:
            self.queue.put_nowait(job)
        except queue.Full:
            self._count("rejected")
            raise Overloaded(
                f"queue full ({self.queue.maxsize} requests pending)"
            ) from None
        if not job.event.wait(self.request_timeout_s):
            # A wedged batch must not hang the client forever; mark the job
            # so the worker drops it if it has not started yet.
            job.abandoned = True
            self._count("timeouts")
            raise TimeoutError(
                f"generation timed out after {self.request_timeout_s:.0f}s"
            )
        if job.error is not None:
            self._count("errors")
            raise job.error
        self._record_latency(time.perf_counter() - job.t_enqueue)
        return job.images

    # -- metrics ---------------------------------------------------------------

    def _count(self, key: str, n: int = 1):
        with self._metrics_lock:
            self._counters[key] += n

    def _record_latency(self, dt: float):
        with self._metrics_lock:
            self._counters["served"] += 1
            self._latencies.append(dt)

    def metrics(self) -> dict:
        with self._metrics_lock:
            lats = sorted(self._latencies)
            occ = list(self._occupancy)
            counters = dict(self._counters)

        def pct(p):
            if not lats:
                return None
            return lats[min(len(lats) - 1, int(p * len(lats)))]

        return {
            **counters,
            "queue_depth": self.queue.qsize() + self._worker_pending,
            "latency_p50_s": pct(0.50),
            "latency_p95_s": pct(0.95),
            "batch_occupancy": (sum(occ) / len(occ)) if occ else None,
            "draining": self._draining,
        }

    # -- batching worker -------------------------------------------------------

    def _run(self):
        # Jobs popped in a previous round whose bucket didn't match that
        # round's batch. Held HERE, never re-enqueued: a blocking
        # queue.put() back onto the (bounded) queue could deadlock the
        # worker — handler threads refill freed slots while the worker is
        # the only consumer.
        pending: "collections.deque[_Job]" = collections.deque()
        while True:
            self._worker_pending = len(pending)
            first = pending.popleft() if pending else self.queue.get()
            if self.max_batch > 1 and self.queue.qsize() < self.max_batch - 1:
                time.sleep(self.batch_window_s)  # let neighbours arrive
            batch = [first]
            try:
                key = self._key(first.req)
            except Exception as e:  # defensive: generate() pre-validates
                first.error = e
                first.event.set()
                continue
            # Same-bucket neighbours: first from earlier deferrals (FIFO),
            # then freshly queued jobs.
            for _ in range(len(pending)):
                if len(batch) >= self.max_batch:
                    break
                job = pending.popleft()
                try:
                    same = self._key(job.req) == key
                except Exception as e:
                    job.error = e
                    job.event.set()
                    continue
                (batch.append(job) if same else pending.append(job))
            while len(batch) < self.max_batch:
                try:
                    job = self.queue.get_nowait()
                except queue.Empty:
                    break
                try:
                    same = self._key(job.req) == key
                except Exception as e:
                    job.error = e
                    job.event.set()
                    continue
                (batch if same else pending).append(job)
            batch = [j for j in batch if not j.abandoned]
            if not batch:
                continue
            try:
                self._run_batch(key, batch)
            except Exception as e:
                if len(batch) == 1:
                    batch[0].error = e
                    batch[0].event.set()
                    continue
                # One bad request must not fail its batch neighbours:
                # retry each job alone (on the same pipeline and device) so
                # only the offender errors. Jobs whose events are already
                # set were delivered incrementally by the multi-image/img2img
                # path before the failure — re-running them would waste card
                # time and clobber a satisfied job.
                logger.exception("batch generation failed; retrying per job")
                for job in batch:
                    if job.event.is_set():
                        continue
                    try:
                        self._run_batch(key, [job])
                    except Exception as je:
                        job.error = je
                        job.event.set()

    def _run_batch(self, key, batch):
        with self._pipeline_lock:
            self._run_batch_locked(key, batch)

    def _run_batch_locked(self, key, batch):
        height, width, steps, cfg, guidance, num_images, has_image = key
        if num_images > 1 or has_image:
            # Multi-image or img2img: single-request path.
            for job in batch:
                r = job.req
                images, _ = self.pipeline.generate_image(
                    r["prompt"], num_steps=steps, cfg_weight=cfg,
                    negative_text=r.get("negative_prompt", ""),
                    latent_size=(height // 8, width // 8), seed=r.get("seed"),
                    verbose=False, num_images=num_images, guidance=guidance,
                    image_path=r.get("image_path"),
                    denoise=float(r.get("denoise", 1.0)),
                )
                job.images = images if isinstance(images, list) else [images]
                job.event.set()
            return

        n = len(batch)
        bucket = _bucket(n, self.max_batch)
        jobs = batch + [batch[-1]] * (bucket - n)  # pad: one graph per bucket
        t0 = time.perf_counter()
        images = self.pipeline.generate_images_batched(
            [j.req["prompt"] for j in jobs],
            num_steps=steps, cfg_weight=cfg,
            negative_texts=[j.req.get("negative_prompt", "") for j in jobs],
            latent_size=(height // 8, width // 8),
            seeds=[j.req.get("seed") for j in jobs],
            guidance=guidance,
        )
        dt = time.perf_counter() - t0
        logger.info("batch of %d (bucket %d) in %.2fs (%.1f img/min)",
                    n, bucket, dt, 60.0 * n / dt)
        with self._metrics_lock:
            self._counters["batches"] += 1
            self._occupancy.append(n / bucket)
        for job, image in zip(batch, images):
            job.images = [image]
            job.event.set()

    def warmup(self, req: dict):
        height, width = int(req.get("height", 512)), int(req.get("width", 512))
        steps = int(req.get("steps", self.default_steps))
        cfg = float(req.get("cfg", self.default_cfg))
        top = _bucket(int(req.get("batch", self.max_batch)), self.max_batch)
        captures, capture_s = StepGraph.captures, StepGraph.capture_s
        t0 = time.perf_counter()
        b = 1
        compiled = []
        while b <= top:
            with self._pipeline_lock:
                self.pipeline.generate_images_batched(
                    ["warmup"] * b, num_steps=steps, cfg_weight=cfg,
                    latent_size=(height // 8, width // 8), seeds=[0] * b,
                )
                if b * 2 > top:  # under the lock: no capture runs meanwhile
                    active = device_memory_stats(self.device)["active_memory"]
            compiled.append(b)
            b *= 2
        logger.info(
            "warmup of buckets %s at %dx%d, %d steps: %d step graphs captured in %.2fs "
            "(%.2fs in all), %s GB allocated after", compiled, height, width, steps,
            StepGraph.captures - captures, StepGraph.capture_s - capture_s,
            time.perf_counter() - t0, None if active is None else bytes2gigabytes(active))
        return {"compiled_buckets": compiled, "steps": steps, "cfg": cfg,
                "height": height, "width": width}

    # -- graceful drain --------------------------------------------------------

    def drain(self, deadline_s: float = 120.0) -> dict:
        """Stop accepting new requests and wait for queued + in-flight work.

        New /generate calls 503 immediately; queued jobs finish normally.
        Returns a status dict (drained: whether the queue emptied and the
        card went idle before the deadline).
        """
        self._draining = True
        t0 = time.perf_counter()
        drained = False
        while time.perf_counter() - t0 < deadline_s:
            if (self.queue.qsize() == 0 and self._worker_pending == 0
                    and self._pipeline_lock.acquire(timeout=0.05)):
                # Lock acquired with an empty queue: no batch is running.
                # The worker may still be inside its batch window holding
                # jobs it already popped — their events decide; one more
                # empty-queue check after the window closes.
                self._pipeline_lock.release()
                time.sleep(self.batch_window_s * 2)
                if self.queue.qsize() == 0 and self._worker_pending == 0:
                    drained = True
                    break
            time.sleep(0.05)
        logger.info("drain %s after %.1fs",
                    "complete" if drained else "DEADLINE EXCEEDED",
                    time.perf_counter() - t0)
        return {"drained": drained, "waited_s": time.perf_counter() - t0}

    # -- HTTP plumbing ---------------------------------------------------------

    def handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route through our logger
                logger.info("%s " + fmt, self.client_address[0], *args)

            def _json(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {"status": "ok", **server.context})
                elif self.path == "/metrics":
                    self._json(200, server.metrics())
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if self.path == "/warmup":
                        self._json(200, server.warmup(req))
                        return
                    if self.path != "/generate":
                        self._json(404, {"error": "not found"})
                        return
                    if "prompt" not in req:
                        self._json(400, {"error": "missing 'prompt'"})
                        return
                    images = server.generate(req)
                except ValueError as e:
                    self._json(400, {"error": str(e)})
                    return
                except Overloaded as e:
                    self.send_response_only(503)
                    self.send_header("Retry-After", "5")
                    body = json.dumps({"error": str(e)}).encode()
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                except TimeoutError as e:
                    self._json(504, {"error": str(e)})
                    return
                except Exception as e:  # pragma: no cover
                    logger.exception("generation failed")
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})
                    return

                if len(images) > 1:
                    self._json(200, {"images": [_png_b64(im) for im in images]})
                else:
                    data = _png_bytes(images[0])
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)

        return Handler

    def serve_forever(self, host: str = "0.0.0.0", port: int = 8000):
        httpd = ThreadingHTTPServer((host, port), self.handler_class())

        def _graceful(signum, frame):
            logger.info("signal %d: draining", signum)
            # Drain + shutdown off the signal handler (serve_forever holds
            # this thread); httpd.shutdown() must come from another thread.
            def stop():
                self.drain()
                httpd.shutdown()

            threading.Thread(target=stop, daemon=True).start()

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, _graceful)
            except ValueError:  # pragma: no cover - non-main thread
                pass
        logger.info("Serving on %s:%d (max_batch=%d)", host, port, self.max_batch)
        httpd.serve_forever()
        logger.info("server stopped")


def _png_bytes(image) -> bytes:
    buf = io.BytesIO()
    image.save(buf, format="PNG")
    return buf.getvalue()


def _png_b64(image) -> str:
    return base64.b64encode(_png_bytes(image)).decode()


def main(argv=None, device="cuda"):
    """``python -m diffusionkit_tpu_torch.serve --model-version ... --port 8000``

    Serves on the card; ``device`` is for tests (it adds no flag). Raises
    where ``device`` is a CUDA device and there is no card."""
    import argparse

    from .pipeline import DiffusionPipeline, FluxPipeline

    ap = argparse.ArgumentParser(description="diffusionkit-tpu-torch generation server (CUDA)")
    ap.add_argument("--model-version", default="argmaxinc/mlx-FLUX.1-schnell")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--shift", type=float, default=None)
    ap.add_argument("--t5", action="store_true")
    ap.add_argument("--use-scan", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--quantize-mmdit", nargs="?", const="int4", default=None,
                    choices=["int4", "int8", "w8a8", "w4a8",
                             "int4-mixed", "w4a8-mixed"])
    ap.add_argument("--quantize-group-size", type=int, default=32)
    ap.add_argument("--quantize-t5", action="store_true",
                    help="w8a8 T5 (4.7 GB resident instead of 9.4 in bf16)")
    ap.add_argument("--max-batch", type=int, default=8)
    args = ap.parse_args(argv)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve: no CUDA device; the port serves on the card")
    is_flux = "FLUX" in args.model_version
    cls = FluxPipeline if is_flux else DiffusionPipeline
    pipe = cls(
        model_version=args.model_version,
        shift=args.shift if args.shift is not None else (1.0 if is_flux else 3.0),
        use_t5=args.t5,
        low_memory_mode=False,  # serving keeps everything resident
        use_scan=args.use_scan,
        quantize_mmdit=args.quantize_mmdit,
        quantize_t5=args.quantize_t5,
        quantize_group_size=args.quantize_group_size,
        device=device,
    )
    GenerationServer(
        pipe,
        default_steps=4 if is_flux else 50,
        default_cfg=0.0 if is_flux else 5.0,
        max_batch=args.max_batch,
    ).serve_forever(args.host, args.port)


if __name__ == "__main__":
    main()
