"""The port's generation server (``diffusionkit_tpu_torch.serve``) on the CPU.

Twins of tests/test_serve.py: the model tests run on the port pipeline that
``test_torch_pipeline.build_pipelines`` builds from the JAX pipeline's
weights, the production guards on a stub pipeline. Beside them: ``_bucket``
against the reference's, a fixed padded batch through the port server's
``_run_batch`` and the JAX server's on the same weights (within one level),
/healthz and /metrics with ``torch.cuda``'s queries made to raise (they make
no CUDA call), ``inference_context``'s keys, ``decode_latents_to_image``
against the JAX one, and ``main``'s pipeline.
"""

import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from diffusionkit_tpu import serve as jax_serve
from diffusionkit_tpu import utils as jax_utils
from diffusionkit_tpu_torch import serve
from diffusionkit_tpu_torch.serve import GenerationServer
from diffusionkit_tpu_torch.utils import inference_context

from test_torch_pipeline import build_pipelines

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pipelines():
    return build_pipelines()


@pytest.fixture(scope="module")
def server_url(pipelines):
    _, tp = pipelines
    srv = GenerationServer(tp, default_steps=2, default_cfg=5.0)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.handler_class())
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{port}"
    httpd.shutdown()


def _post(url, payload, path="/generate"):
    req = urllib.request.Request(
        url + path,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    return urllib.request.urlopen(req, timeout=300)


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_healthz(server_url):
    status, body = _get(server_url, "/healthz")
    assert status == 200 and body["status"] == "ok"
    assert body["backend"] == "cpu" and body["device_kind"] == "cpu"


def test_generate_png(server_url):
    from PIL import Image

    with _post(server_url, {"prompt": "a cat", "seed": 1, "height": 64, "width": 64}) as r:
        assert r.headers["Content-Type"] == "image/png"
        img = Image.open(io.BytesIO(r.read()))
    assert img.size == (64, 64)


def test_generate_batch_json(server_url):
    from PIL import Image

    with _post(
        server_url,
        {"prompt": "a cat", "seed": 1, "height": 64, "width": 64, "num_images": 2},
    ) as r:
        body = json.loads(r.read())
    assert len(body["images"]) == 2
    imgs = [np.asarray(Image.open(io.BytesIO(base64.b64decode(b)))) for b in body["images"]]
    assert imgs[0].shape == (64, 64, 3)
    assert not np.array_equal(imgs[0], imgs[1])


def test_concurrent_requests_batched(server_url):
    """Concurrent same-bucket requests merge into one batched denoise and
    each caller gets its own (seed-distinct) image."""
    from PIL import Image

    results = {}

    def fetch(seed):
        with _post(server_url, {"prompt": "a cat", "seed": seed,
                                "height": 64, "width": 64}) as r:
            results[seed] = np.asarray(Image.open(io.BytesIO(r.read())))

    threads = [threading.Thread(target=fetch, args=(s,)) for s in (1, 2, 3, 4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert set(results) == {1, 2, 3, 4}
    assert not np.array_equal(results[1], results[2])
    # seed 1 via the batch == seed 1 single-request (same noise convention)
    with _post(server_url, {"prompt": "a cat", "seed": 1,
                            "height": 64, "width": 64}) as r:
        single = np.asarray(Image.open(io.BytesIO(r.read())))
    np.testing.assert_allclose(results[1].astype(int), single.astype(int), atol=2)


def test_warmup_endpoint(server_url):
    with _post(server_url, {"batch": 2, "height": 64, "width": 64, "steps": 2},
               path="/warmup") as r:
        body = json.loads(r.read())
    assert body == {"compiled_buckets": [1, 2], "steps": 2, "cfg": 5.0, "height": 64,
                    "width": 64}


def test_errors(server_url):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server_url, {})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server_url, {"prompt": "x", "height": 65})
    assert e.value.code == 400


def test_malformed_numeric_field_returns_400_and_server_survives(server_url):
    """A non-numeric steps field 400s on the handler thread; the batching
    worker survives and serves the next request."""
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server_url, {"prompt": "a cat", "steps": "abc", "height": 64, "width": 64})
    assert e.value.code == 400
    with _post(server_url, {"prompt": "a cat", "seed": 2, "height": 64, "width": 64}) as r:
        assert r.status == 200


def test_non_string_prompt_rejected(server_url):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server_url, {"prompt": {"bad": 1}, "height": 64, "width": 64})
    assert e.value.code == 400


# -- the production guards (stub pipeline: no model, controllable delay) --------------------


class _StubPipeline:
    def __init__(self, delay_s=0.0):
        self.delay_s = delay_s
        self.calls = 0

    def generate_images_batched(self, prompts, **kw):
        from PIL import Image

        self.calls += 1
        time.sleep(self.delay_s)
        return [Image.new("RGB", (8, 8)) for _ in prompts]

    def generate_image(self, prompt, **kw):
        from PIL import Image

        return Image.new("RGB", (8, 8)), {}


def _serve(srv):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.handler_class())
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def test_request_timeout_504():
    srv = GenerationServer(_StubPipeline(delay_s=2.0), max_batch=1, request_timeout_s=0.2)
    httpd, url = _serve(srv)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, {"prompt": "slow"})
        assert e.value.code == 504
        assert srv.metrics()["timeouts"] == 1
    finally:
        httpd.shutdown()


def test_overload_503_and_retry_after():
    srv = GenerationServer(_StubPipeline(delay_s=1.0), max_batch=1, max_queue=1,
                           batch_window_s=0.0)
    httpd, url = _serve(srv)
    try:
        results, retry_after = [], []

        def fire():
            try:
                with _post(url, {"prompt": "x"}) as r:
                    results.append(r.status)
            except urllib.error.HTTPError as e:
                results.append(e.code)
                retry_after.append(e.headers.get("Retry-After"))

        # The first request occupies the worker; the next fills the queue;
        # the burst beyond that sheds with 503.
        threads = [threading.Thread(target=fire) for _ in range(6)]
        for t in threads:
            t.start()
            time.sleep(0.05)
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert 503 in results, results
        assert 200 in results, results
        assert set(retry_after) == {"5"}
        assert srv.metrics()["rejected"] >= 1
    finally:
        httpd.shutdown()


def test_metrics_endpoint():
    srv = GenerationServer(_StubPipeline(), max_batch=2, batch_window_s=0.0)
    httpd, url = _serve(srv)
    try:
        with _post(url, {"prompt": "a"}) as r:
            assert r.status == 200
        _, m = _get(url, "/metrics")
        assert m["served"] == 1 and m["batches"] == 1
        assert m["latency_p50_s"] is not None and m["latency_p50_s"] >= 0
        assert m["queue_depth"] == 0 and m["draining"] is False
        assert 0 < m["batch_occupancy"] <= 1
    finally:
        httpd.shutdown()


def test_graceful_drain():
    srv = GenerationServer(_StubPipeline(delay_s=0.3), max_batch=1, batch_window_s=0.0)
    httpd, url = _serve(srv)
    try:
        codes = []

        def fire():
            try:
                with _post(url, {"prompt": "x"}) as r:
                    codes.append(r.status)
            except urllib.error.HTTPError as e:
                codes.append(e.code)

        t1 = threading.Thread(target=fire)
        t1.start()
        time.sleep(0.1)  # in flight
        status = srv.drain(deadline_s=10.0)
        assert status["drained"] is True
        t1.join(timeout=10)
        assert not t1.is_alive()
        assert codes == [200]  # the in-flight request completed during the drain
        # New work is shed while draining.
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, {"prompt": "late"})
        assert e.value.code == 503
    finally:
        httpd.shutdown()


def test_mixed_buckets_full_queue_no_deadlock():
    """Different-bucket jobs the worker pops are held locally, never
    re-enqueued onto the bounded queue: every job completes."""
    srv = GenerationServer(_StubPipeline(delay_s=0.05), max_batch=4, max_queue=4,
                           batch_window_s=0.2, request_timeout_s=30.0)
    httpd, url = _serve(srv)
    try:
        results = []

        def fire(size):
            for _ in range(20):  # 503 = shed, retry
                try:
                    with _post(url, {"prompt": "x", "height": size, "width": size}) as r:
                        results.append(r.status)
                        return
                except urllib.error.HTTPError as e:
                    if e.code != 503:
                        results.append(e.code)
                        return
                    time.sleep(0.1)
            results.append("gave-up")

        threads = [threading.Thread(target=fire, args=(64 if i % 2 else 128,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads), "worker deadlocked"
        assert results.count(200) == 8, results
        assert srv.metrics()["queue_depth"] == 0
    finally:
        httpd.shutdown()


# -- against the reference --------------------------------------------------------------------


@pytest.mark.parametrize("max_batch", [1, 2, 3, 8])
def test_bucket_is_the_references(max_batch):
    for n in range(1, 21):
        assert serve._bucket(n, max_batch) == jax_serve._bucket(n, max_batch)


def test_padded_batch_matches_the_jax_server(pipelines, monkeypatch):
    """Three jobs through each server's ``_run_batch`` (bucket 4: the last
    job padded once) on the same weights: three images, each within one
    level of the JAX server's."""
    monkeypatch.setenv("DIFFUSIONKIT_TPU_FUSED_QUANT", "interpret")
    jp, tp = pipelines
    reqs = [{"prompt": p, "seed": s, "height": 64, "width": 64}
            for p, s in (("a cat", 1), ("a red fox", 2), ("a dog, at night", 3))]
    out = {}
    for name, mod, pipe in (("jax", jax_serve, jp), ("port", serve, tp)):
        srv = mod.GenerationServer(pipe, default_steps=2, default_cfg=5.0, max_batch=4)
        jobs = [mod._Job(dict(r)) for r in reqs]
        srv._run_batch(srv._key(reqs[0]), jobs)
        assert all(j.event.is_set() and len(j.images) == 1 for j in jobs)
        assert srv.metrics()["batch_occupancy"] == 0.75
        out[name] = [np.asarray(j.images[0]).astype(int) for j in jobs]
    for want, got in zip(out["jax"], out["port"]):
        assert got.shape == want.shape == (64, 64, 3)
        assert np.abs(got - want).max() <= 1
    assert not np.array_equal(out["port"][0], out["port"][1])


def test_healthz_and_metrics_make_no_cuda_call(monkeypatch):
    """The device report is taken when the server is built: with every
    ``torch.cuda`` query made to raise, /healthz and /metrics still answer
    while a batch runs."""
    srv = GenerationServer(_StubPipeline(delay_s=0.5), max_batch=1, batch_window_s=0.0)
    httpd, url = _serve(srv)

    def no_cuda(*args, **kwargs):
        raise AssertionError("a CUDA call from a handler")

    for name in ("is_available", "device_count", "get_device_name", "get_device_properties",
                 "memory_allocated", "max_memory_allocated", "synchronize", "current_device",
                 "mem_get_info"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    try:
        fired = threading.Thread(target=lambda: _post(url, {"prompt": "x"}).close())
        fired.start()
        time.sleep(0.1)
        status, health = _get(url, "/healthz")
        assert status == 200 and health == {"status": "ok", **srv.context}
        status, metrics = _get(url, "/metrics")
        assert status == 200 and metrics["served"] == 0
        fired.join(timeout=10)
        assert not fired.is_alive()
        assert _get(url, "/metrics")[1]["served"] == 1
    finally:
        httpd.shutdown()


def test_inference_context_has_the_references_keys():
    want = set(jax_utils.inference_context()) - {"jax"} | {"torch"}
    ctx = inference_context("cpu")
    assert set(ctx) == want
    assert ctx["torch"] == torch.__version__
    assert (ctx["backend"], ctx["device_kind"], ctx["num_devices"]) == ("cpu", "cpu", 1)
    assert (ctx["process_index"], ctx["num_processes"]) == (0, 1)
    assert inference_context() == ctx  # no card: the CPU


def test_decode_latents_to_image_matches_jax(pipelines):
    """The public decode (fp32 VAE on both sides) against the reference's,
    and ``decode_latents_to_u8`` its floor of x 255."""
    jp, tp = pipelines
    x_t = np.random.RandomState(5).randn(2, 8, 8, 16).astype(np.float32)
    want = np.asarray(jp.decode_latents_to_image(x_t))
    got = tp.decode_latents_to_image(torch.from_numpy(x_t))
    assert got.shape == (2, 64, 64, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    u8 = tp.decode_latents_to_u8(torch.from_numpy(x_t))
    assert torch.equal(u8, torch.floor(got * 255.0).to(torch.uint8))


# -- main -------------------------------------------------------------------------------------


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        serve.main(["--port", "0"])


@pytest.mark.parametrize("model, flux", [("argmaxinc/mlx-FLUX.1-schnell-4bit-quantized", True),
                                         ("argmaxinc/mlx-stable-diffusion-3-medium", False)])
def test_main_builds_a_resident_pipeline(model, flux, monkeypatch):
    """``main`` gives the reference's flags to the port's pipeline on the
    requested device, everything resident, and serves it with the model's
    defaults."""
    import diffusionkit_tpu_torch.pipeline as pl

    built, served = {}, {}

    def record(cls_name):
        def make(**kwargs):
            built.update(cls=cls_name, **kwargs)
            return _StubPipeline()
        return make

    monkeypatch.setattr(pl, "FluxPipeline", record("flux"))
    monkeypatch.setattr(pl, "DiffusionPipeline", record("sd3"))
    monkeypatch.setattr(GenerationServer, "serve_forever",
                        lambda self, host, port: served.update(
                            host=host, port=port, steps=self.default_steps,
                            cfg=self.default_cfg, max_batch=self.max_batch))
    serve.main(["--model-version", model, "--quantize-mmdit", "w4a8", "--quantize-t5",
                "--max-batch", "4", "--port", "8123", "--no-use-scan"], device="cpu")
    assert built == {"cls": "flux" if flux else "sd3", "model_version": model,
                     "shift": 1.0 if flux else 3.0, "use_t5": False, "low_memory_mode": False,
                     "use_scan": False, "quantize_mmdit": "w4a8", "quantize_t5": True,
                     "quantize_group_size": 32, "device": "cpu"}
    assert served == {"host": "0.0.0.0", "port": 8123, "steps": 4 if flux else 50,
                      "cfg": 0.0 if flux else 5.0, "max_batch": 4}


def test_main_flags_are_the_references(monkeypatch):
    """Every action of the port server's parser equals the reference's:
    option strings, dest, default, choices, nargs and const."""
    import argparse

    class Parsed(Exception):
        pass

    def capture(self, args=None, namespace=None):
        raise Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    surfaces = []
    for main in (jax_serve.main, serve.main):
        with pytest.raises(Parsed) as e:
            main([])
        surfaces.append([(a.option_strings, a.dest, a.default, a.choices, a.nargs, a.const)
                         for a in e.value.args[0]._actions])
    assert surfaces[0] == surfaces[1]
