"""The port's mode-quality tool (``diffusionkit_tpu_torch/tools/
quant_quality.py``) against the JAX package's pipeline on the CPU.

Both packages read one float SD3-medium mirror: the tiny checkpoints of
tests/test_torch_loading.py's ``mirror`` (CLIP-L/G, the tokenizers, the
VAE decoder) with an MMDiT of 2 blocks at hidden 256, so that every block
linear and ``ada`` packs (``MIN_SIZE`` / ``MIN_DIM``) and GPTQ's 32 x 32
calibration latents fit its positional table. Each mode's image comes from
the port's ``run`` (the tool's pinned prompt, seed 42, CFG 5.0, 2 steps at
64², in fp32: ``w16=False, a16=False``) and from the JAX package's
``DiffusionPipeline`` with the JAX tool's arguments and the same dtypes,
each converting the same file itself:

- bf16 (the base), int8 (min/max grid) and w8a8 convert both packages'
  weights bit for bit: the images at most one pixel level apart, as
  tests/test_torch_flux.py holds its pipelines;
- int4, w4a8, int4-mixed and w4a8-mixed run GPTQ in each package, which is
  not bit for bit: held as tests/test_torch_gptq.py holds its GPTQ trees,
  the port's error (the L2 distance of its image to its base image) within
  1.1x of the JAX package's. The JAX w4a8 modes run its TPU dispatch in
  interpret mode (tests/test_torch_w4a8.py's ``jax_tpu_dispatch``; the int8
  ``ada`` of w4a8-mixed on its #13 kernel), else it would run them as
  int4 weight-only.

Then the port's PSNR against ``diffusionkit_tpu.utils.image_psnr`` to
1e-6, and ``main``'s table: written after every mode, the deadline
honoured, ``--device`` passed on.
"""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

import diffusionkit_tpu.pipeline as jax_pipeline
from diffusionkit_tpu import model_io as jax_io
from diffusionkit_tpu.utils import image_psnr as jax_image_psnr
from diffusionkit_tpu_torch import config as tcfg
from diffusionkit_tpu_torch import model_io
from diffusionkit_tpu_torch.tools import quant_quality as qq
from diffusionkit_tpu_torch.utils import image_psnr

import test_model_io as jt
from test_torch_loading import SD3_PIPE, TINY_VAE, drawn
from test_torch_loading import mirror  # noqa: F401 (a fixture)
from test_torch_models import torch_config
from test_torch_w4a8 import jax_tpu_dispatch  # noqa: F401 (a fixture)

torch.set_num_threads(2)

WIDE = dataclasses.replace(SD3_PIPE, hidden_size_override=256, num_heads=4,
                           max_latent_resolution=16)
STEPS, LATENT = 2, (8, 8)
FP32 = dict(w16=False, a16=False)
GPTQ_MODES = ("int4", "w4a8", "int4-mixed", "w4a8-mixed")
QUANTIZERS = {None: None, "int8": "minmax", "w8a8": "w8a8", **dict.fromkeys(GPTQ_MODES, "gptq")}


@pytest.fixture(scope="module")
def ckpt_root(mirror, tmp_path_factory):  # noqa: F811
    """The mirror's auxiliary files beside a float SD3-medium file of the
    wide tiny MMDiT (the sgm namespace) and the tiny VAE decoder."""
    root = tmp_path_factory.mktemp("quality")
    shutil.copytree(mirror / model_io.AUX_REPO, root / model_io.AUX_REPO)
    (root / tcfg.SD3_MEDIUM).mkdir(parents=True)
    sd = drawn(43, jt._sd3_raw_ckpt, WIDE)
    sd.update(drawn(31, jt._vae_raw, "first_stage_model.decoder.", 3, TINY_VAE.block_out_channels,
                    16, 3, False))
    save_file(sd, str(root / tcfg.SD3_MEDIUM / model_io.MMDIT_CKPT[tcfg.SD3_MEDIUM]))
    return root


@pytest.fixture
def world(ckpt_root, monkeypatch):
    """Both packages read the mirror with the tiny configs, GPTQ on (the
    pipelines' default), no quantized-model cache."""
    monkeypatch.setenv("DIFFUSIONKIT_TPU_CKPT_DIR", str(ckpt_root))
    monkeypatch.setenv("DIFFUSIONKIT_TPU_QUANT_CACHE", "0")
    for var in ("DIFFUSIONKIT_TPU_GPTQ", "DIFFUSIONKIT_TPU_QUANT_REFINE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setitem(jax_io.MMDIT_CONFIG, tcfg.SD3_MEDIUM, WIDE)
    monkeypatch.setitem(model_io.MMDIT_CONFIG, tcfg.SD3_MEDIUM,
                        torch_config(WIDE, tcfg.MMDiTConfig))
    monkeypatch.setattr(jax_pipeline, "VAEDecoderConfig", lambda: TINY_VAE)
    monkeypatch.setattr(model_io, "VAEDecoderConfig",
                        lambda: torch_config(TINY_VAE, tcfg.VAEDecoderConfig))


_PORT, _JAX = {}, {}


def port_image(mode):
    """The port's ``run`` of ``mode`` (cached): the image and the quantizer."""
    if mode not in _PORT:
        stats = {}
        img, dt = qq.run(mode, STEPS, LATENT, device="cpu", stats=stats, **FP32)
        assert dt > 0
        _PORT[mode] = img, stats["quantizer"]
    return _PORT[mode]


def jax_image(mode, request):
    """The JAX package's pipeline as the JAX tool's ``run`` builds it, in
    the same dtypes (cached); the w4a8 modes under its TPU dispatch."""
    if mode not in _JAX:
        if mode is not None and mode.startswith("w4a8"):
            request.getfixturevalue("jax_tpu_dispatch")
            from diffusionkit_tpu.ops import int4_matmul as ji

            int8_matmul = ji.int8_matmul
            request.getfixturevalue("monkeypatch").setattr(
                ji, "int8_matmul", lambda *a, **kw: int8_matmul(*a, **{**kw, "interpret": True}))
        pipe = jax_pipeline.DiffusionPipeline(model_version=qq.MODEL, shift=3.0, use_t5=False,
                                              low_memory_mode=False, quantize_mmdit=mode, **FP32)
        img, _ = pipe.generate_image(qq.PROMPT, num_steps=STEPS, cfg_weight=5.0,
                                     latent_size=LATENT, seed=42, verbose=False)
        _JAX[mode] = np.asarray(img, np.float32)
    return _JAX[mode]


@pytest.mark.parametrize("mode", qq.MODES, ids=[m or "bf16" for m in qq.MODES])
def test_mode_image_matches_the_jax_pipeline(world, mode, request):
    got, quantizer = port_image(mode)
    assert (quantizer and quantizer["name"]) == QUANTIZERS[mode]
    assert got.shape == (64, 64, 3) and got.dtype == np.float32 and got.std() > 5
    if mode not in GPTQ_MODES:
        want = jax_image(mode, request)
        assert np.abs(got - want).max() <= 1, np.abs(got - want).max()
        if mode is not None:
            assert not np.array_equal(got, port_image(None)[0])
        return
    err_port = float(np.linalg.norm(got - port_image(None)[0]))
    base = jax_image(None, request)  # before any TPU dispatch is patched in
    err_jax = float(np.linalg.norm(jax_image(mode, request) - base))
    assert 0 < err_port <= 1.1 * err_jax, (err_port, err_jax)


def test_psnr_is_the_references(world):
    base = port_image(None)[0]
    for mode in ("int8", "w8a8"):
        img = port_image(mode)[0]
        got, want = image_psnr(base, img), float(jax_image_psnr(base, img))
        assert np.isfinite(got) and abs(got - want) <= 1e-6, (got, want)
    noisy = np.clip(base + np.random.RandomState(0).randint(-3, 4, base.shape), 0, 255)
    assert abs(image_psnr(base, noisy) - float(jax_image_psnr(base, noisy))) <= 1e-6


def fake_images():
    rs = np.random.RandomState(9)
    base = rs.randint(0, 256, (16, 16, 3)).astype(np.float32)
    return {mode: np.clip(base + i * rs.randint(-2, 3, base.shape), 0, 255).astype(np.float32)
            for i, mode in enumerate(qq.MODES)}


@pytest.mark.parametrize("deadline", [False, True], ids=["all", "deadline"])
def test_main_writes_the_table_after_every_mode(tmp_path, monkeypatch, deadline):
    """``main`` with ``run`` replaced: the bf16 base first, then the asked
    modes in ``MODES`` order; the JSON on disk after each ``run`` holds
    every mode finished before it; ``--device`` and the size reach
    ``run``; past ``--deadline-epoch`` no mode starts."""
    out = tmp_path / "table.json"
    images, calls, clock = fake_images(), [], [1000.0]

    def fake_run(mode, steps, latent_hw, device="cuda", stats=None, **kw):
        done = json.loads(out.read_text())["modes"] if out.exists() else {}
        assert list(done) == [m or "bf16" for m, *_ in calls]
        calls.append((mode, steps, latent_hw, device))
        stats["quantizer"] = None if mode is None else {"name": QUANTIZERS[mode], "seconds": 0.5}
        clock[0] += 10.0
        return images[mode], 2.5

    monkeypatch.setattr(qq, "run", fake_run)
    monkeypatch.setattr(qq.time, "time", lambda: clock[0])
    monkeypatch.setenv("DIFFUSIONKIT_TPU_CKPT_DIR", str(tmp_path))
    argv = ["--steps", "3", "--size", "128", "--out", str(out), "--device", "cpu",
            "--modes", "w4a8-mixed,int8,int4"]
    if deadline:
        argv += ["--deadline-epoch", "1015"]
    qq.main(argv)
    want = [None, "int8", "int4", "w4a8-mixed"][:2 if deadline else 4]
    assert calls == [(m, 3, (16, 16), "cpu") for m in want]
    table = json.loads(out.read_text())
    assert table["steps"] == 3 and table["size"] == 128 and table["device"] == "cpu"
    assert list(table["modes"]) == [m or "bf16" for m in want]
    assert table["modes"]["bf16"]["psnr_vs_bf16_db"] is None
    for mode in want[1:]:
        row = table["modes"][mode]
        assert row["psnr_vs_bf16_db"] == pytest.approx(image_psnr(images[None], images[mode]))
        assert row["quantizer"] == QUANTIZERS[mode] and row["wall_s"] == 2.5
