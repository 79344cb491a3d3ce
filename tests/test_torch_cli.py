"""The port's CLI (``diffusionkit_tpu_torch.scripts.generate_images``) on the CPU.

Its parser against the reference's, action by action; its per-model tables
against the reference's; and ``cli(..., device="cpu")`` on the tiny port
pipeline of ``test_torch_pipeline.build_pipelines`` (the pipeline classes
replaced by a recorder that hands it out): the PNG it writes is
``generate_image``'s for the same arguments, FLUX's CFG override, benchmark
mode's 1-step warm-up with low memory off, ``--num-images``, the denoise
range check and ``--profile-dir``.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from diffusionkit_tpu.scripts import generate_images as jax_cli
from diffusionkit_tpu_torch import model_io
from diffusionkit_tpu_torch.scripts import generate_images as cli_mod

from test_torch_pipeline import build_pipelines

torch.set_num_threads(1)

SD3 = "argmaxinc/mlx-stable-diffusion-3-medium"
FLUX = "argmaxinc/mlx-FLUX.1-schnell"


def actions(parser):
    return [(a.option_strings, a.dest, a.default, a.choices, a.nargs, a.const)
            for a in parser._actions]


def test_parser_actions_are_the_references():
    assert actions(cli_mod.build_parser()) == actions(jax_cli.build_parser())


def test_per_model_tables_are_the_references():
    assert (cli_mod.HEIGHT, cli_mod.WIDTH, cli_mod.SHIFT) == (
        jax_cli.HEIGHT, jax_cli.WIDTH, jax_cli.SHIFT)
    for k in model_io.MMDIT_CKPT:
        assert k in cli_mod.HEIGHT and k in cli_mod.WIDTH and k in cli_mod.SHIFT


@pytest.fixture(scope="module")
def port_pipeline():
    return build_pipelines()[1]


class Recorder:
    """Stands in for both pipeline classes: records the constructor's
    arguments and each ``generate_image`` call, and runs the calls on the
    tiny port pipeline."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.built = []
        self.calls = []

    def cls(self, name):
        def make(**kwargs):
            self.built.append((name, kwargs))
            return self
        return make

    def ensure_models_are_loaded(self):
        self.pipe.ensure_models_are_loaded()

    def generate_image(self, text, **kwargs):
        self.calls.append(kwargs)
        return self.pipe.generate_image(text, **kwargs)


@pytest.fixture
def recorder(port_pipeline, monkeypatch):
    rec = Recorder(port_pipeline)
    monkeypatch.setattr(cli_mod, "DiffusionPipeline", rec.cls("sd3"))
    monkeypatch.setattr(cli_mod, "FluxPipeline", rec.cls("flux"))
    return rec


def run_cli(tmp_path, *flags, model=SD3, out="out.png"):
    path = tmp_path / out
    log = cli_mod.cli(["--prompt", "a cat", "--model-version", model, "--height", "64",
                       "--width", "64", "--steps", "2", "--seed", "3", "-o", str(path), *flags],
                      device="cpu")
    return path, log


def test_cli_writes_generate_images_png(recorder, port_pipeline, tmp_path):
    path, log = run_cli(tmp_path)
    (name, kwargs), = recorder.built
    assert name == "sd3" and kwargs == {
        "w16": True, "shift": 3.0, "use_t5": False, "model_version": SD3,
        "low_memory_mode": True, "a16": True, "local_ckpt": None, "use_scan": True,
        "quantize_mmdit": None, "quantize_t5": False, "quantize_group_size": 32,
        "device": "cpu"}
    want, _ = port_pipeline.generate_image("a cat", num_steps=2, cfg_weight=5.0, seed=3,
                                           latent_size=(8, 8), verbose=False)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), np.asarray(want))
    assert len(log["denoising"]["iter_time"]) == 2


def test_cli_turns_cfg_off_for_flux(recorder, tmp_path):
    run_cli(tmp_path, "--cfg", "7.0", model=FLUX)
    (name, kwargs), = recorder.built
    assert name == "flux" and kwargs["shift"] == 1.0
    (call,) = recorder.calls
    assert call["cfg_weight"] == 0.0 and call["num_steps"] == 2


def test_cli_benchmark_mode_warms_up_with_one_step(recorder, tmp_path):
    plain, _ = run_cli(tmp_path, out="plain.png")
    recorder.built.clear()
    recorder.calls.clear()
    bench, _ = run_cli(tmp_path, "--benchmark-mode", out="bench.png")
    (_, kwargs), = recorder.built
    assert kwargs["low_memory_mode"] is False
    warm, real = recorder.calls
    assert warm["num_steps"] == 1 and real["num_steps"] == 2
    np.testing.assert_array_equal(np.asarray(Image.open(bench)), np.asarray(Image.open(plain)))


def test_cli_num_images_writes_each(recorder, tmp_path):
    run_cli(tmp_path, "--num-images", "2")
    a, b = (np.asarray(Image.open(tmp_path / f"out_{i}.png")) for i in (0, 1))
    assert a.shape == b.shape == (64, 64, 3) and not np.array_equal(a, b)
    assert not (tmp_path / "out.png").exists()


def test_cli_rejects_a_denoise_out_of_range(recorder, tmp_path):
    with pytest.raises(ValueError, match="Denoising factor"):
        run_cli(tmp_path, "--denoise", "1.5")
    assert not recorder.built


def test_cli_profile_dir_writes_a_trace(recorder, tmp_path):
    trace = tmp_path / "trace"
    run_cli(tmp_path, "--profile-dir", str(trace))
    assert recorder.calls[0]["profile_dir"] == str(trace)
    assert any(p.stat().st_size > 0 for p in trace.iterdir())


def test_cli_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli_mod.cli(["--prompt", "a cat", "-o", str(tmp_path / "x.png")])
