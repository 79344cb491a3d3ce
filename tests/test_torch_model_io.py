"""The VAE half of the port's ``model_io`` against the JAX package's: the
safetensors reader, the sgm VAE mappers, the diffusers autoencoder mapper,
the loaders, the resolver and the hub's offline error.

The raw state dicts are the ones tests/test_model_io.py builds (``_vae_raw``
for the sgm namespace; ``_ae_to_diffusers_sd`` with ``TINY_AE_CFG`` for the
diffusers one), each drawn from its own seed here; every file is written
to a pytest tmp dir. Mappers are compared forward for forward, fp32 on the
CPU. No test reaches the network: the hub is replaced wherever a loader
could fall through to it.
"""

import json
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from diffusionkit_tpu import model_io as jax_io
from diffusionkit_tpu.config import AutoencoderConfig as JaxAutoencoderConfig
from diffusionkit_tpu.config import VAEDecoderConfig as JaxVAEDecoderConfig
from diffusionkit_tpu.config import VAEEncoderConfig as JaxVAEEncoderConfig
from diffusionkit_tpu.models import (
    apply_vae_decoder,
    apply_vae_encoder,
    autoencoder_decode,
    autoencoder_encode,
    init_autoencoder_params,
)
from diffusionkit_tpu_torch import config as tcfg
from diffusionkit_tpu_torch import model_io

import test_model_io as jt

torch.set_num_threads(1)

# fp32 on both sides: the order of the fp32 sums only.
ATOL, RTOL = 1e-5, 1e-4
TINY = (8, 16, 16, 16)
SD3, FLUX = tcfg.SD3_MEDIUM, tcfg.FLUX_SCHNELL_VERSION


def vae_raw(seed: int, *args):
    """tests/test_model_io.py's ``_vae_raw`` drawn from its own seed (its
    module's RandomState put back after)."""
    saved = jt._rs
    jt._rs = np.random.RandomState(seed)
    try:
        return jt._vae_raw(*args)
    finally:
        jt._rs = saved


def to_torch(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


@pytest.fixture(autouse=True)
def no_hub(monkeypatch, tmp_path):
    """The hub answers nothing: a loader that reaches it gets the error a
    host with no network gets. The quantized-model cache goes to the test's tmp dir."""
    import huggingface_hub

    def offline(repo, filename, *args, **kwargs):
        raise ConnectionError(f"offline: {repo}/{filename}")

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("DIFFUSIONKIT_TPU_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.delenv("DIFFUSIONKIT_TPU_CKPT_DIR", raising=False)
    monkeypatch.setattr(huggingface_hub, "hf_hub_download", offline)


# -- the reader -------------------------------------------------------------


# The file's dtype tags: numpy's (the writer's and the JAX reader's) and torch's.
DTYPES = {"F32": (np.float32, torch.float32), "F16": (np.float16, torch.float16),
          "BF16": (ml_dtypes.bfloat16, torch.bfloat16), "I8": (np.int8, torch.int8),
          "U8": (np.uint8, torch.uint8), "I32": (np.int32, torch.int32),
          "I64": (np.int64, torch.int64), "F64": (np.float64, torch.float64),
          "empty": (np.float32, torch.float32)}
BITS = {1: (np.uint8, torch.uint8), 2: (np.uint16, torch.int16), 4: (np.uint32, torch.int32),
        8: (np.uint64, torch.int64)}


def test_load_safetensors_matches_the_jax_reader(tmp_path):
    """One file holding every dtype the checkpoints use (and an empty
    tensor): each tensor's shape and torch dtype, its bits the JAX
    reader's."""
    rs = np.random.RandomState(0)
    arrays = {}
    for i, (tag, (dt, _)) in enumerate(DTYPES.items()):
        shape = [(3, 5), (7,), (2, 3, 4), (1, 1), (4, 2), (6,), (2, 2), (3,), (0, 4)][i]
        if np.issubdtype(np.dtype(dt), np.integer):
            info = np.iinfo(dt)
            arrays[tag] = rs.randint(max(info.min, -1000), min(info.max, 1000), shape).astype(dt)
        else:
            arrays[tag] = (rs.randn(*shape) * 100).astype(dt)
    path = tmp_path / "mixed.safetensors"
    save_file(arrays, str(path), metadata={"format": "pt"})
    want = jax_io.load_safetensors(path)
    got = model_io.load_safetensors(path)
    assert sorted(got) == sorted(want) == sorted(arrays)
    for k, w in want.items():
        g, w = got[k], np.asarray(w)
        assert tuple(g.shape) == w.shape and g.dtype == DTYPES[k][1], k
        np_bits, torch_bits = BITS[w.dtype.itemsize]
        np.testing.assert_array_equal(g.view(torch_bits).numpy().view(np_bits), w.view(np_bits),
                                      err_msg=k)


def test_load_safetensors_keeps_the_mapping_alive(tmp_path):
    """A tensor read from the file stays valid after the state dict and
    every other reference to the mapping are gone."""
    import gc

    path = tmp_path / "one.safetensors"
    save_file({"w": np.arange(1000, dtype=np.float32)}, str(path))
    w = model_io.load_safetensors(path)["w"]
    gc.collect()
    assert torch.equal(w, torch.arange(1000, dtype=torch.float32))


# -- the sgm VAE mappers --------------------------------------------------------


@pytest.mark.parametrize("prefix", ["first_stage_model.", ""])
def test_vae_decoder_mapper_matches_jax(prefix):
    sd = vae_raw(1, prefix + "decoder.", 3, TINY, 16, 3, False)
    jcfg = JaxVAEDecoderConfig(block_out_channels=TINY, layers_per_block=3, resnet_groups=4)
    params = jax_io.vae_decoder_params_from_ckpt(sd, jnp.float32, prefix=prefix + "decoder.")
    model = model_io.vae_decoder_from_ckpt(
        to_torch(sd), tcfg.VAEDecoderConfig(block_out_channels=TINY, resnet_groups=4),
        prefix=prefix + "decoder.", device="cpu")
    z = np.random.RandomState(2).randn(1, 4, 4, 16).astype(np.float32)
    want = np.asarray(apply_vae_decoder(params, jnp.asarray(z), jcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("prefix", ["first_stage_model.", ""])
def test_vae_encoder_mapper_matches_jax(prefix):
    sd = vae_raw(3, prefix + "encoder.", 2, TINY, 3, 32, True)
    jcfg = JaxVAEEncoderConfig(block_out_channels=TINY, layers_per_block=2, resnet_groups=4)
    params = jax_io.vae_encoder_params_from_ckpt(sd, jnp.float32, prefix=prefix + "encoder.")
    model = model_io.vae_encoder_from_ckpt(
        to_torch(sd), tcfg.VAEEncoderConfig(block_out_channels=TINY, resnet_groups=4),
        prefix=prefix + "encoder.", device="cpu")
    x = np.random.RandomState(4).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    want = np.asarray(apply_vae_encoder(params, jnp.asarray(x), jcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 4, 4, 32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_vae_mapper_raises_on_a_missing_key():
    sd = to_torch(vae_raw(5, "encoder.", 2, TINY, 3, 32, True))
    del sd["encoder.mid.attn_1.q.weight"]
    with pytest.raises(KeyError, match="mid.attn_1.q.weight"):
        model_io.vae_encoder_from_ckpt(
            sd, tcfg.VAEEncoderConfig(block_out_channels=TINY, resnet_groups=4), device="cpu")


# -- the diffusers autoencoder mapper ----------------------------------------------

LEGACY = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}


def diffusers_sd(seed: int, legacy: bool, conv_proj: bool, cfg=jt.TINY_AE_CFG):
    """A diffusers AutoencoderKL state dict of a random tree, its attention
    projections under the modern or the legacy names, stored as linears
    or as 1x1 convolutions, and the quant convolutions as 1x1 ones."""
    config = JaxAutoencoderConfig(**cfg)
    params = jax.tree.map(lambda a: np.asarray(a) + np.float32(0.05),
                          init_autoencoder_params(jax.random.PRNGKey(seed), config, jnp.float32))
    sd = jt._ae_to_diffusers_sd(params, len(config.block_out_channels),
                                config.layers_per_block, config.layers_per_block + 1)
    out = {}
    for k, v in sd.items():
        for modern, old in LEGACY.items():
            if legacy and f".attentions.0.{modern}." in k:
                k = k.replace(f".{modern}.", f".{old}.")
        if conv_proj and ".attentions.0." in k and ".group_norm." not in k and v.ndim == 2:
            v = v[:, :, None, None]
        out[k] = v
    return out, config


@pytest.mark.parametrize("legacy", [False, True], ids=["to_q", "query"])
@pytest.mark.parametrize("conv_proj", [False, True], ids=["linear", "conv1x1"])
def test_autoencoder_diffusers_mapper_matches_jax(legacy, conv_proj):
    sd, jcfg = diffusers_sd(7, legacy, conv_proj)
    assert any((".query." if legacy else ".to_q.") in k for k in sd)
    params = jax_io.autoencoder_params_from_diffusers_ckpt(sd, jcfg, jnp.float32)
    model = model_io.autoencoder_from_diffusers_ckpt(
        to_torch(sd), tcfg.AutoencoderConfig(**jt.TINY_AE_CFG), device="cpu")
    x = np.random.RandomState(8).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    jm, jl = autoencoder_encode(params, jnp.asarray(x), jcfg)
    jx = autoencoder_decode(params, jm, jcfg)
    with torch.no_grad():
        tm, tl = model.encode(torch.from_numpy(x))
        tx = model.decode(torch.from_numpy(np.array(jm)))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=RTOL)
    assert tx.shape == (1, 16, 16, 3)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL, rtol=RTOL)


def test_autoencoder_mapper_takes_a_missing_projection_bias_as_zero():
    sd, jcfg = diffusers_sd(9, False, False)
    del sd["encoder.mid_block.attentions.0.to_q.bias"]
    params = jax_io.autoencoder_params_from_diffusers_ckpt(sd, jcfg, jnp.float32)
    model = model_io.autoencoder_from_diffusers_ckpt(
        to_torch(sd), tcfg.AutoencoderConfig(**jt.TINY_AE_CFG), device="cpu")
    assert not model.encoder.mid_blocks[1].query_proj.bias.any()
    x = np.random.RandomState(10).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        tm, _ = model.encode(torch.from_numpy(x))
    jm, _ = autoencoder_encode(params, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=ATOL, rtol=RTOL)


# -- the loaders --------------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Full-width VAE files, as the loaders read them: SD3-medium's
    (encoder and decoder under ``first_stage_model.``, F16) and FLUX's
    ``ae.safetensors`` (the encoder unprefixed, BF16)."""
    root = tmp_path_factory.mktemp("ckpts")
    full = tcfg.VAEEncoderConfig().block_out_channels
    sd3 = {**vae_raw(11, "first_stage_model.encoder.", 2, full, 3, 32, True),
           **vae_raw(12, "first_stage_model.decoder.", 3, full, 16, 3, False)}
    sd3_path = root / "sd3_medium.safetensors"
    save_file({k: v.astype(np.float16) for k, v in sd3.items()}, str(sd3_path))
    flux_dir = root / "mirror" / FLUX
    flux_dir.mkdir(parents=True)
    flux = vae_raw(13, "encoder.", 2, full, 3, 32, True)
    save_file({k: v.astype(ml_dtypes.bfloat16) for k, v in flux.items()},
              str(flux_dir / "ae.safetensors"))
    return {"sd3": str(sd3_path), "root": str(root / "mirror")}


def encode_both(jparams, model, size=16):
    x = np.random.RandomState(size).uniform(-1, 1, (1, size, size, 3)).astype(np.float32)
    want = np.asarray(apply_vae_encoder(jparams, jnp.asarray(x), JaxVAEEncoderConfig()))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    return got, want


def test_load_vae_encoder_through_local_ckpt(ckpts, monkeypatch):
    monkeypatch.setenv("DIFFUSIONKIT_TPU_CKPT_DIR", ckpts["root"])  # local_ckpt comes first
    model = model_io.load_vae_encoder(SD3, torch.float32, ckpts["sd3"], device="cpu")
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    jparams = jax_io.load_vae_encoder(SD3, jnp.float32, ckpts["sd3"])
    got, want = encode_both(jparams, model)
    assert got.shape == (1, 2, 2, 32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_load_vae_encoder_through_the_ckpt_dir(ckpts, monkeypatch):
    monkeypatch.setenv("DIFFUSIONKIT_TPU_CKPT_DIR", ckpts["root"])
    model = model_io.load_vae_encoder(FLUX, device="cpu")
    jparams = jax_io.load_vae_encoder(FLUX, jnp.float32)
    got, want = encode_both(jparams, model)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    bf16 = model_io.load_vae_encoder(FLUX, torch.bfloat16, device="cpu")
    assert {p.dtype for p in bf16.parameters()} == {torch.bfloat16}
    # The file holds bf16 values: the fp32 model's weights are them exactly.
    torch.testing.assert_close(bf16.conv_in.weight.float(), model.conv_in.weight, rtol=0, atol=0)


def test_load_vae_decoder_through_local_ckpt(ckpts):
    model = model_io.load_vae_decoder(SD3, torch.float32, ckpts["sd3"], device="cpu")
    jparams = jax_io.load_vae_decoder(SD3, jnp.float32, ckpts["sd3"])
    z = np.random.RandomState(14).randn(1, 2, 2, 16).astype(np.float32)
    want = np.asarray(apply_vae_decoder(jparams, jnp.asarray(z), JaxVAEDecoderConfig()))
    with torch.no_grad():
        got = model(torch.from_numpy(z)).numpy()
    assert got.shape == (1, 16, 16, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_load_vae_encoder_without_a_file_raises(ckpts, monkeypatch):
    """A version with no local file and no hub: the hub's error, never
    random weights."""
    monkeypatch.setenv("DIFFUSIONKIT_TPU_CKPT_DIR", ckpts["root"])  # holds FLUX only
    with pytest.raises(RuntimeError, match="sd3_medium.safetensors"):
        model_io.load_vae_encoder(SD3, device="cpu")


def test_load_autoencoder_forces_16_latent_channels(tmp_path, monkeypatch):
    cfg = dict(jt.TINY_AE_CFG, latent_channels_out=32, latent_channels_in=16)
    sd, jcfg = diffusers_sd(15, False, False, cfg)
    vae_dir = tmp_path / model_io.AUX_REPO / "vae"
    vae_dir.mkdir(parents=True)
    with open(vae_dir / "config.json", "w") as f:
        json.dump({"in_channels": 3, "out_channels": 3,
                   "latent_channels": 4,  # the loader makes it 16
                   "block_out_channels": list(jcfg.block_out_channels),
                   "layers_per_block": jcfg.layers_per_block,
                   "norm_num_groups": jcfg.norm_num_groups, "scaling_factor": 0.13025}, f)
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()},
              str(vae_dir / "diffusion_pytorch_model.safetensors"))
    monkeypatch.setenv("DIFFUSIONKIT_TPU_CKPT_DIR", str(tmp_path))
    model, config = model_io.load_autoencoder(device="cpu")
    jparams, jconfig = jax_io.load_autoencoder()
    assert (config.latent_channels_in, config.latent_channels_out) == (16, 32)
    assert config.scaling_factor == 0.13025
    assert config == tcfg.AutoencoderConfig(**{f: getattr(jconfig, f) for f in (
        "in_channels", "out_channels", "latent_channels_out", "latent_channels_in",
        "block_out_channels", "layers_per_block", "norm_num_groups", "scaling_factor")})
    x = np.random.RandomState(16).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    jm, jl = autoencoder_encode(jparams, jnp.asarray(x), jconfig)
    with torch.no_grad():
        tm, tl = model.encode(torch.from_numpy(x))
        tx = model.decode(tm)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(autoencoder_decode(jparams, jm, jconfig)),
                               atol=ATOL, rtol=RTOL)


# -- the resolver and the hub ---------------------------------------------------------


@pytest.fixture
def hub(monkeypatch):
    """A hub that answers every request with a path and records it."""
    import huggingface_hub

    asked = []

    def download(repo, filename, *args, **kwargs):
        asked.append((repo, filename))
        return f"/hub/{repo}/{filename}"

    monkeypatch.setattr(huggingface_hub, "hf_hub_download", download)
    return asked


def test_resolve_order(tmp_path, monkeypatch, hub):
    (tmp_path / SD3).mkdir(parents=True)
    (tmp_path / SD3 / "sd3_medium.safetensors").write_bytes(b"")
    # 1. local_ckpt first, whatever the environment holds.
    monkeypatch.setenv("DIFFUSIONKIT_TPU_CKPT_DIR", str(tmp_path))
    assert model_io._resolve(SD3, "sd3_medium.safetensors", "/x.safetensors") == "/x.safetensors"
    # 2. then the checkpoint root, where the file exists;
    assert model_io._resolve(SD3, "sd3_medium.safetensors", None) == str(
        tmp_path / SD3 / "sd3_medium.safetensors")
    assert hub == []
    # 3. then the hub: a file the root lacks, or no root.
    assert model_io._resolve(FLUX, "ae.safetensors", None) == f"/hub/{FLUX}/ae.safetensors"
    monkeypatch.delenv("DIFFUSIONKIT_TPU_CKPT_DIR")
    model_io._resolve(SD3, "sd3_medium.safetensors", None)
    assert hub == [(FLUX, "ae.safetensors"), (SD3, "sd3_medium.safetensors")]
    assert jax_io._resolve(FLUX, "ae.safetensors", None) == f"/hub/{FLUX}/ae.safetensors"


def test_resolve_aux_order(tmp_path, monkeypatch, hub):
    monkeypatch.setenv("DIFFUSIONKIT_TPU_CKPT_DIR", str(tmp_path))
    assert model_io._resolve_aux("vae/config.json") == f"/hub/{model_io.AUX_REPO}/vae/config.json"
    (tmp_path / model_io.AUX_REPO / "vae").mkdir(parents=True)
    (tmp_path / model_io.AUX_REPO / "vae" / "config.json").write_text("{}")
    assert model_io._resolve_aux("vae/config.json") == str(
        tmp_path / model_io.AUX_REPO / "vae" / "config.json")
    assert hub == [(model_io.AUX_REPO, "vae/config.json")]


def test_hub_download_error_without_the_network():
    with pytest.raises(RuntimeError, match="DIFFUSIONKIT_TPU_CKPT_DIR") as err:
        model_io.hub_download(SD3, "sd3_medium.safetensors")
    assert "ConnectionError" in str(err.value) and isinstance(err.value.__cause__,
                                                              ConnectionError)


def test_hub_download_error_without_huggingface_hub(monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # the import fails
    with pytest.raises(RuntimeError, match="Could not fetch .*ae.safetensors") as err:
        model_io.hub_download(FLUX, "ae.safetensors")
    assert isinstance(err.value.__cause__, ImportError)


def test_tables_are_the_references():
    assert model_io.VAE_CKPT == jax_io.VAE_CKPT
    assert model_io.VAE_PREFIX == jax_io.VAE_PREFIX
    assert model_io.AUX_REPO == jax_io.AUX_REPO
    assert {k: jax_io.AUX_FILES[k] for k in model_io.AUX_FILES} == model_io.AUX_FILES


# -- the files chip_smoke.py writes on the card -----------------------------------


@pytest.fixture(scope="module")
def chip_smoke():
    """chip_smoke.py loaded by its path (registered while it runs: its
    dataclasses look their module up)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    try:
        spec.loader.exec_module(module)
    finally:
        del sys.modules[spec.name]
    return module


@pytest.mark.parametrize("prefix, dtype", [("first_stage_model.", torch.float16),
                                           ("", torch.bfloat16)])
def test_chip_smoke_encoder_file_reads_back_in_both_packages(chip_smoke, tmp_path, prefix, dtype):
    """The smoke's safetensors writer and its sgm names (the inverse of the
    mapper): the port loads the weights back as written, and the JAX
    loader's encoder computes what the port's does."""
    from diffusionkit_tpu_torch.models import init_vae_encoder

    cfg = tcfg.VAEEncoderConfig(block_out_channels=TINY, resnet_groups=4)
    sd = {k: v.to(dtype) for k, v in init_vae_encoder(
        cfg, torch.Generator().manual_seed(17), device="cpu").state_dict().items()}
    path = tmp_path / "vae.safetensors"
    chip_smoke.write_safetensors(path, {prefix + "encoder." + k: v
                                        for k, v in chip_smoke.renamed(sd, chip_smoke.SGM_ENCODER)
                                        .items()})
    model = model_io.vae_encoder_from_ckpt(model_io.load_safetensors(path), cfg,
                                           prefix=prefix + "encoder.", device="cpu")
    assert all(torch.equal(v, sd[k].float()) for k, v in model.state_dict().items())
    params = jax_io.vae_encoder_params_from_ckpt(jax_io.load_safetensors(path), jnp.float32,
                                                 prefix=prefix + "encoder.")
    jcfg = JaxVAEEncoderConfig(block_out_channels=TINY, resnet_groups=4)
    x = np.random.RandomState(18).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(apply_vae_encoder(params, jnp.asarray(x), jcfg)),
                               atol=ATOL, rtol=RTOL)


def test_chip_smoke_diffusers_mirror_reads_back_in_both_packages(chip_smoke, tmp_path):
    from diffusionkit_tpu_torch.models import init_autoencoder

    cfg = tcfg.AutoencoderConfig(**dict(jt.TINY_AE_CFG, latent_channels_out=32,
                                        latent_channels_in=16))
    model = init_autoencoder(cfg, torch.Generator().manual_seed(19), device="cpu")
    path = tmp_path / "vae.safetensors"
    chip_smoke.write_safetensors(path, chip_smoke.renamed(
        model.state_dict(), chip_smoke.diffusers_rules(len(cfg.block_out_channels))))
    back = model_io.autoencoder_from_diffusers_ckpt(model_io.load_safetensors(path), cfg,
                                                    device="cpu")
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in back.state_dict().items())
    jcfg = JaxAutoencoderConfig(**dict(jt.TINY_AE_CFG, latent_channels_out=32,
                                       latent_channels_in=16))
    params = jax_io.autoencoder_params_from_diffusers_ckpt(jax_io.load_safetensors(path), jcfg,
                                                           jnp.float32)
    x = np.random.RandomState(20).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    jm, _ = autoencoder_encode(params, jnp.asarray(x), jcfg)
    with torch.no_grad():
        tm, _ = back.encode(torch.from_numpy(x))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=ATOL, rtol=RTOL)
