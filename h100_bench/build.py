"""The system under test, built from a configuration file and the run's seed.

The pattern of ``chip_smoke.py``'s ``build_sd3`` and ``build_flux_w4a8`` at
commit c82efae: the pipeline made with ``load=False, low_memory_mode=False``,
its models assigned, the synthetic tokenizers (the card has no tokenizer
files). Here the models are built on the meta device and take weights that
``weights.draw`` made from the seed (``load_state_dict(assign=True)``), so
the values are the benchmark's and the plain reference can draw them again.

A configuration's ``family`` names the builder below; a configuration that
needs another one adds ``configs/<name>.py`` with a ``build(config, seed,
device, workload)`` function, which ``build`` prefers.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path
from typing import Dict

import torch

import weights

HERE = Path(__file__).resolve().parent

# Salts of the models' generators (``weights.generator``).
SALT = {"mmdit": 1, "clip_l": 2, "clip_g": 3, "t5": 4, "decoder": 5, "encoder": 6}

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def mmdit_config(m: Dict):
    """The port's ``MMDiTConfig`` of a configuration's ``mmdit`` group."""
    from diffusionkit_tpu_torch.config import MMDiTConfig, PositionalEncoding

    fields = {f.name for f in dataclasses.fields(MMDiTConfig)}
    kw = {k: v for k, v in m.items() if k in fields}
    kw["hidden_size_override"] = m["hidden_size"]
    kw["pos_embed_type"] = PositionalEncoding[m["pos_embed_type"]]
    kw["dtype"] = DTYPES[m["dtype"]]
    for key in ("rope_axes_dim", "upcast_multimodal_blocks", "upcast_unified_blocks"):
        if kw.get(key) is not None:
            kw[key] = tuple(kw[key])
    return MMDiTConfig(**kw)


def meta_models(config: Dict, with_encoder: bool) -> Dict[str, torch.nn.Module]:
    """The configuration's models on the meta device: structure only."""
    from diffusionkit_tpu_torch.config import (CLIPTextModelConfig, T5Config, VAEDecoderConfig,
                                               VAEEncoderConfig)
    from diffusionkit_tpu_torch.models.clip import CLIPTextModel
    from diffusionkit_tpu_torch.models.mmdit import MMDiT
    from diffusionkit_tpu_torch.models.t5 import T5Encoder
    from diffusionkit_tpu_torch.models.vae import VAEDecoder, VAEEncoder

    bits = {None: None, "w4a8": 4}[config["quantize_mmdit"]]
    tuple_keys = ("block_out_channels",)

    def cfg(cls, d):
        return cls(**{k: (tuple(v) if k in tuple_keys else v) for k, v in d.items()})

    models = {}
    with torch.device("meta"):
        models["mmdit"] = MMDiT(mmdit_config(config["mmdit"]), quantize_bits=bits)
        for name in ("clip_l", "clip_g"):
            if name in config:
                c = config[name]
                models[name] = CLIPTextModel(cfg(CLIPTextModelConfig, c["config"]),
                                             DTYPES[c["dtype"]])
        if "t5" in config:
            models["t5"] = T5Encoder(cfg(T5Config, config["t5"]["config"]),
                                     DTYPES[config["t5"]["dtype"]])
        dec = config["vae_decoder"]
        models["decoder"] = VAEDecoder(cfg(VAEDecoderConfig, dec["config"]), DTYPES[dec["dtype"]])
        if with_encoder:
            enc = config["vae_encoder"]
            models["encoder"] = VAEEncoder(cfg(VAEEncoderConfig, enc["config"]),
                                           DTYPES[enc["dtype"]])
    return models


def draw_weights(config: Dict, seed: int, device, with_encoder: bool
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every model's raw weights from ``seed``: the same values for the
    program and, drawn again after the window, for the reference."""
    out = {}
    for name, model in meta_models(config, with_encoder).items():
        rule = weights.vae_rule if name in ("decoder", "encoder") else weights.transformer_rule
        out[name] = weights.draw(weights.spec_of(model.state_dict()), rule,
                                 weights.generator(seed, SALT[name], device), device)
    return out


def _assign(model: torch.nn.Module, state: Dict[str, torch.Tensor]) -> torch.nn.Module:
    model.load_state_dict(state, strict=True, assign=True)
    for p in model.parameters():
        p.requires_grad_(False)
    return model.eval()


def build(config: Dict, seed: int, device, workload: Dict):
    """The pipeline of ``config`` with weights from ``seed``."""
    custom = HERE / "configs" / f"{config['name']}.py"
    if custom.exists():
        spec = importlib.util.spec_from_file_location(f"config_{config['name']}", custom)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.build(config, seed, device, workload)
    return FAMILIES[config["family"]](config, seed, device, workload)


def _tokenizers(pipe, config: Dict) -> None:
    from diffusionkit_tpu_torch.tokenizer import (CLIPTokenizer, SyntheticT5Tokenizer,
                                                  synthetic_clip_vocab)

    vocab = synthetic_clip_vocab()
    pipe.tokenizer_l = CLIPTokenizer({}, vocab, pad_with_eos=True)
    if "clip_g" in config:
        pipe.tokenizer_g = CLIPTokenizer({}, vocab, pad_with_eos=False)
    if "t5" in config:
        pipe.t5_tokenizer = SyntheticT5Tokenizer(max_length=config["t5"]["tokens"])


def _models(pipe, config: Dict, seed: int, device, workload: Dict) -> None:
    with_encoder = workload.get("entry") == "img2img"
    models = meta_models(config, with_encoder)
    drawn = draw_weights(config, seed, device, with_encoder)
    for name in ("clip_l", "clip_g", "t5", "decoder", "encoder"):
        if name in models:
            setattr(pipe, name, _assign(models[name], drawn.pop(name)))
    # last: the setter converts (w4a8 adds each packed linear's wscale)
    pipe.mmdit = _assign(models["mmdit"], drawn.pop("mmdit"))


def build_sd3(config: Dict, seed: int, device, workload: Dict):
    from diffusionkit_tpu_torch.pipeline import DiffusionPipeline

    pipe = DiffusionPipeline(load=False, low_memory_mode=False, device=device,
                             use_t5="t5" in config, shift=config["shift"],
                             quantize_mmdit=config["quantize_mmdit"] or False,
                             w16=config["mmdit"]["dtype"] == "bfloat16",
                             a16=config["vae_decoder"]["dtype"] == "bfloat16")
    _tokenizers(pipe, config)
    _models(pipe, config, seed, device, workload)
    return pipe


def build_flux(config: Dict, seed: int, device, workload: Dict):
    from diffusionkit_tpu_torch.pipeline import FluxPipeline

    pipe = FluxPipeline(load=False, low_memory_mode=False, device=device,
                        shift=config["shift"], quantize_mmdit=config["quantize_mmdit"] or False,
                        quantize_t5=config["t5"]["quantize"] == "w8a8",
                        w16=config["mmdit"]["dtype"] == "bfloat16",
                        a16=config["vae_decoder"]["dtype"] == "bfloat16")
    _tokenizers(pipe, config)  # before the T5: its SmoothQuant calibration tokenizes
    _models(pipe, config, seed, device, workload)
    return pipe


FAMILIES = {"sd3": build_sd3, "flux": build_flux}
