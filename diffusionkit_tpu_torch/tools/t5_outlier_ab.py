"""The SmoothQuant fold's A/B at the encoder: the w8a8 T5 with and without it.

The counterpart of the JAX package's ``tools/t5_outlier_ab.py``. A T5
(T5-XXL by default, random weights from a seeded ``torch.Generator`` at HF
T5's initialisation scales) gets ``N_OUT`` residual-stream channels made
``FACTOR`` times hotter by ``quant_quality.inject_t5_outliers`` (the
regime real T5-XXL is known for, and the reason ``ops/smoothquant.py``
exists). It encodes two prompts in its own dtype, then as w8a8
(``w8a8_module_``) without the fold and with it (``smooth_t5`` on the
pipelines' calibration prompts), and reports each w8a8 encoder output's
SNR against the float one:

- on the channels that were not made hot (``snr_db``), as the JAX
  package's gate does (``tests/test_smoothquant.py``: the outliers
  dominate both the per-token int8 scale and the output's norm, which
  would hide the damage in a whole-tensor ratio); ``margin_db`` is the
  smoothed SNR less the plain one there;
- on every channel (``*_all_channels``), the JAX tool's own measure.

    python -m diffusionkit_tpu_torch.tools.t5_outlier_ab [out.json] [--device cpu]

On the card unless given ``--device cpu``. The prompts and the calibration
prompts are tokenized by ``SyntheticT5Tokenizer`` (the card has no
sentencepiece model), at 256 tokens.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import sys
from typing import List, Optional

import numpy as np
import torch

from .quant_quality import inject_t5_outliers

N_OUT, FACTOR = 16, 50.0
ALPHA = 0.5
MAX_LENGTH = 256
PROMPTS = ["a photo of a cat in a wizard hat",
           "an astronaut riding a horse on the moon, photorealistic"]


def hf_init_scales_(model, gen: torch.Generator) -> None:
    """Redraw a T5's weights at HF T5's initialisation scales: q with std
    (d_model d_kv)^-1/2, k/v/wi with d_model^-1/2, o with (heads d_kv)^-1/2,
    wo with d_ff^-1/2, the embedding with 1 and the bucket table with
    d_model^-1/2."""
    c = model.config
    with torch.no_grad():
        for layer in model.layers:
            layer.query_proj.weight.normal_(0.0, (c.d_model * c.d_kv) ** -0.5, generator=gen)
            for lin in (layer.key_proj, layer.value_proj, layer.wi_0, layer.wi_1):
                lin.weight.normal_(0.0, c.d_model**-0.5, generator=gen)
            layer.out_proj.weight.normal_(0.0, (c.num_heads * c.d_kv) ** -0.5, generator=gen)
            layer.wo.weight.normal_(0.0, c.d_ff**-0.5, generator=gen)
        model.wte.weight.normal_(0.0, 1.0, generator=gen)
        model.relative_attention_bias.weight.normal_(0.0, c.d_model**-0.5, generator=gen)


def snr_db(got, want, keep=None) -> float:
    """20 log10(|want| / |got - want|) over the last axis's ``keep``
    channels (all of them by default), in float64."""
    got, want = (np.asarray(t.float().cpu() if torch.is_tensor(t) else t, np.float64)
                 for t in (got, want))
    if keep is not None:
        got, want = got[..., keep], want[..., keep]
    return float(20.0 * np.log10(np.linalg.norm(want)
                                 / max(np.linalg.norm(got - want), 1e-30)))


def tokens_of(tokenizer, prompts: List[str], length: int) -> np.ndarray:
    """The prompts' tokens, zero-padded to ``length``."""
    out = np.zeros((len(prompts), length), np.int64)
    for i, p in enumerate(prompts):
        ids = list(tokenizer.tokenize(p))[:length]
        out[i, :len(ids)] = ids
    return out


@torch.no_grad()
def ab(model, tokens, channels, tokenizer=None, alpha: float = ALPHA) -> dict:
    """The A/B on ``model`` (outliers already injected in ``channels``;
    left as it is): the float output, w8a8 on a copy, and w8a8 of a
    smoothed copy, each copy freed before the next."""
    from ..ops.smoothquant import smooth_t5
    from ..ops.w8a8 import w8a8_module_

    tokens = torch.as_tensor(tokens, dtype=torch.long, device=model.wte.weight.device)
    want = model(tokens).float()
    keep = np.setdiff1d(np.arange(want.shape[-1]), channels)
    out = {}
    for name, smooth in (("w8a8_plain", False), ("w8a8_smooth", True)):
        q = copy.deepcopy(model)
        if smooth:
            smooth_t5(q, tokenizer, alpha)
        got = w8a8_module_(q)(tokens).float()
        out[name], out[f"{name}_all_channels"] = snr_db(got, want, keep), snr_db(got, want)
        del q, got
        gc.collect()
        if tokens.is_cuda:
            torch.cuda.empty_cache()
    out["margin_db"] = out["w8a8_smooth"] - out["w8a8_plain"]
    out["float_output_std"] = float(want.std())
    return out


def run(device: str = "cuda", config=None, n_out: int = N_OUT, factor: float = FACTOR,
        seed: int = 0, dtype: Optional[torch.dtype] = None, out_path: Optional[str] = None) -> dict:
    """Draw the T5 (``config``, T5-XXL by default; bf16 on the card, fp32
    on the CPU unless ``dtype``), inject the outliers, run ``ab`` on the
    prompts; write the report to ``out_path`` (if given) and return it."""
    from ..config import T5_XXL
    from ..models import init_t5
    from ..tokenizer import SyntheticT5Tokenizer

    if device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("t5_outlier_ab: no CUDA device (pass --device cpu for the plain "
                         "versions)")
    config = config or T5_XXL
    dtype = dtype or (torch.float32 if device == "cpu" else torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = init_t5(config, gen, device, dtype=dtype)
    hf_init_scales_(model, gen)
    channels = inject_t5_outliers(model, n_out, factor)
    tokenizer = SyntheticT5Tokenizer(max_length=MAX_LENGTH, vocab_size=config.vocab_size)
    report = {"t5_outlier_channels": n_out, "t5_outlier_factor": factor,
              "d_model": config.d_model, "layers": config.num_layers, "dtype": str(dtype),
              "device": (torch.cuda.get_device_name(0) if device != "cpu" else "cpu"),
              **ab(model, tokens_of(tokenizer, PROMPTS, MAX_LENGTH), channels, tokenizer)}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=1)
    return report


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default="t5_outlier_ab.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    report = run(args.device, out_path=args.out)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
