"""Whether the timed path's outputs are correct: a sample of the images the
window produced, drawn from the seed, against the plain reference run on
the same prompts, seeds and source images with weights drawn again from
the seed.

The numbers compared (``errors``) are the largest over the sample of
||image - reference|| / ||reference - mean(reference)|| on the uint8
pixels: the error in units of the image's own variation. Their limits are the cell's ``check`` (PERF.md gives the
readings they were set from).
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

import build
import traffic

sys.path.insert(0, str(Path(__file__).resolve().parent / "reference"))
import plain  # noqa: E402


def image_err(got: np.ndarray, want: np.ndarray) -> float:
    """||got - want|| / ||want - mean(want)|| over the uint8 pixels: the
    error in units of the image's own variation."""
    g, w = got.astype(np.float64), want.astype(np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w - w.mean()), 1e-12))


def errors(got: List[np.ndarray], want: List[np.ndarray]) -> Dict[str, float]:
    """The number compared: ``image_err``, the worst over the sample."""
    return {"image_err": max(image_err(g, w) for g, w in zip(got, want))}


def sample(outputs: List[Dict], cell: Dict, seed: int) -> List[Dict]:
    """The outputs to compare: for a batched cell one whole batch drawn from
    the seed, else ``check.requests`` drawn from the seed."""
    if not outputs:
        return []
    rng = np.random.default_rng([int(seed) % (2**63), 7])
    if cell["entry"] == "batched":
        b = cell["traffic"]["batch"]
        n_batches = len(outputs) // b
        k = int(rng.integers(0, n_batches))
        return outputs[k * b:(k + 1) * b]
    n = min(cell["check"]["requests"], len(outputs))
    idx = sorted(rng.choice(len(outputs), size=n, replace=False))
    return [outputs[i] for i in idx]


@torch.inference_mode()
def reference_images(config: Dict, cell: Dict, seed: int, reqs: List[Dict], precision: str,
                     device) -> List[np.ndarray]:
    """The reference's images of ``reqs``, computed in ``precision``
    ("fp32": the reference; "fp8" / "fp8a4": the control)."""
    plain.exact_fp32()
    P = plain.Precision(precision)
    t = cell["traffic"]
    img2img = cell["entry"] == "img2img"
    w = build.draw_weights(config, seed, device, with_encoder=img2img)
    dev = torch.device(device)
    flux = config["family"] == "flux"
    prompts = [r["prompt"] for r in reqs]
    cfg_on = t["cfg"] > 1
    texts = prompts + ([""] * len(prompts) if cfg_on else [])
    if flux:
        tok_l = torch.tensor([plain.clip_tokens(p, True) for p in prompts], device=dev)
        _, pooled = plain.clip(P, w["clip_l"], tok_l, config["clip_l"]["config"]["num_heads"],
                               config["clip_l"]["config"]["hidden_act"])
        tok5 = torch.tensor([plain.t5_tokens(p, config["t5"]["tokens"]) for p in prompts],
                            device=dev)
        cond = plain.t5_w8a8(P, w["t5"], tok5, config["t5"]["config"]["num_heads"])
    else:
        outs = []
        for name, eos in (("clip_l", True), ("clip_g", False)):
            c = config[name]["config"]
            tok = torch.tensor([plain.clip_tokens(p, eos) for p in texts], device=dev)
            outs.append(plain.clip(P, w[name], tok, c["num_heads"], c["hidden_act"]))
        (h_l, p_l), (h_g, p_g) = outs
        h = torch.cat([h_l, h_g], dim=-1)
        h = torch.cat([h, h.new_zeros(*h.shape[:-1], 4096 - h.shape[-1])], dim=-1)
        cond = torch.cat([h, torch.zeros_like(h)], dim=1)  # T5 off: its rows zero
        pooled = torch.cat([p_l, p_g], dim=-1)
    del w["clip_l"]
    w.pop("clip_g", None)
    w.pop("t5", None)
    scale, shift = plain.FLUX_LATENT if flux else plain.SD3_LATENT
    lh, lw = t["height"] // 8, t["width"] // 8
    sig = plain.sigmas(t["steps"], config["shift"], flux)
    if img2img:
        start = int(t["steps"] * (1 - t["denoise"]))
        sig = sig[start:]
        x_t = []
        for r in reqs:
            # the source image drawn again from the seed (the program read
            # the same pixels from its lossless PNG)
            arr = traffic.source_image(seed, r["source"], t["height"], t["width"])
            img = torch.from_numpy(arr.astype(np.float32) / 255 * 2 - 1)[None].to(dev)
            enc_noise = torch.from_numpy(plain.noise(r["seed"], (1, lh, lw, 16))).to(dev)
            P_enc = P.for_model(config["vae_encoder"]["dtype"])
            with P_enc.tf32():
                mean, logvar = plain.vae_encode(P_enc, w["encoder"], img).chunk(2, dim=-1)
            lat = mean + torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0)) * enc_noise
            x_t.append(((lat.cpu().numpy() - shift) * scale).astype(np.float32))
        x_t = np.concatenate(x_t)
    else:
        x_t = np.full((len(reqs), lh, lw, 16), plain.EMPTY_LATENT, np.float32)
    noise = np.concatenate([plain.noise(r["seed"], (1, lh, lw, 16)) for r in reqs])
    x0 = np.asarray(sig[0] * noise + (1.0 - sig[0]) * x_t, np.float32)
    model = plain.MMDiTRef(P, w["mmdit"], config["mmdit"], config["quantize_mmdit"])
    x = plain.denoise(model, torch.from_numpy(x0).to(dev), sig, cond, pooled, t["cfg"])
    model.drop_grids()
    del model
    lat = x / scale + shift
    return [plain.to_u8(plain.vae_decode(P, w["decoder"], lat[i:i + 1]))[0]
            for i in range(lat.shape[0])]


def compare(config: Dict, cell: Dict, seed: int, outputs: List[Dict], device,
            precision: str = "fp32", keep: Dict = None) -> Dict[str, float]:
    """``image_err`` of the sampled outputs against the reference; ``keep``
    takes the sample and the reference's images."""
    reqs = sample(outputs, cell, seed)
    if not reqs:
        return {"image_err": float("inf"), "compared": 0}
    ref = reference_images(config, cell, seed, [o["request"] for o in reqs], precision, device)
    if keep is not None:
        keep.update(sample=reqs, reference=ref)
    return {**errors([o["image"] for o in reqs], ref), "compared": len(ref)}
