"""Faults planted under the timed path, for the test that sees ``correct``
come out false. Each ``plant`` returns the function that takes it out.

- ``step_unchanged``: every denoise step returns its latents unchanged;
- ``half_batch``: a batched call computes the first half of its prompts
  and hands their images out again for the rest;
- ``answer_altered``: every decoded image has a block of pixels changed
  where it is produced.

The exchange between chips does not exist in these one-card cells.
"""

from __future__ import annotations

from typing import Callable


def plant(name: str, pipe) -> Callable[[], None]:
    from diffusionkit_tpu_torch import pipeline as pl

    if name == "step_unchanged":
        saved = pl._cfg_euler_step
        pl._cfg_euler_step = lambda model, x, *a, **k: x.clone()

        def undo():
            pl._cfg_euler_step = saved
        return undo
    if name == "half_batch":
        orig = pipe.generate_images_batched

        def half(texts, *a, seeds=None, **k):
            n = len(texts)
            h = max(1, n // 2)
            images = orig(texts[:h], *a, seeds=None if seeds is None else seeds[:h], **k)
            return [images[i % h] for i in range(n)]

        pipe.generate_images_batched = half
        return lambda: None
    if name == "answer_altered":
        orig = pipe.decode_latents_to_u8

        def altered(latents):
            out = orig(latents).clone()
            out[:, :out.shape[1] // 4, :out.shape[2] // 4] ^= 0x40
            return out

        pipe.decode_latents_to_u8 = altered
        return lambda: None
    raise ValueError(f"unknown fault {name!r}")
