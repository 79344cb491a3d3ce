"""Logging, device memory statistics and budgets, the inference context, and
image metrics."""

from __future__ import annotations

import logging
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch

_LOGGERS: Dict[str, logging.Logger] = {}


def get_logger(name: str) -> logging.Logger:
    if name in _LOGGERS:
        return _LOGGERS[name]
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(levelname)s:%(asctime)s:%(name)s: %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("DIFFUSIONKIT_TPU_LOGLEVEL", "INFO"))
        logger.propagate = False
    _LOGGERS[name] = logger
    return logger


def bytes2gigabytes(n: int) -> float:
    return n / (1024**3)


def device_memory_stats(device=None) -> Dict[str, Optional[int]]:
    """Allocator statistics of one CUDA device, in bytes.

    ``peak_memory`` is ``torch.cuda.max_memory_allocated`` (since the last
    ``torch.cuda.reset_peak_memory_stats``), ``active_memory`` is
    ``torch.cuda.memory_allocated``. Both are None for a CPU device.
    """
    device = torch.device(device) if device is not None else None
    if device is not None and device.type != "cuda":
        return {"peak_memory": None, "active_memory": None}
    if not torch.cuda.is_available():
        return {"peak_memory": None, "active_memory": None}
    return {
        "peak_memory": torch.cuda.max_memory_allocated(device),
        "active_memory": torch.cuda.memory_allocated(device),
    }


def hbm_scale(device=None) -> float:
    """The card's memory over the 16 GB chip on which the reference sized
    its memory-derived budgets (the denoise batch auto-split), never below
    1; ``DIFFUSIONKIT_TPU_HBM_SCALE`` overrides it. 1 off a CUDA device."""
    env = os.environ.get("DIFFUSIONKIT_TPU_HBM_SCALE")
    if env:
        return float(env)
    device = torch.device(device) if device is not None else None
    if (device is not None and device.type != "cuda") or not torch.cuda.is_available():
        return 1.0
    return max(1.0, torch.cuda.get_device_properties(device).total_memory / 16e9)


def inference_context(device=None) -> Dict[str, object]:
    """OS and device report, the reference's ``utils.inference_context``
    with ``torch`` in place of ``jax``: ``backend`` is the device's type,
    "cuda" or "cpu" (``device`` None: "cuda" where a card is there);
    ``process_index`` and ``num_processes`` are the ``torch.distributed``
    rank and world size when it is initialised, else 0 and 1."""
    import platform

    import torch.distributed as dist

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    cuda = device.type == "cuda"
    distributed = dist.is_available() and dist.is_initialized()
    return {
        "os": f"{platform.system()} {platform.release()}",
        "python": platform.python_version(),
        "torch": torch.__version__,
        "backend": device.type,
        "device_kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "num_devices": torch.cuda.device_count() if cuda else 1,
        "process_index": dist.get_rank() if distributed else 0,
        "num_processes": dist.get_world_size() if distributed else 1,
    }


def compute_psnr(reference: np.ndarray, proxy: np.ndarray) -> float:
    """Peak signal-to-noise ratio in dB."""
    reference = np.asarray(reference, dtype=np.float64).squeeze()
    proxy = np.asarray(proxy, dtype=np.float64).squeeze()
    assert reference.shape == proxy.shape, (reference.shape, proxy.shape)
    peak = np.abs(reference).max()
    noise = reference - proxy
    noise_power = np.power(noise, 2).mean()
    if noise_power == 0:
        return float("inf")
    return float(20 * np.log10(peak / np.sqrt(noise_power)))


def image_psnr(reference, image) -> float:
    """PSNR between two images (PIL Images or arrays)."""
    return compute_psnr(np.asarray(reference), np.asarray(image))
