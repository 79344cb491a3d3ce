"""Logging, device memory statistics and image metrics."""

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
