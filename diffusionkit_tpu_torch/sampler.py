"""Flow-matching sigma/timestep schedules and the Euler sampler.

A copy of ``diffusionkit_tpu/sampler.py``: schedules are pure host-side
float32 numpy, so both packages build bit-identical sigma grids (the SD3
grid keeps the reference's double-shift endpoint).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class FlowSchedule:
    """Discrete-flow sigma schedule: sigma(t) = shift*t / (1 + (shift-1)*t).

    ``is_flux`` switches the sigma-grid endpoints: SD3 builds ``num_steps``
    timesteps from sigma(1000)..sigma(1) and appends a final 0.0; FLUX builds
    ``num_steps + 1`` from sigma(1000)..sigma(0) (reference sampler.py:10-77,
    mlx/__init__.py:559-571).
    """

    shift: float = 1.0
    is_flux: bool = False
    num_timesteps: int = 1000

    def sigma(self, timestep):
        """sigma for timestep in [0, 1000] (reference sampler.py:31-35)."""
        t = np.asarray(timestep, dtype=np.float32) / self.num_timesteps
        if self.shift == 1.0:
            return t
        return np.asarray(
            self.shift * t / (1 + (self.shift - 1) * t), dtype=np.float32
        )

    def timestep(self, sigma):
        """timestep(sigma) = sigma * 1000 (reference sampler.py:28-29)."""
        return np.asarray(sigma, dtype=np.float32) * self.num_timesteps

    @property
    def sigma_min(self) -> float:
        start = 0 if self.is_flux else 1
        return float(self.sigma(start if self.is_flux else 1))

    @property
    def sigma_max(self) -> float:
        return float(self.sigma(self.num_timesteps))

    def get_sigmas(self, num_steps: int) -> np.ndarray:
        """Sigma grid for a run (reference mlx/__init__.py:559-571)."""
        start = self.timestep(self.sigma_max)
        end = self.timestep(self.sigma_min)
        n = num_steps + 1 if self.is_flux else num_steps
        timesteps = np.linspace(start, end, n, dtype=np.float32)
        sigs = [float(self.sigma(t)) for t in timesteps]
        if not self.is_flux:
            sigs.append(0.0)
        return np.asarray(sigs, dtype=np.float32)

    def calculate_denoised(self, sigma, model_output, model_input):
        """x0 estimate: x - sigma * v (reference sampler.py:37-39)."""
        return model_input - model_output * sigma

    def noise_scaling(self, sigma, noise, latent_image, max_denoise: bool = False):
        """Forward interpolant: sigma*noise + (1-sigma)*x (reference sampler.py:41-42)."""
        return sigma * noise + (1.0 - sigma) * latent_image

    def max_denoise(self, sigmas) -> bool:
        """Whether the run starts from pure noise (reference mlx/__init__.py:576-579)."""
        sigma = float(sigmas[0])
        return math.isclose(self.sigma_max, sigma, rel_tol=1e-05) or sigma > self.sigma_max


def ModelSamplingDiscreteFlow(shift: float = 1.0) -> FlowSchedule:
    """SD3 schedule (reference sampler.py:10-42)."""
    return FlowSchedule(shift=shift, is_flux=False)


def FluxSampler(shift: float = 1.0) -> FlowSchedule:
    """FLUX schedule (reference sampler.py:45-77)."""
    return FlowSchedule(shift=shift, is_flux=True)
