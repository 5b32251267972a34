"""Flow-match Euler scheduler with resolution-dependent timestep shift
(port of unitex_tpu/models/flux/scheduler.py).

diffusers FlowMatchEulerDiscreteScheduler as the reference configures it:
sigmas = linspace(1, 1/n, n), µ-shift from the sequence length.  The sigma
tables are computed in float64 numpy and stored as f32 tensors, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def calculate_shift(
    image_seq_len: int,
    base_seq_len: int = 256,
    max_seq_len: int = 4096,
    base_shift: float = 0.5,
    max_shift: float = 1.15,
) -> float:
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b


def time_shift(mu: float, sigma: np.ndarray) -> np.ndarray:
    """exp-µ sigma warp: σ' = e^µ / (e^µ + (1/σ - 1))."""
    return math.exp(mu) / (math.exp(mu) + (1.0 / sigma - 1.0))


@dataclasses.dataclass(frozen=True)
class FlowMatchEulerScheduler:
    """sigmas [n+1] (terminal 0 appended), timesteps [n] = sigma*1000."""

    sigmas: torch.Tensor
    timesteps: torch.Tensor

    @classmethod
    def create(
        cls,
        num_inference_steps: int,
        image_seq_len: int,
        base_image_seq_len: int = 256,
        max_image_seq_len: int = 4096,
        base_shift: float = 0.5,
        max_shift: float = 1.15,
        device="cuda",
    ) -> "FlowMatchEulerScheduler":
        sigmas = np.linspace(1.0, 1.0 / num_inference_steps, num_inference_steps)
        mu = calculate_shift(image_seq_len, base_image_seq_len,
                             max_image_seq_len, base_shift, max_shift)
        sigmas = time_shift(mu, sigmas)
        timesteps = sigmas * 1000.0
        sigmas = np.append(sigmas, 0.0)
        return cls(
            sigmas=torch.tensor(sigmas, dtype=torch.float32, device=device),
            timesteps=torch.tensor(timesteps, dtype=torch.float32, device=device),
        )

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]

    def step(self, model_output: torch.Tensor, i: int, sample: torch.Tensor):
        """Euler step x_{i+1} = x_i + (σ_{i+1} − σ_i) · v."""
        return sample + (self.sigmas[i + 1] - self.sigmas[i]) * model_output

    def scale_noise(self, sample: torch.Tensor, i: int, noise: torch.Tensor):
        """Forward interpolation z_t = (1−σ) x + σ ε."""
        sigma = self.sigmas[i]
        return (1.0 - sigma) * sample + sigma * noise
