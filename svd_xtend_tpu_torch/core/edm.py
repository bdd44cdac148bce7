"""EDM (Karras et al. 2022) diffusion math on f32 tensors.

Port of ``svd_xtend_tpu/core/edm.py``: the log-normal σ sampler, timestep
t = 0.25·ln σ, the σ_data = 1 preconditioning scalings, the denoiser, the
loss weight and weighted denoising loss, the Karras schedule and the Euler
step. Every function computes in f32 regardless of the input dtype.
"""

from __future__ import annotations

from typing import Optional

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def rand_log_normal(shape, loc: float = 0.0, scale: float = 1.0, *,
                    generator: Optional[torch.Generator] = None,
                    device=None) -> torch.Tensor:
    """σ ~ exp(N(loc, scale²)), f32, drawn from `generator`."""
    return torch.exp(torch.randn(shape, generator=generator, device=device,
                                 dtype=torch.float32) * scale + loc)


def sigma_to_t(sigma) -> torch.Tensor:
    """Continuous EDM timestep fed to the UNet."""
    return 0.25 * torch.log(_f32(sigma))


def edm_scalings(sigma):
    """(c_skip, c_out, c_in) for σ_data = 1:
    denoised = c_out · F(c_in · x; t) + c_skip · x."""
    sigma = _f32(sigma)
    s2p1 = sigma * sigma + 1.0
    return 1.0 / s2p1, -sigma * torch.rsqrt(s2p1), torch.rsqrt(s2p1)


def denoise(model_out: torch.Tensor, noisy: torch.Tensor, sigma) -> torch.Tensor:
    """EDM preconditioned denoiser output; `sigma` broadcasts on the sample."""
    c_skip, c_out, _ = edm_scalings(sigma)
    return model_out.float() * c_out + noisy.float() * c_skip


def loss_weight(sigma) -> torch.Tensor:
    """λ(σ) = (1 + σ²) / σ²."""
    sigma = _f32(sigma)
    return (1.0 + sigma * sigma) / (sigma * sigma)


def weighted_denoising_loss(denoised: torch.Tensor, target: torch.Tensor,
                            sigma) -> torch.Tensor:
    """Mean over the batch of each sample's mean λ(σ)-weighted squared
    error, f32; `sigma` broadcasts on the sample, (B, 1, ...)."""
    err = (denoised.float() - target.float()) ** 2
    per_sample = (loss_weight(sigma) * err).reshape(err.shape[0], -1).mean(1)
    return per_sample.mean()


def karras_sigmas(num_steps: int, sigma_min: float = 0.002,
                  sigma_max: float = 700.0, rho: float = 7.0) -> torch.Tensor:
    """Descending Karras schedule with a terminal 0, shape (num_steps + 1,)."""
    ramp = torch.linspace(0.0, 1.0, num_steps, dtype=torch.float32)
    min_inv_rho = sigma_min ** (1.0 / rho)
    max_inv_rho = sigma_max ** (1.0 / rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    return torch.cat([sigmas, torch.zeros(1, dtype=torch.float32)])


def precondition_inputs(noisy: torch.Tensor, sigma) -> torch.Tensor:
    """x · c_in (scale-model-input)."""
    _, _, c_in = edm_scalings(sigma)
    return noisy.float() * c_in


def euler_step(sample: torch.Tensor, denoised: torch.Tensor, sigma,
               sigma_next) -> torch.Tensor:
    """x <- x + (σ_next - σ) · (x - denoised) / σ."""
    d = (sample.float() - denoised.float()) / sigma
    return sample.float() + d * (sigma_next - sigma)
