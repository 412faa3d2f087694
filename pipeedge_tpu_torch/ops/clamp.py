"""Optimal pre-quantization clipping (Banner et al., NeurIPS 2019).

Port of `pipeedge_tpu/ops/clamp.py`: clamp activations to +/- alpha
before uniform quantization, alpha the analytically-optimal threshold for
a Laplace-distributed tensor, alpha = W(3 * 4^b) * sqrt(var/2), with a
GeLU variant alpha = W(3 * 4^(b+1)) * sqrt(E[x^2]). The Lambert-W factor
depends only on the bitwidth and is computed once on the host (scipy);
the variance is the population variance over the whole tensor, as
`jnp.var` computes it.
"""
from __future__ import annotations

from functools import lru_cache

import torch
from scipy.special import lambertw


@lru_cache(maxsize=None)
def clamp_factor_laplace(bit: int) -> float:
    """W(3 * 4^bit), the optimal Laplace clipping multiplier."""
    return float(lambertw(3.0 * 4.0 ** bit).real)


@lru_cache(maxsize=None)
def clamp_factor_gelu(bit: int) -> float:
    """W(3 * 4^(bit+1)) for half-bell post-GeLU tensors."""
    return float(lambertw(3.0 * 4.0 ** (bit + 1)).real)


def clamp_banner2019_laplace(x: torch.Tensor, bit: int) -> torch.Tensor:
    """Clamp to the Laplace-optimal threshold."""
    var = torch.var(x, correction=0)
    alpha = clamp_factor_laplace(bit) * torch.sqrt(0.5 * var)
    return torch.clamp(x, -alpha, alpha)


def clamp_banner2019_gelu(x: torch.Tensor, bit: int) -> torch.Tensor:
    """Clamp a post-GeLU tensor (half bell curve)."""
    second_moment = 2.0 * torch.mean(torch.square(x))
    alpha = clamp_factor_gelu(bit) * torch.sqrt(0.5 * second_moment)
    return torch.clamp(x, -alpha, alpha)
