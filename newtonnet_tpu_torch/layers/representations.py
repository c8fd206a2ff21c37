'''Radial edge featurization: cutoff envelopes and Bessel basis.

Plain functions over (already scaled) distances, numerically the same as
the JAX package's `layers/representations.py`:

  * scaled_norm:  dist = |disp| / r, dir = disp / |disp|
  * polynomial_cutoff (DimeNet p=9 envelope)
  * cosine_cutoff (Behler)
  * radial_bessel: sin(k pi d) / d, k = 1..n_basis (no 2/c normalization)
'''
import math

import torch


def scaled_norm(disp, r, eps=1e-12):
    '''Scaled norm + unit direction of displacement vectors.

    Args:
        disp: (..., 3) displacement vectors.
        r: cutoff radius (distances inside the cutoff scale into [0, 1)).
        eps: guard so masked/self entries (disp == 0) stay finite and
            differentiable; real edges are unaffected (|d| >> eps).

    Returns:
        dist (..., 1) = |disp| / r and dir (..., 3) = disp / |disp|.
    '''
    d2 = torch.sum(disp * disp, dim=-1, keepdim=True)
    norm = torch.sqrt(torch.clamp(d2, min=eps))
    return norm / r, disp / norm


def polynomial_cutoff(dist, p=9):
    '''DimeNet polynomial envelope, y(0)=1, y(1)=0.'''
    xp = dist ** p
    return (1.0
            - 0.5 * (p + 1) * (p + 2) * xp
            + p * (p + 2) * xp * dist
            - 0.5 * p * (p + 1) * xp * dist * dist)


def cosine_cutoff(dist):
    '''Behler cosine envelope, y(0)=1, y(1)=0.'''
    return 0.5 * (torch.cos(dist * math.pi) + 1.0)


def radial_bessel(dist, n_basis=20, frequencies=None):
    '''Radial Bessel basis sin(k pi d)/d for k = 1..n_basis: (..., 1)
    scaled distances -> (..., n_basis). `frequencies` (n_basis,) replaces
    the fixed k*pi grid (the trainable_basis option).'''
    if frequencies is None:
        frequencies = torch.arange(1, n_basis + 1, dtype=dist.dtype,
                                   device=dist.device) * math.pi
    return torch.sin(frequencies.to(dist.dtype) * dist) / dist
