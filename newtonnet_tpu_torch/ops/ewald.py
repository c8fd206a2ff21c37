'''Latent Ewald summation: the long-range energy of latent charges (the
JAX package's ops/ewald.py, plain PyTorch as models/xla_stack.py is).

  * periodic:  E_lr = (2 pi / V) * sum_{0 < |k|, k in the n_k cube}
                   exp(-sigma^2 k^2 / 2) / k^2 * |S(k)|^2,
               S(k) = sum_i q_i exp(i k . r_i)
  * aperiodic: E_lr = 1/2 sum_{i != j} q_i q_j erf(|r_ij| / (sqrt(2) sigma))
                   / |r_ij|

sigma is the pair-combined Gaussian width; the periodic sum keeps the
Gaussian self-energy and has no k = 0 term (tinfoil boundary), as the
JAX package defines them. Every sum is over static padded shapes with
masks. Values that a mask later discards are computed from safe inputs
(k^2 = 1 at the origin, the identity cell of an aperiodic graph), so no
derivative of any order, reverse or forward mode, sees a division by
zero. Positions are wrapped into the cell before the phase (the
remainder's derivative is the identity), so frames many box lengths out
keep their phases' precision; aperiodic graphs keep their raw positions.
'''
import math

import torch

from newtonnet_tpu_torch.ops.linalg3 import det3x3, inv3x3

TWO_PI = 2.0 * math.pi
EWALD_MODES = ('periodic', 'aperiodic', 'auto')


def _k_lattice(n_k, device):
    '''The integer reciprocal-lattice offsets of the n_k cube, (M, 3) with
    M = (2 n_k + 1)^3, origin included, and an (M,) mask that is False at
    the origin only.'''
    r = torch.arange(-n_k, n_k + 1, device=device)
    kx, ky, kz = torch.meshgrid(r, r, r, indexing='ij')
    k = torch.stack([kx.reshape(-1), ky.reshape(-1), kz.reshape(-1)], dim=-1)
    return k, ~(k == 0).all(dim=-1)


def _is_periodic(cell):
    return (cell != 0).any(dim=-1).any(dim=-1)


def ewald_energy_periodic(charge, pos, cell, atom_mask, sigma=1.0, n_k=8):
    '''Reciprocal-space energy (B,) of charge (B, N), pos (B, N, 3) and
    cell rows (B, 3, 3); 0 for a graph with an all-zero cell.'''
    is_periodic = _is_periodic(cell)
    eye = torch.eye(3, dtype=cell.dtype, device=cell.device)
    safe_cell = torch.where(is_periodic[:, None, None], cell, eye)
    volume = torch.abs(det3x3(safe_cell))
    inv = inv3x3(safe_cell)
    # reciprocal rows: b = 2 pi inv(cell)^T (the cell's rows are the
    # lattice vectors)
    recip = TWO_PI * inv.transpose(-1, -2)
    offsets, k_mask = _k_lattice(n_k, pos.device)
    kvec = torch.einsum('mx,bxy->bmy', offsets.to(pos.dtype), recip)
    k2 = torch.sum(kvec * kvec, dim=-1)
    k2_safe = torch.where(k_mask, k2, 1.0)
    frac = torch.einsum('bny,byx->bnx', pos, inv)
    pos_w = torch.einsum('bnx,bxy->bny', torch.remainder(frac, 1.0),
                         safe_cell)
    pos_w = torch.where(is_periodic[:, None, None], pos_w, pos)
    phase = torch.einsum('bmy,bny->bmn', kvec, pos_w)
    q = charge * atom_mask.to(charge.dtype)
    s_re = torch.einsum('bmn,bn->bm', torch.cos(phase), q)
    s_im = torch.einsum('bmn,bn->bm', torch.sin(phase), q)
    s2 = s_re * s_re + s_im * s_im
    weight = torch.exp(-0.5 * sigma * sigma * k2_safe) / k2_safe
    weight = torch.where(k_mask, weight, 0.0)
    energy = (TWO_PI / volume) * torch.sum(weight * s2, dim=-1)
    return torch.where(is_periodic, energy, 0.0)


def ewald_energy_aperiodic(charge, pos, atom_mask, sigma=1.0, eps=1e-12):
    '''Direct-space smeared Coulomb energy (B,) of isolated graphs.'''
    disp = pos[:, :, None, :] - pos[:, None, :, :]
    d = torch.sqrt(torch.clamp(torch.sum(disp * disp, dim=-1), min=eps))
    n = pos.shape[1]
    pair_mask = (atom_mask[:, :, None] & atom_mask[:, None, :]
                 & ~torch.eye(n, dtype=torch.bool, device=pos.device))
    q = charge * atom_mask.to(charge.dtype)
    qq = q[:, :, None] * q[:, None, :]
    kernel = torch.special.erf(d / (math.sqrt(2.0) * sigma)) / d
    return 0.5 * torch.sum(torch.where(pair_mask, qq * kernel, 0.0),
                           dim=(1, 2))


def ewald_energy(charge, pos, cell, atom_mask, sigma=1.0, n_k=8,
                 mode='auto'):
    '''Long-range latent-charge energy (B,). mode 'periodic' or
    'aperiodic' computes one branch for every graph; 'auto' computes both
    and picks per graph by its cell (all-zero: aperiodic), which a mixed
    batch needs and a homogeneous one pays twice for
    (models/output.NewtonNet.with_ewald_mode resolves it).'''
    if mode == 'periodic':
        return ewald_energy_periodic(charge, pos, cell, atom_mask,
                                     sigma=sigma, n_k=n_k)
    if mode == 'aperiodic':
        return ewald_energy_aperiodic(charge, pos, atom_mask, sigma=sigma)
    if mode != 'auto':
        raise ValueError(f'unknown ewald mode {mode!r}')
    e_per = ewald_energy_periodic(charge, pos, cell, atom_mask, sigma=sigma,
                                  n_k=n_k)
    e_aper = ewald_energy_aperiodic(charge, pos, atom_mask, sigma=sigma)
    return torch.where(_is_periodic(cell), e_per, e_aper)
