'''The port's latent Ewald energy (newtonnet_tpu_torch/ops/ewald.py)
against the JAX package's (newtonnet_tpu/ops/ewald.py) in float64: the
energies, their first derivatives in the charges, the positions and the
cell, a second derivative (the Hessian along a random direction), a
forward-mode derivative and the reverse-mode derivative of that, in the
'periodic', 'aperiodic' and 'auto' modes, all at 1e-12 of each output's
largest magnitude.

The frames: orthorhombic and triclinic cells and aperiodic graphs (a
zero cell), a mixed batch of all three under 'auto'; two padding atoms
per graph carrying garbage charges; positions shifted by up to 7 box
lengths, so the periodic branch's wrapping runs.
'''
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newtonnet_tpu.ops import ewald as jew
from newtonnet_tpu_torch.ops import ewald as tew

REL = 1e-12
CELLS = {
    'orthorhombic': np.diag([6.0, 7.0, 8.0]),
    'triclinic': np.array([[6.0, 0.0, 0.0], [1.5, 7.0, 0.0],
                           [0.8, -1.1, 8.0]]),
    'aperiodic': np.zeros((3, 3)),
}
# (mode, the cells of the batch's graphs, n_k)
CASES = [
    ('periodic', ('orthorhombic', 'orthorhombic', 'orthorhombic'), 2),
    ('periodic', ('triclinic', 'orthorhombic', 'triclinic'), 2),
    ('aperiodic', ('aperiodic', 'aperiodic', 'aperiodic'), 2),
    ('auto', ('orthorhombic', 'triclinic', 'aperiodic'), 2),
    ('auto', ('triclinic', 'aperiodic', 'orthorhombic'), 8),
]
SIGMA = 1.3


def frames(cells, seed, N=8):
    '''(charge, pos, cell, atom_mask, weights) as float64 numpy arrays for
    the named cells: the last two atoms of each graph are padding with
    garbage charges, and periodic graphs' atoms sit up to 7 box lengths
    outside the cell.'''
    rs = np.random.RandomState(seed)
    B = len(cells)
    cell = np.stack([CELLS[c] for c in cells])
    frac = rs.rand(B, N, 3)
    shift = rs.randint(-7, 8, size=(B, N, 3))
    pos = np.einsum('bnx,bxy->bny', frac + shift, cell)
    aperiodic = ~np.any(cell != 0, axis=(1, 2))
    pos[aperiodic] = rs.randn(int(aperiodic.sum()), N, 3) * 2.0
    mask = np.ones((B, N), bool)
    mask[:, -2:] = False
    charge = rs.randn(B, N) * 0.5
    charge[:, -2:] = rs.randn(B, 2) * 1e3
    return charge, pos, cell, mask, rs.randn(B)


@functools.lru_cache(maxsize=None)
def jax_reference(mode, n_k):
    '''One compiled JAX program per (mode, n_k) giving every number the
    tests compare: the energies (B,); for f = weights . energies, its
    gradient in (charge, pos, cell) and its Hessian along (vq, vpos,
    vcell); its derivative along the position tangent vt, and the
    gradient of that derivative in (charge, cell).'''
    def f(q, p, c, mask, w):
        return jnp.dot(jew.ewald_energy(q, p, c, mask, sigma=SIGMA, n_k=n_k,
                                        mode=mode), w)

    def run(q, p, c, mask, w, vq, vp, vc, vt):
        grad = jax.grad(f, argnums=(0, 1, 2))
        _, hv = jax.jvp(lambda *a: grad(*a, mask, w), (q, p, c),
                        (vq, vp, vc))

        def tangent(a, cc):
            return jax.jvp(lambda x: f(a, x, cc, mask, w), (p,), (vt,))[1]
        return {'energy': jew.ewald_energy(q, p, c, mask, sigma=SIGMA,
                                           n_k=n_k, mode=mode),
                'grad': grad(q, p, c, mask, w), 'hvp': hv,
                'tangent': tangent(q, c),
                'tangent_grad': jax.grad(tangent, argnums=(0, 1))(q, c)}
    return jax.jit(run)


def case(mode, cells, n_k):
    '''The frames, the directions, and the JAX program's numbers.'''
    q, pos, cell, mask, w = frames(cells, seed=n_k + len(mode))
    rs = np.random.RandomState(7)
    v = [rs.randn(*np.shape(a)) for a in (q, pos, cell, pos)]
    ref = jax_reference(mode, n_k)(q, pos, cell, mask, w, *v)
    return (q, pos, cell, mask, w), v, jax.tree.map(np.asarray, ref)


def torch_energy(mode, mask, weights, n_k):
    tm, tw = torch.from_numpy(mask), torch.from_numpy(weights)

    def f(q, p, c):
        return torch.dot(tew.ewald_energy(q, p, c, tm, sigma=SIGMA,
                                          n_k=n_k, mode=mode), tw)
    return f


def close(got, want, what):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    bar = REL * max(float(np.abs(want).max()), 1e-300)
    assert np.abs(got - want).max() <= bar, (what, np.abs(got - want).max(),
                                             bar)


def dense(grads, like):
    return [torch.zeros_like(a) if g is None else g
            for g, a in zip(grads, like)]


@pytest.mark.parametrize('mode, cells, n_k', CASES)
def test_energy_and_derivatives_match_jax(mode, cells, n_k):
    '''The per-graph energies, the gradient of a weighted sum of them in
    (charge, pos, cell), and that sum's Hessian along a random direction
    of all three (reverse over reverse in the port, forward over reverse
    in JAX).'''
    (q, pos, cell, mask, w), v, ref = case(mode, cells, n_k)
    assert np.isfinite(ref['energy']).all()
    args = [torch.tensor(a, requires_grad=True) for a in (q, pos, cell)]
    e_t = tew.ewald_energy(*args, torch.from_numpy(mask), sigma=SIGMA,
                           n_k=n_k, mode=mode)
    close(e_t, ref['energy'], 'energy')
    f = torch_energy(mode, mask, w, n_k)
    g_t = dense(torch.autograd.grad(f(*args), args, create_graph=True,
                                    allow_unused=True), args)
    for name, a, b in zip(('charge', 'pos', 'cell'), g_t, ref['grad']):
        close(a, b, f'd/d{name}')
    dot = sum((g * torch.from_numpy(t)).sum() for g, t in zip(g_t, v))
    hv_t = dense(torch.autograd.grad(dot, args, allow_unused=True), args)
    for name, a, b in zip(('charge', 'pos', 'cell'), hv_t, ref['hvp']):
        close(a, b, f'hessian row {name}')


@pytest.mark.parametrize('mode, cells, n_k', CASES)
def test_forward_mode_and_reverse_over_it_match_jax(mode, cells, n_k):
    '''torch.func.jvp of the energies along a position tangent against
    jax.jvp, and the gradient of that tangent in the charges and the cell
    (reverse over forward, the order fastgrad runs a charge-head model
    in) against JAX's.'''
    (q, pos, cell, mask, w), v, ref = case(mode, cells, n_k)
    f = torch_energy(mode, mask, w, n_k)
    tq, tc = (torch.tensor(a, requires_grad=True) for a in (q, cell))
    _, t_t = torch.func.jvp(lambda p: f(tq, p, tc),
                            (torch.from_numpy(pos),),
                            (torch.from_numpy(v[3]),))
    close(t_t, ref['tangent'], 'tangent')
    g_t = dense(torch.autograd.grad(t_t, (tq, tc), allow_unused=True),
                (tq, tc))
    for name, a, b in zip(('charge', 'cell'), g_t, ref['tangent_grad']):
        close(a, b, f'd tangent / d{name}')


def test_unknown_mode_raises_as_in_jax():
    q, pos, cell, mask, _ = frames(('orthorhombic',), seed=0)
    with pytest.raises(ValueError, match="unknown ewald mode 'ewald'"):
        jew.ewald_energy(q, pos, cell, mask, mode='ewald')
    with pytest.raises(ValueError, match="unknown ewald mode 'ewald'"):
        tew.ewald_energy(*(torch.from_numpy(a) for a in (q, pos, cell,
                                                          mask)),
                         mode='ewald')
