'''The port's geometry (newtonnet_tpu_torch/layers/representations.py,
ops/linalg3.py, ops/neighbors.py) against the JAX package's, in float64.

Tolerance 1e-12: the same formulas in the same order, so only the last
bits of transcendental functions may differ between the two libraries.
'''
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newtonnet_tpu.layers import representations as rep_j
from newtonnet_tpu.ops import linalg3 as la_j
from newtonnet_tpu.ops import neighbors as nb_j
from newtonnet_tpu_torch.layers import representations as rep_t
from newtonnet_tpu_torch.ops import linalg3 as la_t
from newtonnet_tpu_torch.ops import neighbors as nb_t

TOL = 1e-12


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol,
                               rtol=tol)


def _batch():
    '''Two graphs of 6 slots: an aperiodic one with 2 padded atoms and a
    periodic one in a triclinic cell, with atoms straddling its faces.'''
    rs = np.random.RandomState(0)
    pos = rs.rand(2, 6, 3) * 4.0
    pos[1] = rs.rand(6, 3) @ np.array([[5.0, 0.0, 0.0], [1.2, 4.5, 0.0],
                                       [0.7, -0.9, 4.8]]) * 1.1
    cell = np.zeros((2, 3, 3))
    cell[1] = [[5.0, 0.0, 0.0], [1.2, 4.5, 0.0], [0.7, -0.9, 4.8]]
    z = np.array([[6, 1, 8, 1, 0, 0], [6, 6, 1, 8, 1, 7]])
    return z, pos, cell


def test_radial_functions():
    d = np.random.RandomState(1).rand(7, 5, 1) * 1.2 + 1e-3
    dt = torch.from_numpy(d)
    _close(rep_t.polynomial_cutoff(dt), rep_j.polynomial_cutoff(d))
    _close(rep_t.cosine_cutoff(dt), rep_j.cosine_cutoff(jnp.asarray(d)))
    _close(rep_t.radial_bessel(dt, 20), rep_j.radial_bessel(jnp.asarray(d),
                                                           20))
    disp = np.random.RandomState(2).randn(4, 5, 3)
    disp[0, 0] = 0.0  # a self pair: the eps guard keeps it finite
    for t, j in zip(rep_t.scaled_norm(torch.from_numpy(disp), 5.0),
                    rep_j.scaled_norm(jnp.asarray(disp), 5.0)):
        _close(t, j)


def test_det_and_inverse():
    a = np.random.RandomState(3).randn(5, 3, 3) + 3 * np.eye(3)
    _close(la_t.det3x3(torch.from_numpy(a)), la_j.det3x3(jnp.asarray(a)))
    _close(la_t.inv3x3(torch.from_numpy(a)), la_j.inv3x3(jnp.asarray(a)))


@pytest.mark.parametrize('mic_mode', ['exact', 'reference'])
def test_dense_graph(mic_mode):
    z, pos, cell = _batch()
    disp_t, adj_t = nb_t.dense_graph(torch.from_numpy(pos),
                                     torch.from_numpy(cell),
                                     torch.from_numpy(z > 0), 3.0,
                                     mic_mode=mic_mode)
    disp_j, adj_j = nb_j.dense_graph(jnp.asarray(pos), jnp.asarray(cell),
                                     jnp.asarray(z > 0), 3.0,
                                     mic_mode=mic_mode)
    _close(disp_t, disp_j)
    np.testing.assert_array_equal(adj_t.numpy(), np.asarray(adj_j))
    assert adj_t[1].any() and not adj_t[0, 4:].any()


@pytest.mark.parametrize('mic_mode', ['exact', 'reference'])
def test_feature_position_gradients(mic_mode):
    '''d(sum of rbf and dir weighted by fixed cotangents)/d(pos, cell):
    torch.autograd against jax.vjp.'''
    z, pos, cell = _batch()
    rs = np.random.RandomState(4)
    w_rbf = rs.randn(2, 6, 6, 8)
    # no cotangent on the self pairs' directions: their 1/sqrt(eps) = 1e6
    # derivatives cancel between pos_i and pos_j only to 1e6 * 2^-52, and
    # the model masks those pairs with adj anyway
    w_dir = rs.randn(2, 6, 6, 3) * (1.0 - np.eye(6))[None, :, :, None]

    def feats(lib, rep, nb, p, c):
        disp, adj = nb.dense_graph(p, c, lib.asarray(z > 0), 3.0,
                                   mic_mode=mic_mode)
        dist, dir_ = rep.scaled_norm(disp, 3.0)
        rbf = rep.polynomial_cutoff(dist) * rep.radial_bessel(dist, 8)
        return rbf, dir_

    _, vjp = jax.vjp(lambda p, c: feats(jnp, rep_j, nb_j, p, c),
                     jnp.asarray(pos), jnp.asarray(cell))
    gp_j, gc_j = vjp((jnp.asarray(w_rbf), jnp.asarray(w_dir)))

    p_t = torch.from_numpy(pos).requires_grad_(True)
    c_t = torch.from_numpy(cell).requires_grad_(True)
    rbf, dir_ = feats(torch, rep_t, nb_t, p_t, c_t)
    loss = (rbf * torch.from_numpy(w_rbf)).sum() \
        + (dir_ * torch.from_numpy(w_dir)).sum()
    gp_t, gc_t = torch.autograd.grad(loss, (p_t, c_t))
    _close(gp_t, gp_j)
    _close(gc_t, gc_j)
