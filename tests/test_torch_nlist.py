'''The port's neighbour lists (newtonnet_tpu_torch/ops/nlist.py) against
the JAX package's (newtonnet_tpu/ops/nlist.py), in float64 on the CPU
(tests/conftest.py turns on JAX's float64) at atol 1e-12: the same
positions, cells and masks (numpy, from a seed) go through both. Lists
are compared where the mask is set: masked slots tie
at -inf, and torch.topk and jax.lax.top_k may order those ties
differently.'''
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newtonnet_tpu.ops import nlist as jax_nlist
from newtonnet_tpu_torch.ops import nlist


def _system(periodic, seed, B=2, N=11):
    rs = np.random.RandomState(seed)
    mask = np.ones((B, N), bool)
    mask[1, N - 3:] = False  # padding atoms
    if periodic:
        L = 6.0
        pos = rs.rand(B, N, 3) * L
        cell = np.broadcast_to(np.diag([L, L + 0.5, L - 0.3]), (B, 3, 3))
        cell = cell + 0.2 * np.triu(rs.rand(B, 3, 3), 1)  # a tilted box
    else:
        pos = rs.randn(B, N, 3) * 2.0
        cell = np.zeros((B, 3, 3))
    return pos, np.ascontiguousarray(cell), mask


def _both(pos, cell, mask, cutoff, k_max):
    out_j = jax_nlist.neighbor_list(jnp.asarray(pos), jnp.asarray(cell),
                                    jnp.asarray(mask), cutoff, k_max,
                                    chunk=4)
    out_t = nlist.neighbor_list(torch.from_numpy(pos), torch.from_numpy(cell),
                                torch.from_numpy(mask), cutoff, k_max,
                                chunk=4)
    return [np.asarray(a) for a in out_j], [a.numpy() for a in out_t]


@pytest.mark.parametrize('periodic, cutoff, k_max', [
    (False, 3.0, 48), (True, 3.0, 48), (True, 4.0, 4)])
def test_neighbor_list_matches_jax(periodic, cutoff, k_max):
    '''Aperiodic, periodic (tilted box), and one where the cutoff holds
    more neighbours than k_max = 4 (overflow). k_max is cut to N - 1.'''
    pos, cell, mask = _system(periodic, seed=int(cutoff) + k_max)
    (idx_j, m_j, d_j, over_j), (idx_t, m_t, d_t, over_t) = _both(
        pos, cell, mask, cutoff, k_max)
    assert idx_t.shape == idx_j.shape == (2, 11, min(k_max, 10))
    np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_array_equal(np.where(m_t, idx_t, -1),
                                  np.where(m_j, idx_j, -1))
    assert not idx_t[~m_t].any()  # idx is zero where the mask is false
    np.testing.assert_allclose(np.where(m_t[..., None], d_t, 0),
                               np.where(m_j[..., None], d_j, 0), atol=1e-12)
    np.testing.assert_array_equal(over_t, over_j)
    if k_max == 4:
        assert over_t.sum() > 0 and m_t.all(-1).any()
    else:
        assert not over_t.any()


def test_recompute_displacements_and_its_gradient_match_jax():
    '''pos_i - pos_j for a given list, and its derivative in pos and cell
    (the stress path), against jax.vjp of the JAX package's.'''
    pos, cell, mask = _system(True, seed=5)
    (idx, _, _, _), _ = _both(pos, cell, mask, 3.0, 8)
    rs = np.random.RandomState(6)
    cot = rs.randn(*idx.shape, 3)
    out_j, vjp = jax.vjp(lambda p, c: jax_nlist.recompute_displacements(
        p, c, jnp.asarray(idx)), jnp.asarray(pos), jnp.asarray(cell))
    dpos_j, dcell_j = vjp(jnp.asarray(cot))
    p = torch.from_numpy(pos).requires_grad_(True)
    c = torch.from_numpy(cell).requires_grad_(True)
    out_t = nlist.recompute_displacements(p, c, torch.tensor(idx))
    dpos_t, dcell_t = torch.autograd.grad(out_t, (p, c),
                                          torch.from_numpy(cot))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=1e-12)
    np.testing.assert_allclose(dpos_t.numpy(), np.asarray(dpos_j),
                               atol=1e-12)
    np.testing.assert_allclose(dcell_t.numpy(), np.asarray(dcell_j),
                               atol=1e-12)


def test_gather_nodes_and_its_scatter_add_match_jax():
    '''gather_nodes and its backward (a scatter-add onto the atoms, with
    repeated indices) against the JAX package's and jax.vjp of it.'''
    rs = np.random.RandomState(7)
    x = rs.randn(2, 9, 3, 4)
    idx = rs.randint(0, 9, size=(2, 9, 5))
    cot = rs.randn(2, 9, 5, 3, 4)
    out_j, vjp = jax.vjp(lambda a: jax_nlist.gather_nodes(
        a, jnp.asarray(idx, jnp.int32)), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out_t = nlist.gather_nodes(xt, torch.from_numpy(idx))
    (dx_t,) = torch.autograd.grad(out_t, xt, torch.from_numpy(cot))
    assert out_t.shape == (2, 9, 5, 3, 4)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=1e-12)
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(vjp(
        jnp.asarray(cot))[0]), atol=1e-12)
