'''A small NewtonNet through the JAX package (kernel='pallas', Pallas in
interpret mode on the CPU) and through the port (newtonnet_tpu_torch, plain
versions on the CPU) with the same weights, in float32.

Tolerances: energies at rtol 1e-5 (float32 sums of O(1) atomic energies
in another order); forces, virial and stress at atol 1e-4 x max|JAX value|
(each is a sum over pairs and layers of float32 products).
'''
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
from newtonnet_tpu_torch import NewtonNet
from newtonnet_tpu_torch.utils.params import params_from_flax, params_to_flax

PROPS = ['energy', 'gradient_force', 'virial', 'stress']


def _batch():
    '''Two graphs padded to 8 slots: an aperiodic molecule of 6 atoms and
    7 atoms in a triclinic periodic cell.'''
    rs = np.random.RandomState(0)
    z = np.zeros((2, 8), np.int32)
    z[0, :6] = [6, 6, 8, 1, 1, 1]
    z[1, :7] = [14, 8, 8, 1, 6, 7, 1]
    pos = np.zeros((2, 8, 3), np.float32)
    pos[0, :6] = rs.rand(6, 3) * 3.0
    cell = np.zeros((2, 3, 3), np.float32)
    cell[1] = [[4.5, 0.0, 0.0], [1.1, 4.2, 0.0], [0.6, -0.8, 4.4]]
    pos[1, :7] = rs.rand(7, 3) @ cell[1]
    return z, pos, cell


@pytest.fixture(scope='module')
def models():
    z, pos, cell = _batch()
    jm = JaxNewtonNet(kernel='pallas', n_features=16, n_basis=8,
                      n_interactions=2, output_properties=PROPS)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(z), jnp.asarray(pos),
                     jnp.asarray(cell))
    params = jax.tree.map(np.asarray, params)
    tm = NewtonNet(**jm.config_dict(), device='cpu')
    params_from_flax(params, core=tm.core)
    tm.requires_grad_(False)
    return jm, params, tm


def test_params_round_trip(models):
    _, params, _ = models
    back = params_to_flax(params_from_flax(params))
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
    for (key, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and np.array_equal(a, b), key


def test_outputs_match_jax(models):
    jm, params, tm = models
    z, pos, cell = _batch()
    out_j = jm.apply(params, jnp.asarray(z), jnp.asarray(pos),
                     jnp.asarray(cell))
    out_t = tm(torch.from_numpy(z), torch.from_numpy(pos),
               torch.from_numpy(cell))
    np.testing.assert_allclose(out_t['energy'].numpy(),
                               np.asarray(out_j['energy']), rtol=1e-5)
    for key in ('gradient_force', 'virial'):
        ref = np.asarray(out_j[key])
        np.testing.assert_allclose(out_t[key].numpy(), ref,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=key)
    # stress divides by |det(cell)|: only the periodic graph is finite
    ref = np.asarray(out_j['stress'])[1]
    np.testing.assert_allclose(out_t['stress'].numpy()[1], ref,
                               atol=1e-4 * np.abs(ref).max())
    assert np.abs(np.asarray(out_j['gradient_force'])[1]).max() > 0
