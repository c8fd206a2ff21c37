'''The port's neighbour-list model (models/output.py over
models/fused_klist.py and the plain K5/K6) against the JAX package's
NewtonNet(kernel='pallas', graph_mode='neighborlist') with Pallas in
interpret mode on the CPU, at F=32, R=8, 2 interactions; the same weights
(the JAX package's init, loaded into the port) and the same inputs (numpy,
from a seed).

Tolerances: atol 2e-4 for energy, forces, virial and stress, the bar of
tests/test_pallas_klist.py:test_klist_model_precomputed_nlist_and_stress
(float32 sums over slots, features and layers in another order). With
bf16 edges both packages round the same edge tensors to bf16, but a
last-bit float32 difference before a rounding moves a value by one bf16
ulp (2^-8 relative); the bf16 case is held at 2e-3 relative to each
output's largest magnitude.
'''
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newtonnet_tpu.data.prelists import frame_neighbor_lists
from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
from newtonnet_tpu_torch import NewtonNet, NewtonNetCalculator, load_model
from newtonnet_tpu_torch.ops import fused_klist as fk
from newtonnet_tpu_torch.utils.checkpoint import save_model
from newtonnet_tpu_torch.utils.params import params_from_flax

OUTPUTS = ['energy', 'gradient_force', 'virial', 'stress']


def _models(periodic, seed, compute_dtype='', B=2, N=12, K=16):
    cfg = dict(cutoff=5.0, n_features=32, n_basis=8, n_interactions=2,
               graph_mode='neighborlist', k_max=K, kernel='pallas',
               output_properties=OUTPUTS, compute_dtype=compute_dtype)
    jm = JaxNewtonNet(**cfg)
    rs = np.random.RandomState(seed)
    z = np.zeros((B, N), np.int32)
    for b in range(B):
        n = rs.randint(6, N + 1)
        z[b, :n] = rs.choice([1, 6, 7, 8], size=n)
    if periodic:
        L = 7.0
        pos = (rs.rand(B, N, 3) * L).astype(np.float32)
        cell = np.broadcast_to(np.eye(3, dtype=np.float32) * L,
                               (B, 3, 3)).copy()
    else:
        pos = (rs.randn(B, N, 3) * 1.8).astype(np.float32)
        cell = np.zeros((B, 3, 3), np.float32)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(z),
                     jnp.asarray(pos), jnp.asarray(cell))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    tm = NewtonNet(**cfg, device='cpu')
    params_from_flax(params, core=tm.core)
    return jm, params, tm, z, pos, cell


def _host_lists(z, pos, cell, K=16):
    lists = [frame_neighbor_lists(z[b], pos[b], cell[b], 5.0, K)
             for b in range(z.shape[0])]
    return np.stack([i for i, _ in lists]), np.stack([m for _, m in lists])


def _port(tm, z, pos, cell, nlist=None):
    nl = None if nlist is None else tuple(torch.from_numpy(a) for a in nlist)
    return tm(torch.from_numpy(z), torch.from_numpy(pos),
              torch.from_numpy(cell), nlist=nl)


@pytest.mark.parametrize('periodic, precomputed', [
    (False, False), (True, False), (True, True)])
def test_model_matches_jax(periodic, precomputed):
    '''Energy, forces, virial and stress (the strain derivative through
    recompute_displacements) with the list built in the model or given to
    both packages. Aperiodic stress divides by a zero volume in both
    packages (ROADMAP.md C): only its finite entries are compared.'''
    jm, params, tm, z, pos, cell = _models(periodic, seed=5)
    nlist = _host_lists(z, pos, cell) if precomputed else None
    out_j = jm.apply(params, jnp.asarray(z), jnp.asarray(pos),
                     jnp.asarray(cell),
                     nlist=None if nlist is None
                     else tuple(jnp.asarray(a) for a in nlist))
    out_t = _port(tm, z, pos, cell, nlist)
    for key in OUTPUTS:
        a, b = out_t[key].numpy(), np.asarray(out_j[key])
        ok = np.isfinite(b)
        assert (np.isfinite(a) == ok).all(), key
        np.testing.assert_allclose(a[ok], b[ok], atol=2e-4, err_msg=key)
    np.testing.assert_allclose(out_t['atom_node'].numpy(),
                               np.asarray(out_j['atom_node']), atol=2e-4)


def test_bf16_edges_match_jax():
    '''compute_dtype='bfloat16': the gathered edge tensors and rbf travel
    in bf16 in both packages.'''
    jm, params, tm, z, pos, cell = _models(True, seed=11,
                                           compute_dtype='bfloat16')
    out_j = jm.apply(params, jnp.asarray(z), jnp.asarray(pos),
                     jnp.asarray(cell))
    out_t = _port(tm, z, pos, cell)
    for key in ('energy', 'gradient_force', 'virial'):
        a, b = out_t[key].numpy(), np.asarray(out_j[key])
        assert np.abs(a - b).max() <= 2e-3 * np.abs(b).max(), key


def test_klist_model_equals_dense_model_when_all_neighbours_fit():
    '''With k_max >= N - 1 every in-cutoff pair is in the list, so the
    K-list model computes the dense model's function: the port's two paths
    agree to float32 rounding (float64 here: 1e-10).'''
    _, params, tm, z, pos, cell = _models(False, seed=3, K=48)
    dense = NewtonNet(**dict(tm.config_dict(), graph_mode='dense',
                             compute_dtype=''), device='cpu')
    params_from_flax(params, core=dense.core)
    tm, dense = tm.double(), dense.double()
    args = [torch.from_numpy(z), torch.from_numpy(pos).double(),
            torch.from_numpy(cell).double()]
    a, b = tm(*args), dense(*args)
    for key in ('energy', 'gradient_force', 'virial', 'atom_node'):
        torch.testing.assert_close(a[key], b[key], rtol=1e-10, atol=1e-10,
                                   msg=key)


def test_plain_op_path_equals_the_wrapper_path_and_counts_nothing():
    '''pair_op=fused_klist_interaction(plain=True) gives the default path's
    numbers on the CPU, and no kernel launch is counted there.'''
    import functools
    _, _, tm, z, pos, cell = _models(True, seed=2)
    fk.reset_launch_counts()
    a = _port(tm, z, pos, cell)
    b = tm(*[torch.from_numpy(x) for x in (z, pos, cell)],
           pair_op=functools.partial(fk.fused_klist_interaction, plain=True))
    for key in OUTPUTS:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    assert not any(fk.LAUNCHES.values())


def test_neighbour_list_checkpoint_loads_and_serves(tmp_path):
    '''A neighbour-list config round-trips through save_model/load_model
    and the calculator serves it (periodic request: energy, forces,
    stress) with the model's numbers.'''
    _, _, tm, z, pos, cell = _models(True, seed=4)
    path = os.path.join(tmp_path, 'nlist.msgpack')
    save_model(path, tm)
    again = load_model(path, device='cpu')
    assert again.graph_mode == 'neighborlist' and again.k_max == 16
    calc = NewtonNetCalculator(path, properties=['energy', 'forces',
                                                 'stress'], device='cpu')
    n = int((z[0] > 0).sum())
    r = calc.calculate(numbers=z[0, :n], positions=pos[0, :n], cell=cell[0])
    ref = _port(tm, z[:1, :n].copy(), pos[:1, :n].copy(), cell[:1])
    assert r['energy'] == pytest.approx(float(ref['energy'][0]), abs=1e-4)
    np.testing.assert_allclose(r['forces'], ref['gradient_force'][0].numpy(),
                               atol=1e-4)
    assert np.isfinite(r['stress']).all() and r['stress'].shape == (6,)


def test_unported_neighbour_list_options_are_refused():
    '''A neighbour-list model with bf16 products in the fused layers serves
    and trains (the Trainer refused it before K7/K8 had a bf16 mode: it
    now takes a first-order step, K7/K8's plain bf16 versions on the CPU);
    an unknown compute_dtype is an error.'''
    from newtonnet_tpu_torch.train.trainer import Trainer
    model = NewtonNet(graph_mode='neighborlist', kernel='pallas',
                      pallas_dot_dtype='bfloat16', n_features=8, n_basis=4,
                      n_interactions=1, k_max=4,
                      output_properties=['energy', 'gradient_force'],
                      device='cpu')
    trainer = Trainer(model)
    assert trainer.fast_grad
    fk.reset_launch_counts()
    seen = []
    ref = fk.klist_dual_bwd_ref

    def spy(*a, **kw):
        seen.append(kw.get('dot_dtype'))
        return ref(*a, **kw)
    rs = np.random.RandomState(0)
    batch = {'z': torch.tensor([[6, 1, 8, 1, 0]]),
             'pos': torch.tensor(rs.randn(1, 5, 3) * 1.2,
                                 dtype=torch.float32),
             'cell': torch.zeros(1, 3, 3),
             'energy': torch.tensor([1.0]),
             'graph_mask': torch.ones(1, dtype=torch.bool)}
    with mock.patch.object(fk, 'klist_dual_bwd_ref', spy):
        loss, _ = trainer.loss_and_grad(batch)
    assert torch.isfinite(loss) and seen == ['bfloat16']
    with pytest.raises(ValueError, match='compute_dtype'):
        NewtonNet(graph_mode='neighborlist', compute_dtype='float16',
                  device='cpu')


def test_cli_trains_a_neighbour_list_model_on_cpu(tmp_path):
    '''The training CLI with model: {graph_mode: neighborlist, k_max,
    compute_dtype} on the CPU: one epoch, finite log.csv values, a best
    model that reloads in neighbour-list mode; then the same model over
    data.precompute_nlist (mode plain), whose batches carry the lists.'''
    import csv

    import yaml

    from newtonnet_tpu_torch.train import cli
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, 'scripts', 'config_md17_pallas.yml')) as f:
        cfg = yaml.safe_load(f)
    cfg['general'].update(device='cpu', output=str(tmp_path / 'runs'))
    cfg['data'].update(
        train_root=os.path.join(root, 'data', 'md17_aspirin', 'ccsd_train'),
        test_root=None, train_size=8, val_size=4, test_size=4,
        train_batch_size=4, val_batch_size=4, test_batch_size=4)
    cfg['model'].update(n_features=32, n_basis=8, n_interactions=2,
                        graph_mode='neighborlist', k_max=12,
                        compute_dtype='bfloat16')
    cfg['training'].update(epochs=1, checkpoint={'check_val': 1,
                                                 'check_test': 1,
                                                 'check_log': 1})
    path = tmp_path / 'tiny_nlist.yml'
    path.write_text(yaml.safe_dump(cfg))
    trainer = cli.main(['--config', str(path)])
    with open(os.path.join(trainer.output_path, 'log.csv')) as f:
        rows = list(csv.DictReader(f))
    assert [r['epoch'] for r in rows] == ['0', 'last', 'best']
    for key, value in rows[0].items():
        if key not in ('epoch', 'best_model'):
            assert np.isfinite(float(value)), key
    best = load_model(os.path.join(trainer.model_path, 'best_model.msgpack'),
                      device='cpu')
    assert (best.graph_mode, best.k_max, best.compute_dtype) == \
        ('neighborlist', 12, 'bfloat16')
    # precomputed lists (data/prelists.py): the same model trains over
    # the batches' lists, built once on the host at the model's k_max
    cfg['model']['k_max'] = 20
    cfg['data']['precompute_nlist'] = {'cutoff': cfg['model']['cutoff'],
                                       'k_max': 20, 'mode': 'plain'}
    path.write_text(yaml.safe_dump(cfg))
    trainer = cli.main(['--config', str(path)])
    batch = next(iter(trainer.train_generator))
    assert batch['nlist_idx'].shape[-1] == 20
    with open(os.path.join(trainer.output_path, 'log.csv')) as f:
        rows = list(csv.DictReader(f))
    assert np.isfinite(float(rows[0]['train_loss']))
