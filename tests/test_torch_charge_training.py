'''Training charge-head models in the port against the JAX package on the
CPU (ROADMAP.md A5): the Trainer's and the CLI's resolution of ewald_mode
'auto', three standard steps through the latent Ewald energy against the
JAX Trainer's (metrics at rtol 2e-5, parameters at atol 2e-6 after every
step, tests/test_torch_xla_training.py's bars), and fastgrad (reverse
over forward, energies with E_lr) against the standard step in float64 at
rtol 1e-9, with a control (the energies without E_lr, as fastgrad took
them before the charge head was ported) that misses it by far. Models
and frames are tests/test_torch_charge_model.py's.
'''
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from newtonnet_tpu.data.loader import PaddedLoader as JaxPaddedLoader
from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
from newtonnet_tpu.train import optimizer as jopt
from newtonnet_tpu.train.loss import get_loss_by_string as jax_loss
from newtonnet_tpu.train.trainer import Trainer as JaxTrainer
from newtonnet_tpu_torch import NewtonNet, Trainer
from newtonnet_tpu_torch.data.loader import PaddedLoader, Sample
from newtonnet_tpu_torch.train import cli, fastgrad
from newtonnet_tpu_torch.train import optimizer as topt
from newtonnet_tpu_torch.train.loss import get_loss_by_string
from newtonnet_tpu_torch.train.trainer import standard_value_and_grad
from newtonnet_tpu_torch.utils.params import params_from_flax
from test_torch_charge_model import EF, ROOT, frames, models, port_nlist


def _samples(n=12, seed=0, box=6.0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        k = rs.randint(3, 9)
        out.append(Sample(
            z=rs.choice([1, 6, 8], size=k).astype(np.int32),
            pos=(rs.rand(k, 3) * box).astype(np.float32),
            cell=(np.eye(3) * box).astype(np.float32),
            energy=np.float32(rs.randn()),
            force=rs.randn(k, 3).astype(np.float32)))
    return out


def test_trainer_steps_match_jax_and_resolve_the_mode(capsys):
    '''Three standard steps of an 'auto' charge-head model (energy + 50 x
    force loss through E_lr, periodic frames, SGD with momentum and the
    clip) against the JAX Trainer's: both print the same resolution from
    the first batch; metrics at rtol 2e-5 and parameters at atol 2e-6
    after every step (tests/test_torch_xla_training.py's bars). A one-shot
    iterator is not peeked: both warn.'''
    cfg = dict(cutoff=5.0, n_features=16, n_basis=8, n_interactions=1,
               output_properties=['energy', 'gradient_force', 'charge'],
               ewald_n_k=2)
    jm = JaxNewtonNet(**cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32),
                     jnp.asarray(np.random.RandomState(0).randn(1, 4, 3),
                                 jnp.float32), jnp.zeros((1, 3, 3)))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    data = _samples()

    def opt(core=None):
        kw = dict(clip_grad=1.0, lr=1e-2, momentum=0.9)
        return topt.get_optimizer_by_string('sgd', core, **kw) if core \
            is not None else jopt.get_optimizer_by_string('sgd', **kw)
    capsys.readouterr()
    jt = JaxTrainer(jm, params, loss_fns=jax_loss(EF), optimizer=opt(),
                    train_generator=JaxPaddedLoader(data, 4, shuffle=True,
                                                    n_pad=8),
                    steps_per_call=1)
    jax_said = capsys.readouterr().out
    tm = NewtonNet(**cfg, device='cpu')
    params_from_flax(params, core=tm.core)
    tt = Trainer(tm, loss_fns=get_loss_by_string(EF), optimizer=opt(tm.core),
                 train_generator=PaddedLoader(data, 4, shuffle=True, n_pad=8))
    said = capsys.readouterr().out
    line = 'ewald_mode: auto -> periodic (from the first training batch)'
    assert line in jax_said and line in said
    assert tt.model.ewald_mode == jt.model.ewald_mode == 'periodic'
    assert tt.model.core is tm.core and not tt.fast_grad
    names = ['loss'] + jt._eval_metric_names() + ['edges']
    for k, (bj, bt) in enumerate(zip(jt.train_generator,
                                     tt.train_generator)):
        totals = {n: jnp.zeros((), jnp.float32) for n in names}
        jt.params, jt.opt_state, totals = jt._train_step(
            jt.params, jt.opt_state, totals, bj)
        metrics = tt.train_step(bt)
        for n in names:
            np.testing.assert_allclose(float(metrics[n]), float(totals[n]),
                                       rtol=2e-5, err_msg=f'{n} step {k}')
        want = {'.'.join(p.key for p in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(
                    jax.device_get(jt.params)['params'])[0]}
        got = {n: p.detach().numpy() for n, p in tm.core.named_parameters()}
        assert set(got) == set(want)
        for n in want:
            np.testing.assert_allclose(got[n], want[n], atol=2e-6,
                                       err_msg=f'{n} step {k}')
    assert k == 2
    batches = iter([next(iter(PaddedLoader(data, 4, n_pad=8)))])
    with pytest.warns(UserWarning, match='with_ewald_mode'):
        one_shot = Trainer(NewtonNet(**cfg, device='cpu'),
                           train_generator=batches)
    assert one_shot.model.ewald_mode == 'auto'


def test_cli_resolves_from_dataset_periodicity(tmp_path, capsys):
    '''The training CLI on aspirin frames with a charge head in a fresh
    model: ewald_mode auto -> aperiodic from the statistics' periodicity,
    printed as the JAX CLI prints it, then one epoch with finite losses.'''
    src = os.path.join(ROOT, 'data', 'md17_aspirin', 'ccsd_train', 'raw')
    shutil.copytree(src, tmp_path / 'data' / 'raw')
    with open(os.path.join(ROOT, 'scripts', 'config.yml')) as f:
        cfg = yaml.safe_load(f)
    cfg['general'].update(device='cpu', output=str(tmp_path / 'runs'))
    cfg['data'].update(train_root=str(tmp_path / 'data'), test_root=None,
                       train_size=4, val_size=2, test_size=2,
                       train_batch_size=2, val_batch_size=2,
                       test_batch_size=2)
    cfg['model'].update(n_features=8, n_basis=4, n_interactions=1,
                        output_properties=['energy', 'gradient_force',
                                           'charge'])
    cfg['training'].update(epochs=1)
    trainer = cli.train_from_settings(cfg)
    assert 'ewald_mode: auto -> aperiodic (from dataset periodicity)' in \
        capsys.readouterr().out
    assert trainer.model.ewald_mode == 'aperiodic'
    assert trainer.model.config_dict()['ewald_mode'] == 'aperiodic'
    assert all(np.isfinite(float(v)) for k, v in trainer.log_rows[0].items()
               if k.endswith('_loss'))


@pytest.mark.parametrize('layout', ['dense', 'newton3'])
def test_fastgrad_equals_the_standard_step(layout):
    '''fast_grad=True (reverse over forward, energies with E_lr) against
    the standard step on a charge-head model in float64, rtol 1e-9; the
    energies without E_lr (the sum of the atomic energies, fastgrad's
    before the charge head) miss that bar.'''
    tm, _, _ = models(layout, outputs=['energy', 'gradient_force', 'charge',
                                       'bec'], seed=5)
    z, pos, cell = frames(7, layout)
    nl = port_nlist(tm, layout, z, pos, cell)
    rs = np.random.RandomState(1)
    batch = {'z': torch.from_numpy(z), 'pos': torch.from_numpy(pos),
             'cell': torch.from_numpy(cell),
             'energy': torch.from_numpy(rs.randn(2)),
             'force': torch.from_numpy(rs.randn(*pos.shape)),
             'graph_mask': torch.ones(2, dtype=torch.bool)}
    main_loss, _ = get_loss_by_string(EF)
    tm.requires_grad_(True)

    def grads():
        return torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad)
                          .flatten() for p in tm.core.parameters()])
    fastgrad.value_and_grad(tm, main_loss, batch, nlist=nl)
    fast = grads()
    standard_value_and_grad(tm, main_loss, batch, nlist=nl)
    std = grads()
    bar = 1e-9 * float(std.abs().max())
    assert float((fast - std).abs().max()) <= bar

    def short_range(model, b, pos, pair_op=None, nlist=None, plain=False):
        out = model._energy_and_aux(b['z'], pos, None, b['cell'],
                                    nlist=nlist)[1]
        return out['atomic_energy'][..., 0].sum(-1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fastgrad, '_energies', short_range)
        fastgrad.value_and_grad(tm, main_loss, batch, nlist=nl)
    assert float((grads() - std).abs().max()) > 1e3 * bar
