'''The port's training runtime against the JAX package's: the data pipeline
(splits, batch order, statistics), checkpoint files read by both packages,
three Trainer steps from the same parameters, resume, and the CLI.

Tolerances: splits, batches and statistics are compared exactly (the same
numpy draws on the same float32 data). Trainer steps (F=32, R=8, 2
interactions, batches of 4 graphs of at most 8 atoms, fp32 duals):
metrics at rtol 2e-5 and parameters at atol 2e-6 after each step. The
gradients agree to about 1e-6 (tests/test_torch_fastgrad.py), so the
steps use SGD with momentum and the global-norm clip, whose update is
linear in the gradient. Adam's is not: its first step moves a parameter
by lr * g / (|g| + 1e-8), which turns a 1e-10 difference of a gradient
near 1e-8 into one of 1e-5; Adam itself is held to optax, step by step,
in tests/test_torch_train_parts.py.
'''
import csv
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from newtonnet_tpu.data import parse_train_test as jax_parse_train_test
from newtonnet_tpu.data.loader import PaddedLoader as JaxPaddedLoader
from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
from newtonnet_tpu.train import optimizer as jopt
from newtonnet_tpu.train.loss import get_loss_by_string as jax_loss
from newtonnet_tpu.train.trainer import Trainer as JaxTrainer
from newtonnet_tpu.utils import checkpoint as jckpt
from newtonnet_tpu_torch import NewtonNet, Trainer, load_model, save_model
from newtonnet_tpu_torch.data.loader import PaddedLoader, Sample
from newtonnet_tpu_torch.data.pipeline import parse_train_test
from newtonnet_tpu_torch.train import cli
from newtonnet_tpu_torch.train import optimizer as topt
from newtonnet_tpu_torch.train.loss import get_loss_by_string
from newtonnet_tpu_torch.utils.params import params_from_flax, params_to_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASPIRIN = os.path.join(ROOT, 'data', 'md17_aspirin')
LOSSES = {'energy': {'weight': 1.0, 'mode': 'mse'},
          'gradient_force': {'weight': 50.0, 'mode': 'mse'}}
CFG = dict(cutoff=5.0, n_features=32, n_basis=8, n_interactions=2,
           output_properties=['energy', 'gradient_force'], kernel='pallas',
           pallas_grad_dot_dtype='float32')
# the JAX Trainer's log.csv columns for an energy + gradient_force loss
EPOCH_COLUMNS = (
    ['epoch', 'lr', 'step']
    + [f'train_{k}' for k in ('loss', 'energy_mae', 'energy_mse',
                              'energy_per_atom_mae', 'energy_per_atom_mse',
                              'gradient_force_mae', 'gradient_force_mse')]
    + ['epoch_seconds', 'steps_per_s', 'edges_per_s']
    + [f'{s}_{k}' for s in ('val', 'test')
       for k in ('loss', 'energy_mae', 'energy_mse', 'energy_per_atom_mae',
                 'energy_per_atom_mse', 'gradient_force_mae',
                 'gradient_force_mse')]
    + ['best_model'])


@pytest.fixture(scope='module')
def aspirin_copy(tmp_path_factory):
    '''The vendored aspirin raw files in a scratch root, so that the JAX
    package's processed/ cache is written there.'''
    out = tmp_path_factory.mktemp('aspirin')
    for split in ('ccsd_train', 'ccsd_test'):
        shutil.copytree(os.path.join(ASPIRIN, split, 'raw'),
                        out / split / 'raw')
    return out


def test_parse_train_test_matches_jax(aspirin_copy):
    kw = dict(train_root=str(aspirin_copy / 'ccsd_train'),
              test_root=str(aspirin_copy / 'ccsd_test'), train_size=950,
              train_batch_size=10, val_batch_size=50, test_batch_size=500,
              seed=0)
    jax_out = jax_parse_train_test(**kw)
    ours = parse_train_test(**kw)
    for gj, gt in zip(jax_out[:3], ours[:3]):
        np.testing.assert_array_equal(gt.dataset.indices, gj.dataset.indices)
        assert (gt.n_pad, len(gt)) == (gj.n_pad, len(gj)) == (24, len(gj))
    for gj, gt, n in ((jax_out[0], ours[0], 3), (jax_out[1], ours[1], 1)):
        for _ in range(2):  # two epochs of shuffles
            for k, (bj, bt) in enumerate(zip(gj, gt)):
                if k == n:
                    break
                assert bj.keys() == bt.keys()
                for key in bj:
                    np.testing.assert_array_equal(bt[key], bj[key], key)
    sj, st = jax_out[3], ours[3]
    for key in ('energy', 'force'):
        for part in sj[key]:
            np.testing.assert_array_equal(st[key][part], sj[key][part])
    assert st['periodicity'] == sj['periodicity'] == 'aperiodic'
    # bucketed: the JAX package's bucketed batches (aspirin: one bucket)
    jax_out = jax_parse_train_test(**kw, bucketed=True)
    ours = parse_train_test(**kw, bucketed=True)
    for gj, gt in zip(jax_out[:3], ours[:3]):
        assert gt.buckets == gj.buckets == [24]
        for _ in range(2):
            for k, (bj, bt) in enumerate(zip(gj, gt)):
                if k == 3:
                    break
                assert bj.keys() == bt.keys()
                for key in bj:
                    np.testing.assert_array_equal(bt[key], bj[key], key)


def _jax_params(seed=0):
    jm = JaxNewtonNet(**CFG)
    z = jnp.ones((1, 4), jnp.int32)
    params = jm.init(jax.random.PRNGKey(seed), z,
                     jnp.asarray(np.random.RandomState(seed).randn(1, 4, 3),
                                 jnp.float32), jnp.zeros((1, 3, 3)))
    return jm, jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def _flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree['params'])[0]
    return {'.'.join(k.key for k in path): np.asarray(v)
            for path, v in leaves}


def test_model_files_cross_load(tmp_path):
    jm, params = _jax_params(seed=1)
    tm = NewtonNet(**CFG, device='cpu')
    params_from_flax(params, core=tm.core)
    save_model(tmp_path / 'port.msgpack', tm)
    jm2, p2 = jckpt.load_model(str(tmp_path / 'port.msgpack'))
    assert jm2.config_dict() == jm.config_dict()
    for name, v in _flat(params).items():
        np.testing.assert_array_equal(_flat({'params': p2['params']})[name],
                                      v, name)
    jckpt.save_model(str(tmp_path / 'jax.msgpack'), jm, params)
    back = load_model(tmp_path / 'jax.msgpack', device='cpu')
    assert back.config_dict() == tm.config_dict()
    for name, v in _flat(params_to_flax(back.core)).items():
        np.testing.assert_array_equal(v, _flat(params)[name], name)


def _samples(n=12, seed=0, n_max=8):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        k = rs.randint(3, n_max + 1)
        out.append(Sample(
            z=rs.choice([1, 6, 7, 8], size=k).astype(np.int32),
            pos=(rs.randn(k, 3) * 1.6).astype(np.float32),
            cell=np.zeros((3, 3), np.float32),
            energy=np.float32(rs.randn()),
            force=rs.randn(k, 3).astype(np.float32)))
    return out


def test_trainer_steps_match_jax():
    '''Three training steps of both Trainers from the same parameters on
    the same batches, parameter by parameter after each step.'''
    jm, params = _jax_params()
    data = _samples()
    jt = JaxTrainer(jm, params, loss_fns=jax_loss(LOSSES),
                    optimizer=jopt.get_optimizer_by_string(
                        'sgd', clip_grad=1.0, lr=1e-2, momentum=0.9),
                    train_generator=JaxPaddedLoader(data, 4, shuffle=True,
                                                    n_pad=8),
                    steps_per_call=1)
    tm = NewtonNet(**CFG, device='cpu')
    params_from_flax(params, core=tm.core)
    tt = Trainer(tm, loss_fns=get_loss_by_string(LOSSES),
                 optimizer=topt.get_optimizer_by_string(
                     'sgd', tm.core, clip_grad=1.0, lr=1e-2, momentum=0.9),
                 train_generator=PaddedLoader(data, 4, shuffle=True,
                                              n_pad=8))
    names = ['loss'] + jt._eval_metric_names() + ['edges']
    for k, (bj, bt) in enumerate(zip(jt.train_generator,
                                     tt.train_generator)):
        for key in bj:
            np.testing.assert_array_equal(bt[key], bj[key])
        totals = {n: jnp.zeros((), jnp.float32) for n in names}
        jt.params, jt.opt_state, totals = jt._train_step(
            jt.params, jt.opt_state, totals, bj)
        metrics = tt.train_step(bt)
        assert list(metrics) == names
        for n in names:
            np.testing.assert_allclose(float(metrics[n]), float(totals[n]),
                                       rtol=2e-5, err_msg=f'{n} step {k}')
        want = _flat(jax.device_get(jt.params))
        for name, p in tm.core.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name],
                                       atol=2e-6, err_msg=f'{name} {k}')
    assert k == 2


def _trainer(out, epochs, seed=0):
    _, params = _jax_params(seed=2)
    tm = NewtonNet(**CFG, device='cpu')
    params_from_flax(params, core=tm.core)
    data = _samples(n=8, seed=seed)
    sched = topt.get_scheduler_by_string([('plateau', {'patience': 0})],
                                         1e-3)
    return Trainer(tm, loss_fns=get_loss_by_string(LOSSES),
                   optimizer=topt.get_optimizer_by_string(
                       'adam', tm.core, clip_grad=1.0, lr=1e-3),
                   lr_scheduler=sched, output_base_path=str(out),
                   train_generator=PaddedLoader(data[:4], 2, shuffle=True,
                                                n_pad=8),
                   val_generator=PaddedLoader(data[4:6], 2, n_pad=8),
                   test_generator=PaddedLoader(data[6:], 2, n_pad=8),
                   epochs=epochs)


def test_resume_continues_a_run(tmp_path):
    '''Two epochs in one go give the same parameters, optimizer state, lr
    and shuffles as one epoch, then a resumed second one.'''
    whole = _trainer(tmp_path / 'a', epochs=2)
    whole.train()
    first = _trainer(tmp_path / 'b', epochs=1)
    first.train()
    second = _trainer(tmp_path / 'c', epochs=2)
    second.resume(first.output_path)
    assert second.start_epoch == 1 and second.start_step == 2
    second.train()
    for (n, p), q in zip(whole.model.core.named_parameters(),
                         second.model.core.parameters()):
        assert torch.equal(p, q), n
    assert second.optimizer.lr == whole.optimizer.lr
    with open(os.path.join(second.output_path, 'log.csv')) as f:
        rows = list(csv.DictReader(f))
    assert [r['epoch'] for r in rows] == ['0', 'last', 'best', '1', 'last',
                                          'best']
    with open(os.path.join(whole.output_path, 'log.csv')) as f:
        whole_rows = list(csv.DictReader(f))
    assert rows[3]['train_loss'] == whole_rows[1]['train_loss']


def test_cli_trains_and_resumes_on_cpu(tmp_path):
    '''python -m newtonnet_tpu_torch.train.cli with a tiny config on the
    CPU: log.csv has the JAX package's columns with finite values, the
    models reload, and --resume of a finished run re-evaluates.'''
    with open(os.path.join(ROOT, 'scripts', 'config_md17_pallas.yml')) as f:
        cfg = yaml.safe_load(f)
    cfg['general'].update(device='cpu', output=str(tmp_path / 'runs'))
    cfg['data'].update(train_root=os.path.join(ASPIRIN, 'ccsd_train'),
                       test_root=None, train_size=8, val_size=4,
                       test_size=4, train_batch_size=4, val_batch_size=4,
                       test_batch_size=4)
    cfg['model'].update(n_features=32, n_basis=8, n_interactions=1)
    cfg['training'].update(epochs=1, checkpoint={'check_val': 1,
                                                 'check_test': 1,
                                                 'check_log': 1})
    path = tmp_path / 'tiny.yml'
    path.write_text(yaml.safe_dump(cfg))
    trainer = cli.main(['--config', str(path)])
    out = trainer.output_path
    with open(os.path.join(out, 'log.csv')) as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == EPOCH_COLUMNS
    assert [r['epoch'] for r in rows] == ['0', 'last', 'best']
    for key in EPOCH_COLUMNS[1:-1]:
        assert np.isfinite(float(rows[0][key])), key
    best = load_model(os.path.join(out, 'models', 'best_model.msgpack'),
                      device='cpu')
    assert best.n_features == 32
    assert os.path.exists(os.path.join(out, 'run_scripts', 'tiny.yml'))
    again = cli.main(['--resume', out])
    assert again.start_epoch == 1
    # training.parallel builds the mesh (ROADMAP.md A11a): in one process
    # a data axis of 2 needs ranks the world does not have, and the mesh
    # asserts it as the JAX make_mesh does, before any data is read
    cfg['training']['parallel'] = {'data': 2}
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(AssertionError, match='mesh 2x1 needs more than 1'):
        cli.main(['--config', str(path)])


def test_chip_smoke_checks_the_jax_log_columns():
    '''chip_smoke.py holds the card's log.csv to the JAX Trainer's columns
    and trains with the repo's MD17 config.'''
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.LOG_COLUMNS == EPOCH_COLUMNS
    cfg = smoke.md17_settings('out', epochs=1)
    assert cfg['training']['epochs'] == 1
    assert cfg['model']['pretrained_model']['path'] == smoke.CKPT
    for key in ('train_root', 'test_root'):
        assert os.path.isdir(os.path.join(cfg['data'][key], 'raw')), key
