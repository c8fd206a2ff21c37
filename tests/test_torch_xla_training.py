'''The port's Trainer on kernel='xla' models against the JAX Trainer: three
training steps of both from the same parameters on the same batches,
compared metric by metric and parameter by parameter after each step.

Cases (F=32, R=8, 2 interactions, batches of 4 graphs of at most 8 atoms):
the dense model with fast_grad 'auto' (the standard reverse-over-reverse
step, as both Trainers resolve it) and with fast_grad=True (reverse over
forward, train/fastgrad.py); plain neighbour lists; an energy + force +
stress loss on periodic frames whose stress labels come from a numpy
seed; and compute_dtype bfloat16 over neighbour lists. Also fast_grad's
resolution and ValueErrors against the JAX Trainer's, and the training
CLI on the repo's own XLA config, scripts/config.yml, cut to tiny sizes.

Tolerances are those of tests/test_torch_training.py's
test_trainer_steps_match_jax: metrics at rtol 2e-5, parameters at
atol 2e-6, with SGD, momentum and the global-norm clip, whose update is
linear in the gradient. A bf16 stack is held to twice the JAX package's
bf16-to-fp32 spread on top of those bars, metric by metric and parameter
by parameter, its JAX program compiled without excess precision (the
program that rounds where the port's bf16 stack rounds).
'''
import csv
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from newtonnet_tpu.data.loader import PaddedLoader as JaxPaddedLoader
from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
from newtonnet_tpu.train import optimizer as jopt
from newtonnet_tpu.train.loss import get_loss_by_string as jax_loss
from newtonnet_tpu.train.trainer import Trainer as JaxTrainer
from newtonnet_tpu_torch import NewtonNet, Trainer, load_model
from newtonnet_tpu_torch.data.loader import PaddedLoader, Sample
from newtonnet_tpu_torch.train import cli
from newtonnet_tpu_torch.train import optimizer as topt
from newtonnet_tpu_torch.train.loss import get_loss_by_string
from newtonnet_tpu_torch.utils.params import params_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EF = {'energy': {'weight': 1.0, 'mode': 'mse'},
      'gradient_force': {'weight': 50.0, 'mode': 'mse'}}
EFS = dict(EF, stress={'weight': 100.0, 'mode': 'mse'})
CFG = dict(cutoff=5.0, n_features=32, n_basis=8, n_interactions=2,
           output_properties=['energy', 'gradient_force'])
STEPS = 3


def _samples(n=12, seed=0, n_max=8, box=0.0):
    '''Random molecules; with box > 0, periodic frames in a cubic cell of
    that side with stress labels.'''
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        k = rs.randint(3, n_max + 1)
        s = Sample(
            z=rs.choice([1, 6, 7, 8], size=k).astype(np.int32),
            pos=((rs.rand(k, 3) * box) if box else rs.randn(k, 3) * 1.6)
            .astype(np.float32),
            cell=(np.eye(3) * box).astype(np.float32),
            energy=np.float32(rs.randn()),
            force=rs.randn(k, 3).astype(np.float32))
        if box:
            s['stress'] = (rs.randn(3, 3) * 1e-2).astype(np.float32)
        out.append(s)
    return out


def _run(cfg, losses, fast_grad, data):
    '''Both Trainers from one set of parameters over the same batches:
    -> per step, ((port metrics, port parameters), (JAX metrics, JAX
    parameters)), each a dict of numpy values.'''
    jm = JaxNewtonNet(**cfg)
    z = jnp.ones((1, 4), jnp.int32)
    params = jm.init(jax.random.PRNGKey(0), z, jnp.asarray(
        np.random.RandomState(0).randn(1, 4, 3), jnp.float32),
        jnp.zeros((1, 3, 3)))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    jt = JaxTrainer(jm, params, loss_fns=jax_loss(losses),
                    optimizer=jopt.get_optimizer_by_string(
                        'sgd', clip_grad=1.0, lr=1e-2, momentum=0.9),
                    train_generator=JaxPaddedLoader(data, 4, shuffle=True,
                                                    n_pad=8),
                    steps_per_call=1, fast_grad=fast_grad)
    tm = NewtonNet(**cfg, device='cpu')
    params_from_flax(params, core=tm.core)
    tt = Trainer(tm, loss_fns=get_loss_by_string(losses),
                 optimizer=topt.get_optimizer_by_string(
                     'sgd', tm.core, clip_grad=1.0, lr=1e-2, momentum=0.9),
                 train_generator=PaddedLoader(data, 4, shuffle=True,
                                              n_pad=8),
                 fast_grad=fast_grad)
    assert tt.fast_grad == jt.fast_grad == (fast_grad is True)
    names = ['loss'] + jt._eval_metric_names() + ['edges']
    steps = []
    for bj, bt in zip(jt.train_generator, tt.train_generator):
        for key in bj:
            np.testing.assert_array_equal(bt[key], bj[key])
        totals = {n: jnp.zeros((), jnp.float32) for n in names}
        jt.params, jt.opt_state, totals = jt._train_step(
            jt.params, jt.opt_state, totals, bj)
        metrics = tt.train_step(bt)
        assert list(metrics) == names
        leaves = jax.tree_util.tree_flatten_with_path(
            jax.device_get(jt.params)['params'])[0]
        want = {'.'.join(k.key for k in path): np.asarray(v)
                for path, v in leaves}
        steps.append((
            ({n: float(v) for n, v in metrics.items()},
             {n: p.detach().numpy().copy()
              for n, p in tm.core.named_parameters()}),
            ({n: float(totals[n]) for n in names}, want)))
    assert len(steps) == STEPS
    return steps


@pytest.mark.parametrize('case', ['dense', 'dense_fast_grad', 'nlist',
                                  'stress'])
def test_xla_trainer_steps_match_jax(case):
    cfg, losses, fast_grad, data = dict(CFG), EF, 'auto', _samples()
    if case == 'dense_fast_grad':
        fast_grad = True
    elif case == 'nlist':
        cfg.update(graph_mode='neighborlist', k_max=12)
    elif case == 'stress':
        cfg['output_properties'] = ['energy', 'gradient_force', 'stress']
        losses, data = EFS, _samples(box=6.0)
    for k, ((m_t, p_t), (m_j, p_j)) in enumerate(_run(cfg, losses,
                                                      fast_grad, data)):
        for n in m_j:
            np.testing.assert_allclose(m_t[n], m_j[n], rtol=2e-5,
                                       err_msg=f'{n} step {k}')
        assert set(p_t) == set(p_j)
        for n in p_j:
            np.testing.assert_allclose(p_t[n], p_j[n], atol=2e-6,
                                       err_msg=f'{n} step {k}')


@pytest.mark.parametrize('kernel, fast_grad, keys, want', [
    ('xla', 'auto', ('energy', 'gradient_force'), False),
    ('xla', True, ('energy', 'gradient_force'), True),
    ('xla', 'auto', ('energy', 'gradient_force', 'stress'), False),
    ('pallas', 'auto', ('energy', 'gradient_force'), True),
    ('pallas', 'auto', ('energy',), True),
    ('xla', True, ('energy', 'gradient_force', 'stress'),
     'fast_grad requires losses within'),
    ('pallas', False, ('energy', 'gradient_force'),
     'kernel=pallas force training needs fast_grad'),
    ('pallas', 'auto', ('energy', 'gradient_force', 'stress'),
     'kernel=pallas force training needs fast_grad')])
def test_fast_grad_resolves_as_the_jax_trainer(kernel, fast_grad, keys,
                                               want):
    """Both Trainers on one configuration: the same resolved fast_grad,
    or the same ValueError (the JAX Trainer's text)."""
    losses = {k: EFS[k] for k in keys}
    cfg = dict(CFG, n_features=16, n_interactions=1, kernel=kernel)
    jm = JaxNewtonNet(**cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32),
                     jnp.asarray(np.random.RandomState(0).randn(1, 4, 3),
                                 jnp.float32), jnp.zeros((1, 3, 3)))
    builders = (
        lambda: JaxTrainer(jm, params, loss_fns=jax_loss(losses),
                           fast_grad=fast_grad),
        lambda: Trainer(NewtonNet(**cfg, device='cpu'),
                        loss_fns=get_loss_by_string(losses),
                        fast_grad=fast_grad))
    for build in builders:
        if isinstance(want, str):
            with pytest.raises(ValueError, match=want):
                build()
        else:
            assert build().fast_grad is want


def test_xla_trainer_bf16_stack_matches_jax(monkeypatch):
    '''compute_dtype bfloat16 over neighbour lists: after each step,
    every metric and parameter of the port within twice the JAX package's
    bf16-to-fp32 spread (from an fp32 run of the same steps), plus the fp32
    bar, of the JAX value. The JAX Trainer's programs are compiled without
    excess precision (jax.jit with compiler_options
    xla_allow_excess_precision False, patched in for this test), so they
    round every value its source types as bf16, as the port's bf16 stack
    does (models/xla_stack.py). The spread is the reference's alone: the
    port's own would raise its bar.'''
    jit = jax.jit
    monkeypatch.setattr(jax, 'jit', lambda fn, **kw: jit(
        fn, compiler_options={'xla_allow_excess_precision': False}, **kw))
    data = _samples(seed=1)
    runs = {cd: _run(dict(CFG, graph_mode='neighborlist', k_max=12,
                          compute_dtype=cd), EF, 'auto', data)
            for cd in ('', 'bfloat16')}
    for k, (step16, step32) in enumerate(zip(runs['bfloat16'], runs[''])):
        (m_t, p_t), (m_j, p_j) = step16
        m_j32, p_j32 = step32[1]
        for n in m_j:
            spread = abs(m_j[n] - m_j32[n])
            assert abs(m_t[n] - m_j[n]) <= 2 * spread + 2e-5 * abs(m_j[n]), \
                f'{n} step {k}: {m_t[n]} vs {m_j[n]} (spread {spread})'
        for n in p_j:
            spread = np.abs(p_j[n] - p_j32[n]).max()
            assert np.abs(p_t[n] - p_j[n]).max() <= 2 * spread + 2e-6, \
                f'{n} step {k}'


def test_cli_trains_the_repos_xla_config_on_cpu(tmp_path):
    """python -m newtonnet_tpu_torch.train.cli --config scripts/config.yml
    (no `kernel:` key: an XLA model, the standard step) with the data of
    this checkout, general.device cpu, tiny widths and sizes: log.csv has
    the JAX Trainer's columns (chip_smoke.LOG_COLUMNS) with finite values
    and the best model reloads as an XLA model."""
    with open(os.path.join(ROOT, 'scripts', 'config.yml')) as f:
        cfg = yaml.safe_load(f)
    assert 'kernel' not in cfg['model']
    data = os.path.join(ROOT, 'data', 'md17_aspirin')
    cfg['general'].update(device='cpu', output=str(tmp_path / 'runs'))
    cfg['data'].update(train_root=os.path.join(data, 'ccsd_train'),
                       test_root=os.path.join(data, 'ccsd_test'),
                       train_size=8, val_size=4, test_size=4,
                       train_batch_size=4, val_batch_size=4,
                       test_batch_size=4)
    cfg['model'].update(n_features=16, n_basis=6, n_interactions=1)
    cfg['training'].update(epochs=1)
    path = tmp_path / 'config.yml'
    path.write_text(yaml.safe_dump(cfg))
    trainer = cli.main(['--config', str(path)])
    assert trainer.model.kernel == 'xla' and not trainer.fast_grad
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with open(os.path.join(trainer.output_path, 'log.csv')) as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == list(smoke.LOG_COLUMNS)
    assert [r['epoch'] for r in rows] == ['0', 'last', 'best']
    for key in smoke.LOG_COLUMNS[1:-1]:
        assert np.isfinite(float(rows[0][key])), key
    best = load_model(os.path.join(trainer.model_path, 'best_model.msgpack'),
                      device='cpu')
    assert best.kernel == 'xla' and best.n_features == 16
