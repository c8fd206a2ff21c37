'''A kernel='pallas' model with pallas_dot_dtype 'bfloat16' in the port
(models/output.py over the plain bf16 K1/K2 or K5/K6 on the CPU) against
the JAX package's (Pallas in interpret mode), dense and over neighbour
lists with fp32 and bf16 edges, at F=32, R=8, 2 interactions, in a
periodic box; the same weights (the JAX package's init, loaded into the
port) and the same inputs (numpy, from a seed).

Bar: 4 times the JAX package's own bf16-to-fp32 spread on the same inputs
(the largest absolute difference between its bf16 and its fp32 model),
for energy, forces and stress: the port's bf16 products round the
operands the Pallas kernels round, so it differs from the JAX bf16 model
by the fp32 summation order and a rare flip of a rounding, far inside
that spread; a port that rounded other operands, or none, would move by
about a spread. Then the serving surface: a bf16 checkpoint written by
save_model through load_model and NewtonNetCalculator, an unknown
pallas_dot_dtype refused, and the Trainer and the training CLI training a
bf16 model (tests/test_torch_bf16_training.py holds its steps against the
JAX package's).
'''
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
from newtonnet_tpu_torch import NewtonNet, NewtonNetCalculator, load_model
from newtonnet_tpu_torch.ops import fused_dense as fd
from newtonnet_tpu_torch.ops import fused_klist as fk
from newtonnet_tpu_torch.utils.checkpoint import save_model
from newtonnet_tpu_torch.utils.params import params_from_flax

OUTPUTS = ['energy', 'gradient_force', 'stress']
SPREAD_FACTOR = 4.0
# (graph_mode, compute_dtype of the edges)
LAYOUTS = {'dense': ('dense', ''), 'klist': ('neighborlist', ''),
           'klist_bf16_edges': ('neighborlist', 'bfloat16')}


def config(layout, dot_dtype):
    graph_mode, compute_dtype = LAYOUTS[layout]
    cfg = dict(cutoff=5.0, n_features=32, n_basis=8, n_interactions=2,
               graph_mode=graph_mode, kernel='pallas',
               output_properties=OUTPUTS, pallas_dot_dtype=dot_dtype)
    if graph_mode == 'neighborlist':
        cfg.update(k_max=16, compute_dtype=compute_dtype)
    return cfg


def frames(seed, B=2, N=12, L=7.0):
    rs = np.random.RandomState(seed)
    z = np.zeros((B, N), np.int32)
    for b in range(B):
        n = rs.randint(8, N + 1)
        z[b, :n] = rs.choice([1, 6, 7, 8], size=n)
    pos = (rs.rand(B, N, 3) * L).astype(np.float32)
    cell = np.broadcast_to(np.eye(3, dtype=np.float32) * L, (B, 3, 3)).copy()
    return z, pos, cell


def jax_outputs(layout, dot_dtype, params, z, pos, cell):
    jm = JaxNewtonNet(**config(layout, dot_dtype))
    out = jm.apply(params, jnp.asarray(z), jnp.asarray(pos),
                   jnp.asarray(cell))
    return {k: np.asarray(out[k], np.float64) for k in OUTPUTS}


def jax_params(layout, seed, z, pos, cell):
    jm = JaxNewtonNet(**config(layout, 'float32'))
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(z),
                     jnp.asarray(pos), jnp.asarray(cell))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def port_model(layout, params):
    tm = NewtonNet(**config(layout, 'bfloat16'), device='cpu')
    params_from_flax(params, core=tm.core)
    return tm


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_bf16_model_matches_jax_within_its_spread(layout):
    '''Energy, forces and stress of the port's bf16 model against the JAX
    package's bf16 model, at 4 times the JAX package's bf16-to-fp32
    spread; the port's wrappers run the plain versions here and launch no
    kernel.'''
    z, pos, cell = frames(seed=21)
    params = jax_params(layout, 21, z, pos, cell)
    bf = jax_outputs(layout, 'bfloat16', params, z, pos, cell)
    fp = jax_outputs(layout, 'float32', params, z, pos, cell)
    fd.reset_launch_counts()
    fk.reset_launch_counts()
    out = port_model(layout, params)(torch.from_numpy(z),
                                     torch.from_numpy(pos),
                                     torch.from_numpy(cell))
    assert not any(fd.LAUNCHES.values()) and not any(fk.LAUNCHES.values())
    for key in OUTPUTS:
        spread = np.abs(bf[key] - fp[key]).max()
        err = np.abs(out[key].numpy() - bf[key]).max()
        assert spread > 0, key
        assert err <= SPREAD_FACTOR * spread, (key, err, spread)


def test_bf16_checkpoint_serves_through_load_model_and_the_calculator(
        tmp_path):
    '''A bf16 checkpoint written by save_model keeps its pallas_dot_dtype
    through load_model, and NewtonNetCalculator serves it: the model's
    numbers, not the fp32 model's.'''
    z, pos, cell = frames(seed=3, B=1)
    params = jax_params('klist', 3, z, pos, cell)
    tm = port_model('klist', params)
    path = str(tmp_path / 'bf16.msgpack')
    save_model(path, tm)
    again = load_model(path, device='cpu')
    assert (again.kernel, again.pallas_dot_dtype) == ('pallas', 'bfloat16')
    n = int((z[0] > 0).sum())
    calc = NewtonNetCalculator(path, properties=['energy', 'forces',
                                                 'stress'], device='cpu')
    assert calc.model.pallas_dot_dtype == 'bfloat16'
    r = calc.calculate(numbers=z[0, :n], positions=pos[0, :n], cell=cell[0])
    ref = tm(torch.from_numpy(z[:, :n].copy()),
             torch.from_numpy(pos[:, :n].copy()), torch.from_numpy(cell))
    assert r['energy'] == pytest.approx(float(ref['energy'][0]), abs=1e-5)
    np.testing.assert_allclose(r['forces'],
                               ref['gradient_force'][0].numpy(), atol=1e-5)
    fp32 = NewtonNet(**config('klist', 'float32'), device='cpu')
    params_from_flax(params, core=fp32.core)
    e32 = float(fp32(torch.from_numpy(z[:, :n].copy()),
                     torch.from_numpy(pos[:, :n].copy()),
                     torch.from_numpy(cell))['energy'][0])
    assert r['energy'] != e32


def test_unknown_pallas_dot_dtype_is_refused():
    with pytest.raises(ValueError, match='pallas_dot_dtype'):
        NewtonNet(**config('dense', 'float16'), device='cpu')


@pytest.mark.parametrize('layout', ['dense', 'klist'])
def test_a_bf16_model_trains(layout, tmp_path):
    '''The Trainer and the training CLI train a kernel='pallas' bf16 model
    (they refused it before K7/K8 had a bf16 mode): the Trainer resolves
    fast_grad to the first-order step (fast_grad=False stays refused,
    naming its ROADMAP.md item), and the CLI runs one epoch of
    scripts/config_md17_pallas.yml cut to tiny sizes whose best model
    keeps the dot dtype.'''
    import csv

    import yaml

    from newtonnet_tpu_torch.train import cli
    from newtonnet_tpu_torch.train.loss import get_loss_by_string
    from newtonnet_tpu_torch.train.trainer import Trainer
    model = NewtonNet(**config(layout, 'bfloat16'), device='cpu')
    losses = get_loss_by_string({'energy': {}, 'gradient_force': {}})
    assert Trainer(model, loss_fns=losses).fast_grad
    with pytest.raises(NotImplementedError, match='ROADMAP.md A'):
        Trainer(model, fast_grad=False)  # an energy loss
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, 'scripts', 'config_md17_pallas.yml')) as f:
        cfg = yaml.safe_load(f)
    data = os.path.join(root, 'data', 'md17_aspirin', 'ccsd_train')
    cfg['general'].update(device='cpu', output=str(tmp_path / 'runs'))
    cfg['data'].update(train_root=data, test_root=None, train_size=8,
                       val_size=4, test_size=4, train_batch_size=4,
                       val_batch_size=4, test_batch_size=4)
    cfg['model'].update(pallas_dot_dtype='bfloat16', n_features=8,
                        n_basis=4, n_interactions=2,
                        graph_mode=LAYOUTS[layout][0])
    if layout == 'klist':
        cfg['model']['k_max'] = 12
    cfg['model'].pop('pretrained_model', None)
    cfg['training']['epochs'] = 1
    path = tmp_path / 'bf16.yml'
    path.write_text(yaml.safe_dump(cfg))
    cli.main(['--config', str(path)])
    run = tmp_path / 'runs' / 'training_1'
    with open(run / 'log.csv') as f:
        row = next(csv.DictReader(f))
    assert np.isfinite(float(row['train_loss']))
    best = load_model(str(run / 'models' / 'best_model.msgpack'),
                      device='cpu')
    assert best.pallas_dot_dtype == 'bfloat16'
