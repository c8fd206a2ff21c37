'''The direct-force head and calculator ensembles in the port (ROADMAP.md
A8) against the JAX package on the CPU.

The direct-force head is an MLP (F -> F -> F -> F) of atom_node whose
output weighs force_node's features, scaled per element (a scale and no
shift). It is served, written and read across packages, and trained by
the standard step with energy, force and direct-force losses. A list of
checkpoints is an ensemble: the calculator averages its members' outputs.
Models are small (F=16, R=8, 1-2 interactions, 8 atoms); the card's
checks are chip_smoke.py's phase 14 (14c, 14d), whose JAX numbers
card_direct_force, card_ensemble and jax_direct_force_steps give
(tests/test_torch_hessian.py card).
'''
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newtonnet_tpu.data.loader import PaddedLoader as JaxPaddedLoader
from newtonnet_tpu.md.calculator import NewtonNetCalculator as JaxCalc
from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
from newtonnet_tpu.train import optimizer as jopt
from newtonnet_tpu.train.loss import get_loss_by_string as jax_loss
from newtonnet_tpu.train.trainer import Trainer as JaxTrainer
from newtonnet_tpu.utils import checkpoint as jckpt
from newtonnet_tpu_torch import NewtonNet, NewtonNetCalculator, Trainer
from newtonnet_tpu_torch.data.loader import PaddedLoader, Sample
from newtonnet_tpu_torch.train import optimizer as topt
from newtonnet_tpu_torch.train.loss import get_loss_by_string
from newtonnet_tpu_torch.utils.checkpoint import load_model, save_model
from newtonnet_tpu_torch.utils.params import params_to_flax
from test_torch_hessian import frames, jax_out, models, request

DIRECT = ('energy', 'gradient_force', 'direct_force')
LOSS = {'energy': {'weight': 1.0, 'mode': 'mse'},
        'gradient_force': {'weight': 50.0, 'mode': 'mse'},
        'direct_force': {'weight': 50.0, 'mode': 'mse'}}


def direct_models(layout, outputs=DIRECT, **kw):
    '''models() with the direct-force head, its scaler's scale drawn from
    U(0.5, 1.5) so that the scaling shows.'''
    tm, jm, _ = models(layout, outputs=outputs, **kw)
    with torch.no_grad():
        tm.core.scaler_direct_force.scale.uniform_(
            0.5, 1.5, generator=torch.Generator().manual_seed(4))
    return tm, jm, params_to_flax(tm.core)


@pytest.mark.parametrize('layout', ['dense', 'newton3'])
def test_direct_force_head_matches_jax(layout):
    '''Energy, forces and direct forces (B, N, 3) against the JAX
    package's apply in fp64 at 1e-10, dense and over newton3 half lists;
    the padding atom's direct force is zero, the scaler has no shift, and
    the flax tree of the port's head is the JAX core's.'''
    tm, jm, params = direct_models(layout)
    z, pos, cell = frames(N=8)
    t, nl = request(tm, layout, z, pos, cell)
    got = tm(*t, nlist=nl)
    want = jax_out(jm, params, z, pos, cell, nl)
    for key in DIRECT:
        assert np.abs(got[key].numpy() - want[key]).max() <= 1e-10, key
    assert got['direct_force'].shape == (2, 8, 3)
    assert not got['direct_force'][1, -1].any()
    assert np.abs(want['direct_force']).max() > 1e-3
    head = params['params']['direct_force_head']
    assert sorted(head) == ['TorchLinear_0', 'TorchLinear_1',
                            'TorchLinear_2']
    assert all(head[k]['kernel'].shape == (16, 16) for k in head)
    assert sorted(params['params']['scaler_direct_force']) == ['scale']


def test_heads_checkpoints_load_across_packages(tmp_path):
    '''A model with direct_force and hessian in its outputs and a
    hessian_block: written by the port and read by the JAX package, and
    the other way, with the same config (hessian_block kept) and the same
    weights, names one to one.'''
    tm, _, _ = direct_models('dense', outputs=DIRECT + ('hessian',),
                             dtype=torch.float32, hessian_block=5)
    path = str(tmp_path / 'port.msgpack')
    save_model(path, tm)
    jm2, jparams = jckpt.load_model(path)
    assert jm2.config_dict() == dict(tm.config_dict())
    assert jm2.hessian_block == 5
    flat = {'.'.join(p.key for p in k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(
                jparams['params'])[0]}
    own = {k: v.detach().numpy() for k, v in tm.core.named_parameters()}
    assert set(flat) == set(own)
    assert all(np.array_equal(flat[k], own[k]) for k in own)
    jpath = str(tmp_path / 'jax.msgpack')
    jckpt.save_model(jpath, jm2, jparams)
    back = load_model(jpath, device='cpu')
    assert back.config_dict() == tm.config_dict()
    assert back.output_properties == ['energy', 'gradient_force',
                                      'direct_force', 'hessian']
    assert all(torch.equal(a, b) for a, b in zip(
        back.core.parameters(), tm.core.parameters()))


def _samples(n=8, seed=0, box=6.0):
    rs = np.random.RandomState(seed)
    return [Sample(z=rs.choice([1, 6, 8], size=k).astype(np.int32),
                   pos=(rs.rand(k, 3) * box).astype(np.float32),
                   cell=(np.eye(3) * box).astype(np.float32),
                   energy=np.float32(rs.randn()),
                   force=rs.randn(k, 3).astype(np.float32))
            for k in rs.randint(3, 9, size=n)]


def test_direct_force_standard_steps_match_jax():
    '''Two standard steps with energy + gradient_force + direct_force
    losses ('auto' takes the standard step for a kernel='xla' model in
    both Trainers), Adam with the clip: metrics at rtol 2e-5 and every
    parameter at atol 2e-6 after each step against the JAX Trainer's
    (tests/test_torch_xla_training.py's bars). fast_grad=True refuses the
    direct-force loss with the JAX Trainer's ValueError.'''
    cfg = dict(cutoff=5.0, n_features=16, n_basis=8, n_interactions=1,
               output_properties=list(DIRECT))
    jm = JaxNewtonNet(**cfg)
    tm = NewtonNet(**cfg, device='cpu',
                   generator=torch.Generator().manual_seed(5))
    params = params_to_flax(tm.core)
    data = _samples()

    def opt(core=None):
        kw = dict(clip_grad=1.0, lr=1e-3)
        return topt.get_optimizer_by_string('adam', core, **kw) if core \
            is not None else jopt.get_optimizer_by_string('adam', **kw)
    jt = JaxTrainer(jm, params, loss_fns=jax_loss(LOSS), optimizer=opt(),
                    train_generator=JaxPaddedLoader(data, 4, n_pad=8),
                    steps_per_call=1)
    tt = Trainer(tm, loss_fns=get_loss_by_string(LOSS), optimizer=opt(
        tm.core), train_generator=PaddedLoader(data, 4, n_pad=8))
    assert not jt.fast_grad and not tt.fast_grad
    names = ['loss'] + jt._eval_metric_names() + ['edges']
    assert 'direct_force_cos_mae' in names
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
        for n, p in tm.core.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n],
                                       atol=2e-6, err_msg=f'{n} step {k}')
    assert k == 1
    with pytest.raises(ValueError) as jerr:
        JaxTrainer(jm, params, loss_fns=jax_loss(LOSS), fast_grad=True)
    with pytest.raises(ValueError) as terr:
        Trainer(NewtonNet(**cfg, device='cpu'),
                loss_fns=get_loss_by_string(LOSS), fast_grad=True)
    assert str(terr.value) == str(jerr.value)


def test_ensemble_matches_the_jax_ensemble_calculator(tmp_path):
    '''Two seeded models written as checkpoints, the first newton3_compact
    (served through newton3, as both calculators swap it), as one
    calculator (a list model_path) against the JAX calculator of the same
    list: energy, forces and stress of a periodic request in float64 at
    1e-10; each output the mean of the members' in member order.'''
    paths = []
    for seed, kw in ((0, dict(newton3_compact=True)),
                     (1, dict(newton3=True))):
        tm = NewtonNet(cutoff=3.5, n_features=16, n_basis=8,
                       n_interactions=2, graph_mode='neighborlist', k_max=6,
                       output_properties=['energy', 'gradient_force'],
                       device='cpu',
                       generator=torch.Generator().manual_seed(seed), **kw)
        paths.append(str(tmp_path / f'm{seed}.msgpack'))
        save_model(paths[-1], tm)
    z, pos, cell = frames(N=8)
    req = dict(numbers=z[0], positions=pos[0], cell=cell[0])
    props = ['energy', 'forces', 'stress']
    calc = NewtonNetCalculator(paths, properties=props, precision='float64',
                               device='cpu')
    assert [m.newton3 and not m.newton3_compact for m in calc.members] == \
        [True, True]
    got = calc.calculate(**req)
    want = JaxCalc(paths, properties=props,
                   precision='float64').calculate(**req)
    ones = [NewtonNetCalculator(p, properties=props, precision='float64',
                                device='cpu').calculate(**req)
            for p in paths]
    for key in props:
        assert np.abs(np.asarray(got[key]) - np.asarray(want[key])).max() \
            <= 1e-10, key
        assert np.array_equal(np.asarray(got[key]), (np.asarray(
            ones[0][key]) + np.asarray(ones[1][key])) / 2), key
    assert abs(ones[0]['energy'] - ones[1]['energy']) > 1e-3


# ---------------------------------------------------------------- #
# the card recipe's parts (tests/test_torch_hessian.py card)


def card_direct_force(cs):
    '''JAX_DIRECT_FORCES: the direct forces of the aspirin checkpoint with
    cs.direct_force_tree's head on the first cs.DIRECT_FRAMES test frames,
    float32.'''
    from newtonnet_tpu_torch.data.loader import collate, parse_xyz
    jm, params = _jax_direct_model(cs)
    batch = collate(parse_xyz(cs.XYZ)[:cs.DIRECT_FRAMES], n_pad=21)
    with jax.default_matmul_precision('highest'):
        out = jax.jit(jm.apply)(params, jnp.asarray(batch['z']),
                                jnp.asarray(batch['pos']),
                                jnp.asarray(batch['cell']))
    return {'JAX_DIRECT_FORCES': np.asarray(out['direct_force'])}


def _jax_direct_model(cs):
    jm, params = jckpt.load_model(cs.XLA_CKPT)
    jm = JaxNewtonNet(**dict(jm.config_dict(), output_properties=list(
        jm.output_properties) + ['direct_force']))
    tree = dict(params['params'])
    tree.update(cs.direct_force_tree(jm.n_features))
    return jm, {'params': tree}


def card_ensemble(cs):
    '''JAX_ENSEMBLE_ENERGY / _FORCES: the JAX calculator over
    cs.ENSEMBLE_CKPTS on the first cs.ENSEMBLE_MAE_FRAMES test frames,
    one request each, float32.'''
    from newtonnet_tpu_torch.data.loader import parse_xyz
    calc = JaxCalc(cs.ENSEMBLE_CKPTS)
    energy, forces = [], []
    for s in parse_xyz(cs.XYZ)[:cs.ENSEMBLE_MAE_FRAMES]:
        r = calc.calculate(numbers=s['z'], positions=s['pos'])
        energy.append(r['energy'])
        forces.append(r['forces'])
    return {'JAX_ENSEMBLE_ENERGY': np.asarray(energy, np.float64),
            'JAX_ENSEMBLE_FORCES': np.stack(forces).astype(np.float32)}


def jax_direct_force_steps(cs, n_steps=10):
    '''The JAX package's first standard fine-tuning steps of phase 14c:
    the aspirin checkpoint with cs.direct_force_tree's head, the XLA
    config's data, scaler refit, Adam (1e-3, clip 1.0) and cs.DIRECT_LOSS,
    each step jax.value_and_grad of the loss over model.apply, as
    tests/test_torch_xla_reference.py's jax_xla_steps takes them. ->
    (losses, global gradient norms before the clip).'''
    import optax

    from newtonnet_tpu.data import parse_train_test
    from newtonnet_tpu.data.statistics import set_scalers
    data = os.path.join(cs.ROOT, 'data', 'md17_aspirin')
    train_gen, _, _, stats = parse_train_test(
        train_root=os.path.join(data, 'ccsd_train'),
        test_root=os.path.join(data, 'ccsd_test'), train_size=950,
        train_batch_size=10, val_batch_size=50, test_batch_size=500, seed=0)
    jm, params = _jax_direct_model(cs)
    params = set_scalers(params, jm.output_properties, stats,
                         {'energy': {'fit_scale': True, 'fit_shift': True}})
    main_loss, _ = jax_loss(cs.DIRECT_LOSS)
    tx = jopt.get_optimizer_by_string('adam', clip_grad=1.0, lr=1e-3)
    opt = tx.init(params)

    @jax.jit
    def step(p, o, b):
        def loss_fn(q):
            return main_loss(jm.apply(q, b['z'], b['pos'], b['cell']), b)
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss, \
            optax.global_norm(grads)

    losses, norms = [], []
    with jax.default_matmul_precision('highest'):
        for _, batch in zip(range(n_steps), train_gen):
            params, opt, loss, norm = step(
                params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
            losses.append(float(loss))
            norms.append(float(norm))
    return losses, norms


def test_pinned_direct_forces_reproduce_on_the_cpu():
    '''chip_smoke.py 14c's model on the CPU (float32): the first
    DIRECT_FRAMES frames' direct forces against the JAX package's in
    tests/reference/jax_hessian_heads.npz, at 14c's bar.'''
    from newtonnet_tpu_torch.data.loader import collate, parse_xyz
    from test_torch_hessian import chip_smoke
    cs = chip_smoke()
    model = cs.with_direct_force_head(
        torch, load_model(cs.XLA_CKPT, device='cpu'), device='cpu')
    batch = collate(parse_xyz(cs.XYZ)[:cs.DIRECT_FRAMES], n_pad=21)
    out = model(*(torch.from_numpy(batch[k]) for k in ('z', 'pos', 'cell')))
    want = np.load(cs.HESSIAN_REF)['JAX_DIRECT_FORCES']
    assert np.abs(out['direct_force'].numpy() - want).max() <= cs.CHARGE_BAR
