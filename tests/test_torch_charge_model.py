'''Charge-head models in the port (ROADMAP.md A5 and A7) against the JAX
package on the CPU: latent charges, the latent Ewald energy in the total,
and Born effective charges, served and trained.

Models are small (F=16, R=8, 1-2 interactions, N <= 14, boxes of 14
atoms) with one seeded set of weights loaded into both packages. Bars:
float64 at 1e-10 of each output's largest magnitude; the port in float32
against the JAX package's float64 numbers at atol 2e-4 (the kernel='xla'
model bar, tests/test_torch_xla_model.py), for energy (E_lr included),
forces, stress, charges and BEC, over the dense graph (a mixed batch of a
periodic and an aperiodic graph under ewald_mode 'auto') and over plain,
inverse and newton3 lists (the plain row gather on the CPU). Aperiodic
stress divides by a zero volume in both packages (ROADMAP.md C1): only
finite entries are compared. Training is tests/test_torch_charge_training.py's.

    python tests/test_torch_charge_model.py card

prints the JAX numbers chip_smoke.py's phase 13 holds the card to, and
writes the arrays to chip_smoke.CHARGE_REF (about 2 minutes on the CPU).
'''
import functools
import importlib.util
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == '__main__':  # the card recipe, run as a script
    sys.path.insert(0, ROOT)

from newtonnet_tpu.md.calculator import NewtonNetCalculator as JaxCalc
from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
from newtonnet_tpu.train.trainer import Trainer as JaxTrainer
from newtonnet_tpu.utils import checkpoint as jckpt
from newtonnet_tpu_torch import NewtonNet, NewtonNetCalculator
from newtonnet_tpu_torch.md.driver import host_symmetric_nlist
from newtonnet_tpu_torch.utils.checkpoint import load_model, save_model
from newtonnet_tpu_torch.utils.params import params_to_flax

OUTS = ['energy', 'gradient_force', 'stress', 'charge', 'bec']
EF = {'energy': {'weight': 1.0, 'mode': 'mse'},
      'gradient_force': {'weight': 50.0, 'mode': 'mse'}}
LAYOUTS = {
    'dense': dict(graph_mode='dense'),
    'plain': dict(graph_mode='neighborlist', k_max=14),
    'inverse': dict(graph_mode='neighborlist', k_max=24, inverse_lists=True),
    'newton3': dict(graph_mode='neighborlist', k_max=12, newton3=True),
}


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def frames(seed, layout, B=2, N=14, L=9.0):
    '''Seeded frames, the second graph padded by 3 atoms: periodic cubic
    boxes, or for 'dense' one box and one molecule (a mixed batch).'''
    rs = np.random.RandomState(seed)
    z = rs.choice([1, 6, 8], size=(B, N)).astype(np.int64)
    z[1:, -3:] = 0
    pos = rs.rand(B, N, 3) * L
    cell = np.broadcast_to(np.eye(3) * L, (B, 3, 3)).copy()
    if layout == 'dense' and B > 1:
        pos[1] = rs.randn(N, 3) * 1.5
        cell[1] = 0.0
    return z, pos, cell


def models(layout, outputs=OUTS, seed=0, n_interactions=1, **kw):
    '''(port model in float64, its JAX twin, the flax tree of its
    weights).'''
    cfg = dict(cutoff=5.0, n_features=16, n_basis=8,
               n_interactions=n_interactions, output_properties=outputs,
               ewald_n_k=3, ewald_sigma=1.2, **LAYOUTS[layout], **kw)
    tm = NewtonNet(**cfg, device='cpu', dtype=torch.float64,
                   generator=torch.Generator().manual_seed(seed))
    return tm, JaxNewtonNet(**cfg), params_to_flax(tm.core)


def port_nlist(tm, layout, z, pos, cell):
    if layout in ('inverse', 'newton3'):
        return host_symmetric_nlist(tm, z, pos, cell, skin=0.0)
    return None


def jax_apply(jm, params, z, pos, cell, nlist=None, dtype=np.float64):
    jnl = None if nlist is None else tuple(jnp.asarray(t.numpy())
                                           for t in nlist)
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    out = jax.jit(lambda p, a, b, c, n: jm.apply(p, a, b, c, nlist=n))(
        params, jnp.asarray(z, jnp.int32), jnp.asarray(pos, dtype),
        jnp.asarray(cell, dtype), jnl)
    return {k: np.asarray(v) for k, v in out.items()}


def compare(got, want, keys, rel=None, atol=None):
    for key in keys:
        a = got[key].detach().double().numpy()
        b = want[key].astype(np.float64)
        ok = np.isfinite(b)
        assert (np.isfinite(a) == ok).all(), key
        bar = atol if atol is not None else rel * np.abs(b[ok]).max()
        assert np.abs(a[ok] - b[ok]).max() <= bar, (
            key, np.abs(a[ok] - b[ok]).max(), bar)


@pytest.mark.parametrize('layout', list(LAYOUTS))
def test_model_matches_jax(layout):
    '''Energy with E_lr, forces, stress, charges and BEC: the port in
    float64 at 1e-10 and in float32 at atol 2e-4 against the JAX
    package in float64, on the same lists.'''
    tm, jm, params = models(layout, n_interactions=2 if layout == 'newton3'
                            else 1)
    assert tm.ewald_dispatches_at_runtime and jm.ewald_dispatches_at_runtime
    z, pos, cell = frames(3, layout)
    nl = port_nlist(tm, layout, z, pos, cell)
    want = jax_apply(jm, params, z, pos, cell, nl)
    args = [torch.from_numpy(a) for a in (z, pos, cell)]
    compare(tm(*args, nlist=nl), want, OUTS, rel=1e-10)
    t32 = tm.float()
    nl32 = None if nl is None else tuple(
        t.float() if t.is_floating_point() else t for t in nl)
    out32 = t32(args[0], args[1].float(), args[2].float(), nlist=nl32)
    assert out32['bec'].dtype == torch.float32
    compare(out32, want, OUTS, atol=2e-4)


@functools.lru_cache(maxsize=None)
def jax_charges_and_bec():
    '''The JAX package's ['charge', 'bec'] model (weights of models'
    seed 1) on frames(5): its charges are those of the ['charge'] model,
    which has the same weights.'''
    _, jm, params = models('dense', outputs=['charge', 'bec'], seed=1)
    return jax_apply(jm, params, *frames(5, 'dense'))


@pytest.mark.parametrize('outputs', [['charge'], ['charge', 'bec']])
def test_models_without_an_energy_head(outputs):
    '''A model of charges alone (and with BEC) builds no energy head, as
    the JAX core builds none; its total energy is 0 and it matches JAX.'''
    tm, jm, params = models('dense', outputs=outputs, seed=1)
    assert set(params['params']) == set(jax.eval_shape(
        jm.core.init, jax.random.PRNGKey(0), jnp.ones((1, 3), jnp.int32),
        jnp.zeros((1, 3, 3)), jnp.zeros((1, 3, 3)))['params'])
    assert not hasattr(tm.core, 'energy_head') and tm.core.heads == (
        'charge',)
    z, pos, cell = frames(5, 'dense')
    out = tm(*(torch.from_numpy(a) for a in (z, pos, cell)))
    assert 'energy' not in out
    compare(out, jax_charges_and_bec(), outputs, rel=1e-10)
    total, _ = tm._energy_and_aux(torch.from_numpy(z),
                                  torch.from_numpy(pos), None,
                                  torch.from_numpy(cell))
    assert float(total) == 0.0


def test_with_ewald_mode_as_in_jax():
    '''with_ewald_mode clones onto a static branch sharing the same core;
    it returns the model itself without a charge head or with a static
    mode; an unknown mode raises ValueError. ewald_dispatches_at_runtime
    as in JAX.'''
    tm, jm, _ = models('dense', outputs=['energy', 'charge'])
    for mode in ('periodic', 'aperiodic'):
        clone, jclone = tm.with_ewald_mode(mode), jm.with_ewald_mode(mode)
        assert clone is not tm and clone.core is tm.core
        assert clone.ewald_mode == jclone.ewald_mode == mode
        assert clone.config_dict() == jclone.config_dict()
        assert not clone.ewald_dispatches_at_runtime
        assert clone.with_ewald_mode('aperiodic') is clone
        assert tm.ewald_mode == 'auto'
    plain, jplain, _ = models('dense', outputs=['energy', 'gradient_force'])
    assert not plain.ewald_dispatches_at_runtime
    assert not jplain.ewald_dispatches_at_runtime
    assert plain.with_ewald_mode('periodic') is plain
    for m in (tm, jm):
        with pytest.raises(ValueError, match="'periodic' or 'aperiodic'"):
            m.with_ewald_mode('auto')
    z, pos, cell = frames(2, 'dense')
    args = [torch.from_numpy(a) for a in (z, pos, cell)]
    both = tm(*args)['energy']
    assert float(tm.with_ewald_mode('periodic')(*args)['energy'][0]) == \
        float(both[0])
    assert float(tm.with_ewald_mode('aperiodic')(*args)['energy'][1]) == \
        float(both[1])


@pytest.mark.parametrize('kw, text', [
    (dict(kernel='pallas', output_properties=['energy', 'charge']),
     'kernel=pallas supports'),
    (dict(kernel='pallas', output_properties=['energy', 'bec']),
     'kernel=pallas supports'),
    (dict(graph_mode='neighborlist', newton3_compact=True,
          output_properties=['energy', 'bec']),
     'newton3_compact does not support'),
])
def test_refusals_as_in_jax(kw, text):
    for cls, extra in ((NewtonNet, {'device': 'cpu'}), (JaxNewtonNet, {})):
        with pytest.raises(ValueError, match=text):
            cls(n_features=8, n_basis=4, n_interactions=1, **kw, **extra)


@pytest.mark.parametrize('outputs', [['energy', 'gradient_force', 'charge'],
                                     ['charge', 'bec']])
def test_checkpoints_load_across_packages(tmp_path, outputs):
    '''A port checkpoint loads in the JAX package and one the JAX package
    writes loads in the port, with or without an energy head: the same
    names and the same values.'''
    tm, jm, params = models('dense', outputs=outputs, seed=2)
    save_model(tmp_path / 'port.msgpack', tm)
    jm2, jparams = jckpt.load_model(tmp_path / 'port.msgpack')
    assert jm2.config_dict() == tm.config_dict()
    flat = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert set(flat) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(flat[k]), want[k])
    born = jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.5, params)
    jckpt.save_model(tmp_path / 'jax.msgpack', jm, born)
    back = load_model(tmp_path / 'jax.msgpack', device='cpu')
    assert back.core.heads == tuple(k for k in ('energy', 'charge')
                                    if k in jm._needs)
    got = dict(jax.tree_util.tree_flatten_with_path(
        params_to_flax(back.core))[0])
    for k, v in jax.tree_util.tree_flatten_with_path(born)[0]:
        np.testing.assert_array_equal(got[k], np.asarray(v))


def test_calculator_charges_bec_and_per_request_mode():
    '''The calculator's energy, forces, charges (n,) and (periodic)
    stress against the JAX calculator on one molecule and one box, float64
    at 1e-10, and its bec (n, 3, 3) against the model's (whose BEC
    test_model_matches_jax holds to JAX's): an 'auto' model is served by
    its aperiodic and periodic clones (the same core), chosen by the
    cell. A checkpoint without a charge head refuses charges and bec.'''
    tm, jm, params = models('dense', outputs=['energy', 'gradient_force',
                                              'charge'], seed=4)
    props = ['energy', 'forces', 'charges', 'bec']
    calc = NewtonNetCalculator(model=tm, params=params, properties=props
                               + ['stress'], precision='float64',
                               device='cpu')
    jcalc = JaxCalc(model=jm, params=params, properties=props[:3]
                    + ['stress'], precision='float64')
    assert NewtonNetCalculator(model=tm, params=params, device='cpu') \
        .properties == JaxCalc(model=jm, params=params).properties \
        == ['energy', 'forces', 'charges']
    z, pos, cell = frames(6, 'dense', B=1, N=11)
    for c in (cell[0], None):
        served = calc.model_for(c)
        assert served.core is calc.model.core
        assert served.ewald_mode == ('periodic' if c is not None
                                     else 'aperiodic')
        got = calc.calculate(numbers=z[0], positions=pos[0], cell=c)
        want = jcalc.calculate(numbers=z[0], positions=pos[0], cell=c)
        assert got['bec'].shape == (11, 3, 3) and got['charges'].shape == \
            (11,)
        own = models('dense', outputs=['charge', 'bec'], seed=4)[0]
        own.load_state_dict(tm.state_dict(), strict=False)
        np.testing.assert_allclose(got['bec'], own.with_ewald_mode(
            served.ewald_mode)(*(torch.from_numpy(a[:1]) for a in (
                z, pos, cell if c is not None else 0 * cell)))['bec'][0]
            .numpy(), rtol=0, atol=1e-12)
        for key in want:
            g, w = np.asarray(got[key]), np.asarray(want[key])
            ok = np.isfinite(w)
            assert (np.isfinite(g) == ok).all(), key
            if ok.any():  # an aperiodic stress is not finite (C1)
                assert np.abs(g[ok] - w[ok]).max() <= \
                    1e-10 * np.abs(w[ok]).max(), key
    plain, jplain, pp = models('dense', outputs=['energy', 'gradient_force'])
    with pytest.raises(ValueError, match='no trained head'):
        JaxCalc(model=jplain, params=pp, properties=['charges'])
    for prop in ('charges', 'bec'):
        with pytest.raises(ValueError, match=r"no trained head.*'charge'"):
            NewtonNetCalculator(model=plain, params=pp, properties=[prop],
                                device='cpu')


def test_pinned_aspirin_numbers_reproduce_on_the_cpu():
    '''chip_smoke.py phase 13a's model (the trained kernel='xla' aspirin
    checkpoint with charge_head_tree's head) in the port on the CPU: the
    first 8 test frames' energies, forces, charges and BEC against
    CHARGE_REF, which the JAX package's recipe wrote, at 13a's bars.'''
    cs = chip_smoke()
    model, batch = aspirin_model_and_batch(cs, 'cpu')
    out = model(*(torch.from_numpy(batch[k]) for k in ('z', 'pos', 'cell')))
    ref = dict(np.load(cs.CHARGE_REF))
    cs.check_charge_aspirin(np, {k: v.numpy() for k, v in out.items()}, ref)


def aspirin_model_and_batch(cs, device):
    from newtonnet_tpu_torch.data.loader import collate, parse_xyz
    base = load_model(cs.XLA_CKPT, device=device)
    model = cs.with_charge_head(torch, base, cs.CHARGE_OUTPUTS, device=device)
    samples = parse_xyz(cs.XYZ)[:cs.CHARGE_FRAMES]
    return model, collate(samples, n_pad=21)


def jax_model(tm, **changes):
    '''The JAX twin of a port model (its config with `changes`) and the
    port model's weights as a flax tree.'''
    return JaxNewtonNet(**dict(tm.config_dict(), **changes)), \
        params_to_flax(tm.core)


def card_numbers():
    '''The JAX package's numbers of chip_smoke.py phase 13, written to
    CHARGE_REF: 13a the aspirin model on the first CHARGE_FRAMES test
    frames (the JAX model in 'auto', as the checkpoint is); 13b the
    BOX_REF_ATOMS box through the JAX calculator (newton3, its own lists,
    no BEC: its per-graph Jacobian of 512 atoms does not fit); 13c the
    LJ model's BEC and charges on lj_box's first LJ_CHARGE_FRAMES frames
    over their half lists, and its 10 standard fine-tuning steps.'''
    from newtonnet_tpu.md.driver import host_symmetric_nlist as jax_lists
    cs = chip_smoke()
    ref = {}
    model, batch = aspirin_model_and_batch(cs, 'cpu')
    jm, params = jax_model(model)
    out = jax_apply(jm, params, batch['z'], batch['pos'], batch['cell'],
                    dtype=np.float32)
    for key, name in cs.CHARGE_ASPIRIN_KEYS.items():
        ref[f'JAX_CHARGE_ASPIRIN_{name}'] = out[key]
    box = cs.charged_box_model(torch, load_model(cs.XLA_CKPT,
                                                 device='cpu').config_dict(),
                               device='cpu')
    jm, params = jax_model(box, output_properties=[
        'energy', 'gradient_force', 'stress', 'charge'])
    z, pos, cell, _, _ = cs.box_system(cs.BOX_REF_ATOMS)
    r = JaxCalc(model=jm, params=params, properties=[
        'energy', 'forces', 'stress', 'charges']).calculate(
        numbers=z[0], positions=pos[0], cell=cell[0])
    for key, name in cs.CHARGE_BOX_KEYS.items():
        ref[f'JAX_CHARGE_BOX_{name}'] = np.asarray(r[key])
    lj = cs.charged_lj_model(torch, device='cpu', bec=True)
    jm, params = jax_model(lj)
    z, pos, cell, _, _ = cs.lj_box(n_frames=cs.LJ_CHARGE_FRAMES)
    nl = jax_lists(jm, z, pos.astype(np.float32), cell.astype(np.float32),
                   skin=0.0)
    out = jax.jit(lambda p, a, b, c, n: jm.apply(p, a, b, c, nlist=n))(
        params, jnp.asarray(z), jnp.asarray(pos, jnp.float32),
        jnp.asarray(cell, jnp.float32), nl)
    ref['JAX_LJ_CHARGE_BEC'] = np.asarray(out['bec'])
    ref['JAX_LJ_CHARGE_CHARGE'] = np.asarray(out['charge'])
    np.savez(cs.CHARGE_REF, **{k: np.asarray(v, np.float32)
                               for k, v in ref.items()})
    for k, v in ref.items():
        print(k, np.shape(v), 'max |.|', float(np.abs(v).max()), flush=True)
    losses, norms = jax_lj_charge_steps(cs)
    print('JAX_LJ_CHARGE_STEP_LOSS =', [float(f'{v:.7g}') for v in losses])
    print('JAX_LJ_CHARGE_STEP_GRAD_NORM =',
          [float(f'{v:.5g}') for v in norms], flush=True)


def jax_lj_charge_steps(cs, n_steps=10):
    '''The JAX package's first standard steps of phase 13c: the charged LJ
    checkpoint (written by the port, read by the JAX package) with
    LJ_CONFIG's loss, Adam and clip, scalers refit, on write_lj_dataset's
    frames over precompute_nlist mode newton3, the model resolved from the
    first batch as the JAX Trainer resolves it ('periodic'; its peek at
    the loader draws one shuffle, so the steps train on the loader's
    second permutation, as a Trainer given the loader does); each step
    jax.value_and_grad of the loss over model.apply, as
    tests/test_torch_xla_reference.py's jax_lj_steps takes them. ->
    (losses, global gradient norms before the clip).'''
    import tempfile

    import optax

    from newtonnet_tpu.data import parse_train_test
    from newtonnet_tpu.data.statistics import set_scalers
    from newtonnet_tpu.ops.nlist import build_inverse_list
    from newtonnet_tpu.train.loss import get_loss_by_string as jloss
    from newtonnet_tpu.train.optimizer import get_optimizer_by_string
    with open(cs.LJ_CONFIG) as f:
        cfg = yaml.safe_load(f)
    with tempfile.TemporaryDirectory() as root:
        cs.write_lj_dataset(root)
        ckpt = cs.write_charged_lj_checkpoint(torch, root)
        train_gen, _, _, stats = parse_train_test(
            seed=0, **cs.lj_data_settings(root))
        model, params = jckpt.load_model(ckpt)
        mode = JaxTrainer._peek_periodicity(train_gen)
        assert model.ewald_dispatches_at_runtime and mode == 'periodic'
        model = model.with_ewald_mode(mode)
        params = set_scalers(params, model.output_properties, stats,
                             {'energy': dict(cfg['training']['fit_scalers'])})
        main_loss, _ = jloss(cfg['training']['loss'])
        tx = get_optimizer_by_string(
            'adam', clip_grad=cfg['training']['clip_grad'],
            lr=cfg['training']['optimizer']['adam']['lr'])
        opt = tx.init(params)

        @jax.jit
        def step(p, o, b):
            inv = build_inverse_list(jnp.swapaxes(b['nlist_idx'], 1, 2),
                                     jnp.swapaxes(b['nlist_mask'], 1, 2))
            nl = (b['nlist_idx'], b['nlist_mask']) + tuple(inv)

            def loss_fn(q):
                return main_loss(model.apply(q, b['z'], b['pos'], b['cell'],
                                             nlist=nl), b)
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


if __name__ == '__main__':
    jax.config.update('jax_platforms', 'cpu')
    warnings.simplefilter('ignore')
    if sys.argv[1:] == ['card']:
        card_numbers()
    else:
        sys.exit('usage: test_torch_charge_model.py card')
