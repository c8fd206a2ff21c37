'''Training a kernel='pallas' model with pallas_dot_dtype bfloat16 (the
bf16 modes of K1/K2 and K5-K8; the dense duals K3/K4 in
pallas_grad_dot_dtype, bf16 by default) on the CPU, against the JAX
package, whose Pallas kernels run in interpret mode.

    python tests/test_torch_bf16_training.py aspirin   # JAX_BF16_ASPIRIN_STEP_*
    python tests/test_torch_bf16_training.py lj        # JAX_BF16_LJ_STEP_*
    python tests/test_torch_bf16_training.py lj-klist  # JAX_BF16_LJ_KLIST_VS_*

Cases (F=32, R=8, 2 interactions, batches of 4 molecules of at most 8
atoms): dense and over plain neighbour lists (k_max 12), three steps of
both Trainers (SGD with momentum and the global-norm clip) from one set of
parameters over the same batches, and step 1's gradient of fastgrad on
both sides.

Bars. Both packages round the same operands to bf16 and sum in fp32 in
another order; a one-ulp fp32 difference can flip a later rounding, so
bf16 mode is held to the JAX package's own bf16-to-fp32 shift: step 1's
gradient (relative norm) within BF16_GRAD_SHIFT_BAR = 0.5 of that shift,
each step's metrics and parameters within 0.5 of it on top of the fp32
bars of tests/test_torch_xla_training.py (rtol 2e-5, atol 2e-6). The
control: the port's fp32-product step is one whole shift away and fails
the gradient bar. The C12 cases hold the force pass (and the K-list dual)
to the model's pallas_dot_dtype.

As a script it prints the JAX package's bf16 fine-tuning steps that
chip_smoke.py phase 11 embeds (the card's machine has no flax): `aspirin`
the first 10 steps of scripts/config_md17_pallas.yml from
artifacts/md17_model_pallas with pallas_dot_dtype bfloat16, dense and with
graph_mode neighborlist (k_max 48), each beside the same recipe in float32
(the shift); `lj` the LJ checkpoint as a kernel='pallas' bf16 model
(chip_smoke.LJ_PALLAS) fine-tuned by LJ_CONFIG, dense and over plain
precomputed lists with fp32 and bf16 edges, the same way.
'''
import functools
import importlib.util
import os
import sys
import tempfile
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == '__main__':  # the recipe, run as a script
    sys.path.insert(0, ROOT)

from newtonnet_tpu.data.loader import PaddedLoader as JaxPaddedLoader
from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
from newtonnet_tpu.train import fastgrad as jax_fastgrad
from newtonnet_tpu.train import optimizer as jopt
from newtonnet_tpu.train.loss import get_loss_by_string as jax_loss
from newtonnet_tpu_torch import NewtonNet, Trainer
from newtonnet_tpu_torch.data.loader import PaddedLoader, Sample
from newtonnet_tpu_torch.ops import fused_dense as fd
from newtonnet_tpu_torch.ops import fused_klist as fk
from newtonnet_tpu_torch.train import fastgrad
from newtonnet_tpu_torch.train import optimizer as topt
from newtonnet_tpu_torch.train.loss import get_loss_by_string
from newtonnet_tpu_torch.utils.params import params_from_flax

EF = {'energy': {'weight': 1.0, 'mode': 'mse'},
      'gradient_force': {'weight': 50.0, 'mode': 'mse'}}
CFG = dict(cutoff=5.0, n_features=32, n_basis=8, n_interactions=2,
           output_properties=['energy', 'gradient_force'], kernel='pallas',
           pallas_dot_dtype='bfloat16')
LAYOUTS = {'dense': {}, 'nlist': dict(graph_mode='neighborlist', k_max=12)}
STEPS = 3
BF16_GRAD_SHIFT_BAR = 0.5


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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


def _params(cfg):
    jm = JaxNewtonNet(**cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32),
                     jnp.asarray(np.random.RandomState(0).randn(1, 4, 3),
                                 jnp.float32), jnp.zeros((1, 3, 3)))
    return jm, jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def _port(cfg, params, **changes):
    tm = NewtonNet(**dict(cfg, **changes), device='cpu')
    params_from_flax(params, core=tm.core)
    return tm.requires_grad_(True)


def _batch(data):
    return next(iter(PaddedLoader(data, 4, shuffle=False, n_pad=8)))


def _vec(named):
    '''{parameter name: array} as one float64 vector in name order.'''
    return np.concatenate([np.asarray(named[k], np.float64).ravel()
                           for k in sorted(named)])


def _jax_vec(tree):
    '''A JAX parameter pytree (or its gradient) as _vec of the port's
    parameter names.'''
    leaves = jax.tree_util.tree_flatten_with_path(tree['params'])[0]
    return _vec({'.'.join(k.key for k in path): v for path, v in leaves})


def _port_vec(tm, grad=False):
    return _vec({n: (p.grad if grad else p).detach().numpy()
                 for n, p in tm.core.named_parameters()})


def _port_grad(tm, batch):
    '''The port's step-1 gradient (fastgrad).'''
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    fastgrad.value_and_grad(tm, get_loss_by_string(EF)[0], tb)
    return _port_vec(tm, grad=True)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _optimizer(jax_side, core=None):
    if jax_side:
        return jopt.get_optimizer_by_string('sgd', clip_grad=1.0, lr=1e-2,
                                            momentum=0.9)
    return topt.get_optimizer_by_string('sgd', core, clip_grad=1.0,
                                        lr=1e-2, momentum=0.9)


@functools.lru_cache(maxsize=None)
def _jax_run(layout):
    '''The JAX package's training steps on the layout's bf16 model and on
    its fp32-product twin, from one set of parameters over the batches of
    one shuffled epoch, as its Trainer takes them (jit of
    fastgrad.value_and_grad, then the optimizer's update). -> ({dot dtype:
    (step 1's gradient, [(loss, parameters) after each step])}, the
    parameters, the batches); vectors in _vec's order.'''
    import optax
    cfg = dict(CFG, **LAYOUTS[layout])
    batches = list(JaxPaddedLoader(_samples(), 4, shuffle=True, n_pad=8))
    _, params0 = _params(cfg)
    runs = {}
    for dot in ('bfloat16', 'float32'):
        jm = JaxNewtonNet(**dict(cfg, pallas_dot_dtype=dot))
        value_and_grad = jax.jit(lambda p, b, jm=jm: jax_fastgrad
                                 .value_and_grad(jm, jax_loss(EF)[0], p,
                                                 b)[:2])
        tx = _optimizer(True)
        params, opt, steps, g1 = params0, None, [], None
        opt = tx.init(params)
        for b in batches:
            loss, grads = value_and_grad(
                params, {k: jnp.asarray(v) for k, v in b.items()})
            if g1 is None:
                g1 = _jax_vec(grads)
            updates, opt = tx.update(grads, opt, params)
            params = optax.apply_updates(params, updates)
            steps.append((float(loss), _jax_vec(params)))
        runs[dot] = (g1, steps)
    return runs, params0, batches


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_bf16_step1_gradient_against_jax(layout):
    '''Step 1's gradient of a bf16 pallas model (dense: K1/K2 bf16 force
    pass, K3/K4 bf16 duals; K-lists: K5/K6 and K7/K8 bf16) against the JAX
    package's, within BF16_GRAD_SHIFT_BAR of the JAX package's own
    bf16-to-fp32 shift; the port's fp32-product gradient, the control, is
    about one shift away and fails that bar.'''
    cfg = dict(CFG, **LAYOUTS[layout])
    runs, params, batches = _jax_run(layout)
    g_jax = runs['bfloat16'][0]
    shift = _rel(runs['float32'][0], g_jax)
    got = _rel(_port_grad(_port(cfg, params), batches[0]), g_jax)
    control = _rel(_port_grad(_port(cfg, params, pallas_dot_dtype='float32'),
                              batches[0]), g_jax)
    # bf16 moves it past the fp32 rounding of the two packages (about
    # 3e-6 between their fp32-product gradients here)
    assert shift > 1e-5, shift
    assert got <= BF16_GRAD_SHIFT_BAR * shift, (got, shift)
    assert control > BF16_GRAD_SHIFT_BAR * shift, (control, shift)


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_bf16_trainer_steps_match_jax(layout):
    '''Three steps of the port's Trainer on a bf16 pallas model against the
    JAX package's (_jax_run), loss and parameters after each step, within
    the fp32 bars plus BF16_GRAD_SHIFT_BAR of the JAX package's own shift
    of that value (its fp32-product steps on the same batches).'''
    cfg = dict(CFG, **LAYOUTS[layout])
    runs, params, batches = _jax_run(layout)
    tm = _port(cfg, params)
    tt = Trainer(tm, loss_fns=get_loss_by_string(EF),
                 optimizer=_optimizer(False, tm.core),
                 train_generator=PaddedLoader(_samples(), 4, shuffle=True,
                                              n_pad=8))
    assert tt.fast_grad
    k = -1
    for k, (bt, bj, (l_j, p_j), (l_32, p_32)) in enumerate(zip(
            tt.train_generator, batches, runs['bfloat16'][1],
            runs['float32'][1])):
        for key in bj:
            np.testing.assert_array_equal(bt[key], bj[key])
        loss = tt.train_step(bt)['loss']
        tol = 2e-5 * abs(l_j) + BF16_GRAD_SHIFT_BAR * abs(l_j - l_32)
        assert abs(loss - l_j) <= tol, (k, loss, l_j, l_32)
        tol = 2e-6 + BF16_GRAD_SHIFT_BAR * np.abs(p_j - p_32).max()
        assert np.abs(_port_vec(tm) - p_j).max() <= tol, k
    assert k == STEPS - 1


def _dot_dtypes_seen(target, name):
    '''A spy on ops function `name` of module `target`: the dot dtypes it
    was called with.'''
    seen = []
    fn = getattr(target, name)

    def spy(*a, **kw):
        seen.append(kw.get('dot_dtype', 'float32'))
        return fn(*a, **kw)
    return seen, mock.patch.object(target, name, spy)


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_c12_the_force_pass_and_the_klist_dual_take_the_models_dot_dtype(
        layout):
    '''C12: fastgrad's force pass of a bf16 pallas model runs its pair
    layer in bf16 (dense: K1's plain version; K-lists: K5's), as
    NewtonNet.forward does, so its forces equal forward's bit for bit;
    the K-list dual runs K7/K8 in bf16 too.'''
    cfg = dict(CFG, **LAYOUTS[layout])
    _, params = _params(cfg)
    tm = _port(cfg, params)
    batch = _batch(_samples())
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    if layout == 'dense':
        seen, patch = _dot_dtypes_seen(fd, 'pair_interaction_fwd_ref')
        dual_seen, dual_patch = [], mock.patch.object(fk, 'LAUNCHES',
                                                      fk.LAUNCHES)
    else:
        seen, patch = _dot_dtypes_seen(fk, 'klist_fwd_ref')
        dual_seen, dual_patch = _dot_dtypes_seen(fk, 'klist_dual_fwd_ref')
    with patch, dual_patch:
        _, preds = fastgrad.value_and_grad(tm, get_loss_by_string(EF)[0],
                                           tb)
    assert seen and set(seen) == {'bfloat16'}, seen
    if layout == 'nlist':
        assert dual_seen and set(dual_seen) == {'bfloat16'}, dual_seen
    out = tm(tb['z'], tb['pos'], tb['cell'])
    assert torch.equal(preds['gradient_force'], out['gradient_force'])
    assert torch.equal(preds['energy'], out['energy'].detach())


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_c13_an_energy_loss_trains_by_fastgrad(layout):
    '''C13: fastgrad over a loss that reads the energy alone (the Trainer's
    default loss) takes zeros for the forces' cotangent, as jax.grad does:
    its gradient equals, bit for bit, that of the energy + force loss with
    the force weight 0 (it raised before: the forces were unused).'''
    cfg = dict(CFG, **LAYOUTS[layout])
    _, params = _params(cfg)
    tb = {k: torch.as_tensor(v) for k, v in _batch(_samples()).items()}
    grads = []
    for losses in ({'energy': {'weight': 1.0, 'mode': 'mse'}},
                   dict(EF, gradient_force={'weight': 0.0, 'mode': 'mse'})):
        tm = _port(cfg, params)
        fastgrad.value_and_grad(tm, get_loss_by_string(losses)[0], tb)
        grads.append([p.grad for p in tm.core.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_a_bf16_pallas_model_trains_through_the_cli_and_reloads(tmp_path):
    '''The CLI trains a kernel='pallas', pallas_dot_dtype bfloat16 model
    over neighbour lists (it refused it before K7/K8 had a bf16 mode): one
    epoch of scripts/config_md17_pallas.yml cut to tiny sizes; the best
    model keeps its dot dtype and serves again through load_model.'''
    import yaml

    from newtonnet_tpu_torch import load_model
    from newtonnet_tpu_torch.train.cli import train_from_settings
    with open(os.path.join(ROOT, 'scripts', 'config_md17_pallas.yml')) as f:
        cfg = yaml.safe_load(f)
    data = os.path.join(ROOT, 'data', 'md17_aspirin')
    cfg['general'].update(device='cpu', output=str(tmp_path))
    cfg['data'].update(train_root=os.path.join(data, 'ccsd_train'),
                       test_root=None, train_size=8, val_size=4,
                       test_size=4, train_batch_size=4, val_batch_size=4,
                       test_batch_size=4)
    cfg['model'].update(n_features=16, n_basis=6, n_interactions=2,
                        graph_mode='neighborlist', k_max=12,
                        pallas_dot_dtype='bfloat16')
    cfg['model'].pop('pretrained_model', None)
    cfg['training']['epochs'] = 1
    trainer = train_from_settings(cfg)
    best = load_model(os.path.join(trainer.model_path, 'best_model.msgpack'),
                      device='cpu')
    assert best.kernel == 'pallas' and best.pallas_dot_dtype == 'bfloat16'
    assert best.graph_mode == 'neighborlist'
    again = trainer.run_one_epoch(trainer.test_generator, model=best)
    assert all(np.isfinite(v) for v in again.values())


# ------------------------------------------- the JAX numbers of phase 11 --
def jax_aspirin_steps(cs, graph_mode, dot_dtype, n_steps=10):
    '''The JAX package's first fine-tuning steps of
    scripts/config_md17_pallas.yml from the trained checkpoint with
    pallas_dot_dtype dot_dtype (chip_smoke's phase 7a recipe; graph_mode
    neighborlist: phase 7d's, k_max 48): (losses, global gradient norms
    before the clip).'''
    import optax
    import yaml

    from newtonnet_tpu.data import parse_train_test
    from newtonnet_tpu.data.statistics import set_scalers
    from newtonnet_tpu.utils.checkpoint import load_model
    with open(cs.MD17_CONFIG) as f:
        cfg = yaml.safe_load(f)
    data = os.path.join(ROOT, 'data', 'md17_aspirin')
    train_gen, _, _, stats = parse_train_test(
        train_root=os.path.join(data, 'ccsd_train'),
        test_root=os.path.join(data, 'ccsd_test'), train_size=950,
        train_batch_size=10, val_batch_size=50, test_batch_size=500, seed=0)
    model, params = load_model(cs.CKPT)
    jm = JaxNewtonNet(param_dtype=model.param_dtype, **dict(
        model.config_dict(), graph_mode=graph_mode,
        pallas_dot_dtype=dot_dtype))
    params = set_scalers(params, jm.output_properties, stats,
                         {'energy': dict(cfg['training']['fit_scalers'])})
    main_loss, _ = jax_loss(cfg['training']['loss'])
    tx = jopt.get_optimizer_by_string('adam', clip_grad=1.0, lr=1e-3)
    opt = tx.init(params)

    @jax.jit
    def step(p, o, b):
        loss, grads, _ = jax_fastgrad.value_and_grad(jm, main_loss, p, b)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss, \
            optax.global_norm(grads)

    losses, norms = [], []
    for _, batch in zip(range(n_steps), train_gen):
        params, opt, loss, norm = step(
            params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append(float(loss))
        norms.append(float(norm))
    return losses, norms


def jax_lj_steps(cs, layout, dot_dtype, n_steps=10, grads1=None):
    '''The JAX package's first fine-tuning steps of LJ_CONFIG with the LJ
    checkpoint as a pallas model in dot_dtype over `layout`
    (chip_smoke.BF16_LJ_LAYOUTS; the lists precomputed, plain, as
    lj_pallas_data_settings gives them): (losses, gradient norms). A list
    given as grads1 receives step 1's gradient leaves.'''
    import optax
    import yaml

    from newtonnet_tpu.data import parse_train_test
    from newtonnet_tpu.data.statistics import set_scalers
    from newtonnet_tpu.utils.checkpoint import load_model
    graph_mode, compute_dtype = cs.BF16_LJ_LAYOUTS[layout]
    with open(cs.LJ_CONFIG) as f:
        cfg = yaml.safe_load(f)
    with tempfile.TemporaryDirectory() as root:
        cs.write_lj_dataset(root)
        train_gen, _, _, stats = parse_train_test(
            seed=0, **cs.lj_pallas_data_settings(root, graph_mode))
        batches = [b for _, b in zip(range(n_steps), train_gen)]
    model, params = load_model(cs.LJ_CKPT)
    jm = JaxNewtonNet(param_dtype=model.param_dtype, **{
        **model.config_dict(), **cs.LJ_PALLAS, 'graph_mode': graph_mode,
        'compute_dtype': compute_dtype, 'pallas_dot_dtype': dot_dtype})
    params = set_scalers(params, jm.output_properties, stats,
                         {'energy': dict(cfg['training']['fit_scalers'])})
    main_loss, _ = jax_loss(cfg['training']['loss'])
    tx = jopt.get_optimizer_by_string(
        'adam', clip_grad=cfg['training']['clip_grad'],
        lr=cfg['training']['optimizer']['adam']['lr'])
    opt = tx.init(params)

    @jax.jit
    def step(p, o, b):
        nl = (b['nlist_idx'], b['nlist_mask']) if 'nlist_idx' in b else None
        loss, grads, _ = jax_fastgrad.value_and_grad(jm, main_loss, p, b,
                                                     nlist=nl)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss, \
            optax.global_norm(grads), grads

    losses, norms = [], []
    for batch in batches:
        params, opt, loss, norm, grads = step(
            params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
        if grads1 is not None and not losses:
            grads1 += [np.asarray(g, np.float64)
                       for g in jax.tree.leaves(grads)]
        losses.append(float(loss))
        norms.append(float(norm))
    return losses, norms


def _shift(bf, fp):
    return [abs(a - b) for a, b in zip(bf, fp)]


if __name__ == '__main__':
    jax.config.update('jax_platforms', 'cpu')
    cs = chip_smoke()
    if sys.argv[1:] == ['aspirin']:
        out = {}
        for gm in ('dense', 'neighborlist'):
            l16, n16 = jax_aspirin_steps(cs, gm, 'bfloat16')
            l32, n32 = jax_aspirin_steps(cs, gm, 'float32')
            out[gm] = (l16, n16, {'loss': _shift(l16, l32),
                                  'grad_norm': _shift(n16, n32)})
        for name, k in (('LOSS', 0), ('GRAD_NORM', 1), ('SHIFT', 2)):
            print(f'JAX_BF16_ASPIRIN_STEP_{name} = '
                  f'{ {gm: out[gm][k] for gm in out} !r}')
    elif sys.argv[1:] == ['lj']:
        out = {}
        for layout in cs.BF16_LJ_LAYOUTS:
            l16, n16 = jax_lj_steps(cs, layout, 'bfloat16')
            l32, n32 = jax_lj_steps(cs, layout, 'float32')
            out[layout] = (l16, n16, {'loss': _shift(l16, l32),
                                      'grad_norm': _shift(n16, n32)})
        for name, k in (('LOSS', 0), ('GRAD_NORM', 1), ('SHIFT', 2)):
            print(f'JAX_BF16_LJ_STEP_{name} = '
                  f'{ {lay: out[lay][k] for lay in out} !r}')
    elif sys.argv[1:] == ['lj-klist']:
        # C15: the JAX package's own bf16 K-list-to-dense distance of step
        # 1's gradient (relative norm), and the control's: the bf16 K-list
        # step against the fp32-product dense one
        runs = [(lay, 'bfloat16') for lay in cs.BF16_LJ_LAYOUTS]
        g = {run: [] for run in runs + [('dense', 'float32')]}
        for (layout, dot), leaves in g.items():
            jax_lj_steps(cs, layout, dot, n_steps=1, grads1=leaves)

        def rel(a, b):
            return float(np.sqrt(sum(((x - y) ** 2).sum()
                                     for x, y in zip(a, b))
                                 / sum((y ** 2).sum() for y in b)))
        klists = [lay for lay in cs.BF16_LJ_LAYOUTS if lay != 'dense']
        for name, dense in (('DENSE', 'bfloat16'), ('FP32_DENSE', 'float32')):
            out = {lay: rel(g[lay, 'bfloat16'], g['dense', dense])
                   for lay in klists}
            print(f'JAX_BF16_LJ_KLIST_VS_{name} = {out!r}')
    else:
        sys.exit('usage: python tests/test_torch_bf16_training.py '
                 'aspirin|lj|lj-klist')
