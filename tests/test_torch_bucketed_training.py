'''Training over bucketed batches, whose atom padding changes from step to
step (data.bucketed: BucketedLoader), against the JAX package on the CPU.

    python tests/test_torch_bucketed_training.py hetero   # JAX_LJ_HETERO_*

Cases, on a copy of data/lj_hetero (LJ clusters of 6-38 atoms, buckets of
8 to 40 atoms): a narrow kernel='xla' model (F=16, R=8, 2 interactions,
cutoff 7) taken through the first training steps of both Trainers from
one set of parameters over the same bucketed batches (SGD with momentum
and the global-norm clip), metrics at rtol 2e-5 and parameters at atol
2e-6 after each step (tests/test_torch_xla_training.py's bars) and step
1's gradient at atol 2e-4 (PR 2's gradient bar); the Trainer through a
PrefetchLoader, whose shuffling Generator is the loader's own, so a
resumed run draws the epochs the JAX Trainer's would; the training CLI
on artifacts/lj_hetero_model's config (bucketed), cut to tiny widths and
sizes, with in_memory 'sharded', locality_block 'auto' and prefetch 2.

As a script it prints the JAX numbers of chip_smoke.py phase 12a (the
card's machine has no flax): the first 10 training steps of
config_lj_hetero.yml as in the tree (F=64, 3 interactions, batch 20,
bucketed, an XLA model, the standard step), fine-tuning the checkpoint
that config trained (artifacts/lj_hetero_model/training_1/models/
best_model.msgpack) with the scalers refit as the CLI fits them: the
losses, the global gradient norms before the clip, and each batch's
n_pad (the bucket sequence).
'''
import copy
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == '__main__':  # the recipe, run as a script
    sys.path.insert(0, ROOT)

from newtonnet_tpu.data import parse_train_test as jax_parse_train_test
from newtonnet_tpu.models import NewtonNet as JaxNewtonNet
from newtonnet_tpu.train import optimizer as jopt
from newtonnet_tpu.train.loss import get_loss_by_string as jax_loss
from newtonnet_tpu.train.trainer import Trainer as JaxTrainer
from newtonnet_tpu_torch import NewtonNet, Trainer
from newtonnet_tpu_torch.data.loader import PrefetchLoader
from newtonnet_tpu_torch.data.pipeline import parse_train_test
from newtonnet_tpu_torch.train import cli
from newtonnet_tpu_torch.train import optimizer as topt
from newtonnet_tpu_torch.train.loss import get_loss_by_string
from newtonnet_tpu_torch.train.trainer import standard_value_and_grad
from newtonnet_tpu_torch.utils.params import params_from_flax

EF = {'energy': {'weight': 1.0, 'mode': 'mse'},
      'gradient_force': {'weight': 50.0, 'mode': 'mse'}}
CFG = dict(cutoff=7.0, n_features=16, n_basis=8, n_interactions=2,
           output_properties=['energy', 'gradient_force'])
STEPS = 4


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(ROOT, 'chip_smoke.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = chip_smoke()


@pytest.fixture(scope='module')
def roots(tmp_path_factory):
    '''Two copies of data/lj_hetero (chip_smoke.hetero_copy), one for
    each package's processed/ caches.'''
    return [CS.hetero_copy(str(tmp_path_factory.mktemp(pkg)))
            for pkg in ('jax', 'port')]


def _data(root, **changes):
    return dict(dict(train_root=os.path.join(root, 'train'),
                     train_size=40, val_size=10, test_size=0,
                     train_batch_size=8, val_batch_size=10,
                     test_batch_size=10, bucketed=True, seed=0), **changes)


def _params(cfg):
    jm = JaxNewtonNet(**cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 4), jnp.int32),
                     jnp.asarray(np.random.RandomState(0).randn(1, 4, 3),
                                 jnp.float32), jnp.zeros((1, 3, 3)))
    return jm, jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def _named(params):
    leaves = jax.tree_util.tree_flatten_with_path(
        jax.device_get(params)['params'])[0]
    return {'.'.join(k.key for k in path): np.asarray(v)
            for path, v in leaves}


def test_bucketed_trainer_steps_match_jax(roots):
    '''Both Trainers over the bucketed loaders of parse_train_test (the
    same batches, of several paddings): every metric and parameter after
    each step, and step 1's gradient.'''
    jax_gen = jax_parse_train_test(**_data(roots[0]))[0]
    port_gen = parse_train_test(**_data(roots[1]))[0]
    jm, params = _params(CFG)
    jt = JaxTrainer(jm, params, loss_fns=jax_loss(EF),
                    optimizer=jopt.get_optimizer_by_string(
                        'sgd', clip_grad=1.0, lr=1e-2, momentum=0.9),
                    train_generator=jax_gen, steps_per_call=1)
    tm = NewtonNet(**CFG, device='cpu')
    params_from_flax(params, core=tm.core)
    tt = Trainer(tm, loss_fns=get_loss_by_string(EF),
                 optimizer=topt.get_optimizer_by_string(
                     'sgd', tm.core, clip_grad=1.0, lr=1e-2, momentum=0.9),
                 train_generator=port_gen, steps_per_call=1)
    assert not tt.fast_grad and not jt.fast_grad
    names = ['loss'] + jt._eval_metric_names() + ['edges']
    n_pads = []
    for k, (bj, bt) in enumerate(zip(jt.train_generator,
                                     tt.train_generator)):
        if k == STEPS:
            break
        assert bj.keys() == bt.keys()
        for key in bj:
            np.testing.assert_array_equal(bt[key], bj[key], key)
        n_pads.append(bt['z'].shape[1])
        if k == 0:
            main_loss = jax_loss(EF)[0]
            b = {key: jnp.asarray(v) for key, v in bj.items()}
            grads = _named(jax.jit(jax.grad(lambda p: main_loss(jm.apply(
                p, b['z'], b['pos'], b['cell']), b)))(jt.params))
            standard_value_and_grad(tm, tt.main_loss, tt._to_device(bt))
            for n, p in tm.core.named_parameters():
                got = (p.grad if p.grad is not None
                       else torch.zeros_like(p)).numpy()
                np.testing.assert_allclose(got, grads[n], atol=2e-4,
                                           err_msg=n)
        totals = {n: jnp.zeros((), jnp.float32) for n in names}
        jt.params, jt.opt_state, totals = jt._train_step(
            jt.params, jt.opt_state, totals, bj)
        metrics = tt.train_step(bt)
        assert list(metrics) == names
        for n in names:
            np.testing.assert_allclose(float(metrics[n]), float(totals[n]),
                                       rtol=2e-5, err_msg=f'{n} step {k}')
        want = _named(jt.params)
        for n, p in tm.core.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n],
                                       atol=2e-6, err_msg=f'{n} step {k}')
    assert len(set(n_pads)) > 1, n_pads  # the padding changed


def test_prefetched_trainer_resumes_the_jax_epochs(roots, tmp_path):
    '''A Trainer over a PrefetchLoader of bucketed batches checkpoints the
    wrapped loader's Generator (loader_rng_state); a run resumed from that
    state draws the second epoch the JAX loader draws in its second
    epoch.'''
    jax_gen = jax_parse_train_test(**_data(roots[0]))[0]
    port_gen = parse_train_test(**_data(roots[1], prefetch=2))[0]
    assert isinstance(port_gen, PrefetchLoader)
    assert port_gen._rng is port_gen.loader._rng
    assert port_gen.buckets == jax_gen.buckets
    cfg = dict(CFG, n_features=8, n_interactions=1)
    tt = Trainer(NewtonNet(**cfg, device='cpu'),
                 loss_fns=get_loss_by_string(EF), train_generator=port_gen,
                 output_base_path=str(tmp_path), epochs=1)
    tt.train()
    resumed = parse_train_test(**_data(roots[1], prefetch=2))[0]
    again = Trainer(NewtonNet(**cfg, device='cpu'),
                    loss_fns=get_loss_by_string(EF),
                    train_generator=resumed)
    again.resume(tt.output_path)
    list(jax_gen)  # the JAX loader's first epoch
    for bj, bt in zip(jax_gen, resumed):
        for key in bj:
            np.testing.assert_array_equal(bt[key], bj[key], key)


def test_cli_trains_the_hetero_config_sharded_and_prefetched(roots,
                                                              tmp_path):
    '''artifacts/lj_hetero_model's config (bucketed) through the CLI on
    the CPU, cut to F=16, one interaction and 40 training frames, with
    in_memory 'sharded' (shards of 16 frames), locality_block 'auto' and
    prefetch 2: one epoch, its batches those of the in-memory run with the
    same locality block, the caches written into the data's copy.'''
    with open(CS.HETERO_CONFIG) as f:
        cfg = yaml.safe_load(f)
    assert cfg['data']['bucketed'] is True
    cfg['general'].update(device='cpu', output=str(tmp_path / 'runs'))
    cfg['data'].update(
        train_root=os.path.join(roots[1], 'train'),
        test_root=os.path.join(roots[1], 'test'), train_size=40,
        val_size=10, test_size=10, in_memory='sharded', shard_size=16,
        locality_block='auto', prefetch=2)
    cfg['model'].update(n_features=16, n_basis=8, n_interactions=1)
    cfg['training'].update(epochs=1)
    data = copy.deepcopy(cfg['data'])
    trainer = cli.train_from_settings(cfg)
    assert trainer.model.kernel == 'xla'
    assert os.path.exists(os.path.join(roots[1], 'train', 'processed',
                                       'meta.npz'))
    sharded = parse_train_test(**data)[0]
    data.pop('shard_size')
    in_memory = parse_train_test(**dict(data, in_memory=True,
                                        locality_block=16, prefetch=0))[0]
    n = 0
    for bs, bm in zip(sharded, in_memory):
        for key in bm:
            np.testing.assert_array_equal(bs[key], bm[key], key)
        n += 1
    assert n == len(in_memory) == len(trainer.train_generator)


# --------------------------------------------- the JAX numbers of phase 12a --
def jax_hetero_steps(root, n_steps=10):
    '''The JAX package's first training steps of config_lj_hetero.yml
    from its trained checkpoint, the scalers refit as the JAX CLI fits
    them, the standard step, Adam with the config's lr and clip: (losses,
    global gradient norms before the clip, n_pad of each batch).'''
    import optax

    from newtonnet_tpu.data.statistics import set_scalers
    from newtonnet_tpu.utils.checkpoint import load_model
    cfg = CS.hetero_settings(root)
    train_gen, _, _, stats = jax_parse_train_test(
        seed=cfg['general']['seed'], **cfg['data'])
    model, params = load_model(CS.HETERO_CKPT)
    jm = JaxNewtonNet(**model.config_dict())
    fit = cfg['training']['fit_scalers']
    params = set_scalers(params, jm.output_properties, stats,
                         {k: fit.get(k, {}) for k in jm.output_properties})
    main_loss, _ = jax_loss(cfg['training']['loss'])
    tx = jopt.get_optimizer_by_string(
        'adam', clip_grad=cfg['training']['clip_grad'],
        lr=cfg['training']['optimizer']['adam']['lr'])
    opt = tx.init(params)

    @jax.jit
    def step(p, o, b):
        def loss_fn(q):
            return main_loss(jm.apply(q, b['z'], b['pos'], b['cell']), b)
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss, \
            optax.global_norm(grads)

    losses, norms, n_pads = [], [], []
    for _, batch in zip(range(n_steps), train_gen):
        params, opt, loss, norm = step(
            params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append(float(loss))
        norms.append(float(norm))
        n_pads.append(int(batch['z'].shape[1]))
    return losses, norms, n_pads


if __name__ == '__main__':
    import tempfile
    jax.config.update('jax_platforms', 'cpu')
    if sys.argv[1:] != ['hetero']:
        sys.exit('usage: python tests/test_torch_bucketed_training.py hetero')
    with tempfile.TemporaryDirectory() as tmp:
        losses, norms, n_pads = jax_hetero_steps(CS.hetero_copy(tmp))
    print(f'JAX_LJ_HETERO_STEP_LOSS = {losses!r}')
    print(f'JAX_LJ_HETERO_STEP_GRAD_NORM = {norms!r}')
    print(f'JAX_LJ_HETERO_N_PAD = {n_pads!r}')
